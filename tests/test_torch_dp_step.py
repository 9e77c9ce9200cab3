"""The port's data-parallel train step on two gloo ranks on the CPU
against the JAX package's ``data:2`` mesh step (the virtual CPU devices of
tests/conftest.py, built as tests/test_collectives.py builds its mesh),
from the same weights and inputs (``tests/torch_dp_cases.py``):

- detection on a partial global batch (valid 1 of 4: rank 1 holds only
  padding), classification (valid 3 of 4), SSL pre-training (the RMSE's
  global numerator and denominator; valid 1 of 4), 3 steps each;
- the mesh cached step over a row-sharded resident split and over a
  striped rotating split (one epoch of each, its plans from one seed);
- the Dense-CNN's global BatchNorm (float64; its float32 gradients are
  not reproducible across implementations, tests/test_torch_baselines.py)
  on 2 rows, one of them padding, 3 steps.

The ranks start once for the module (a worker process each, started
before the JAX references are computed) and run every case. Criterion,
that of tests/test_torch_train.py: losses rtol 1e-4, atol 1e-5;
parameters (and running statistics) after every step atol 1e-5. Every
rank's state is bitwise equal to the other's after every step.
"""

import os
import socket
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from eeg_gnn_tpu.config import ExperimentConfig as JaxConfig
from eeg_gnn_tpu.data import device_cache as jdc
from eeg_gnn_tpu.data import rotating_cache as jrc
from eeg_gnn_tpu.data.device_pipeline import (
    make_device_pipeline as jax_pipeline,
)
from eeg_gnn_tpu.data.scaler import StandardScaler as JaxScaler
from eeg_gnn_tpu.graphs import compute_supports_jnp
from eeg_gnn_tpu.models import densecnn as jdensecnn
from eeg_gnn_tpu.models.registry import build_model as jax_build_model
from eeg_gnn_tpu.parallel.distributed import global_put
from eeg_gnn_tpu.parallel.mesh import make_mesh, replicated_sharding
from eeg_gnn_tpu.train.optim import make_optimizer as jax_make_optimizer
from eeg_gnn_tpu.train.step import (
    local_cache_gather,
    make_mesh_cached_train_step,
    make_train_step,
    shard_batch,
    ssl_loss_fn,
    supervised_loss_fn,
)
from eeg_gnn_tpu_torch.io import params_from_jax, params_to_jax, state_to_jax

import torch_dp_cases as cases

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_dp_cases.py")
WORLD = 2


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _Ranks:
    """The two rank processes of the module; ``result(rank)`` waits for
    both (once) and reads a rank's arrays."""

    def __init__(self, out_dir):
        self.out_dir = str(out_dir)
        cases.write_adjacency(os.path.join(self.out_dir, "adj.pkl"))
        port = str(_free_port())
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, str(r), str(WORLD), port, self.out_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(WORLD)]
        self.arrays = None

    def result(self, rank=0):
        if self.arrays is None:
            outs = [p.communicate(timeout=600)[0] for p in self.procs]
            for r, (p, out) in enumerate(zip(self.procs, outs)):
                assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
            self.arrays = [dict(np.load(os.path.join(
                self.out_dir, f"rank{r}.npz"))) for r in range(WORLD)]
        return self.arrays[rank]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    r = _Ranks(tmp_path_factory.mktemp("dp_step"))
    yield r
    for p in r.procs:
        if p.poll() is None:
            p.kill()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _state_dict(params, state=None):
    """A JAX (params, state) as the port's state_dict of numpy arrays."""
    return {k: v.numpy() for k, v in
            params_from_jax(_np(params), None if state is None
                            else _np(state)).items()}


def _jax_start(case, jmesh, f64=False):
    """(config, params, model state, optimizer, opt state) of a case,
    replicated over the mesh, from the port's initial model."""
    jcfg = JaxConfig(**cases.cfg_kw(case)).finalize()
    sd = cases.init_model(case)[1].state_dict()
    dt = np.float64 if f64 else np.float32
    params = jax.tree_util.tree_map(lambda a: a.astype(dt),
                                    params_to_jax(sd))
    state = jax.tree_util.tree_map(lambda a: a.astype(dt), state_to_jax(sd))
    opt = jax_make_optimizer(jcfg.lr_init, jcfg.l2_wd, jcfg.max_grad_norm,
                             jcfg.num_epochs, cases.STEPS_PER_EPOCH)
    rep = replicated_sharding(jmesh)
    params = jax.device_put(params, rep)
    return (jcfg, params, jax.device_put(state, rep), opt,
            jax.device_put(opt.init(params), rep))


def _jax_host_run(case):
    """The JAX ``data:2`` mesh step over the case's global batch: [(loss,
    state_dict)] after each step."""
    jmesh = make_mesh("data:2", jax.devices()[:2])
    f64 = case == "densecnn"
    apply = jdensecnn.densecnn_apply
    with mock.patch.object(jdensecnn, "densecnn_apply",
                           lambda *a, **k: apply(*a, **dict(
                               k, dropout_rate=0.0))), jax.enable_x64(f64):
        jcfg, params, state, opt, opt_state = _jax_start(case, jmesh, f64)
        b = cases.host_batch(case)
        jb = {"x": b["x"], "y": b["y"], "supports": None,
              "valid": np.int32(b["valid"])}
        if case == "ssl":
            loss_fn = ssl_loss_fn(jcfg.dcrnn_config(),
                                  jnp.float32(cases.MEAN),
                                  jnp.float32(cases.STD))
        else:
            loss_fn = supervised_loss_fn(jax_build_model(jcfg), jcfg.task)
            jb["seq_lengths"] = np.asarray(b["seq_lengths"], np.int32)
        if b.get("adjacency") is not None:
            jb["supports"] = np.asarray(compute_supports_jnp(
                jnp.asarray(b["adjacency"]), jcfg.filter_type))
        jb = shard_batch(jb, jmesh)
        ssl = case == "ssl"
        step = make_train_step(loss_fn, opt, has_batches_seen=ssl,
                               donate=False)
        out = []
        for i in range(cases.STEPS):
            extra = (jnp.int32(i * b["valid"]),) if ssl else ()
            params, state, opt_state, loss = step(
                params, state, opt_state, jb, jax.random.PRNGKey(1), *extra)
            out.append((float(loss), _state_dict(params, state or None)))
    return out


def _jax_cached_run(case, adj_path):
    """The JAX mesh cached step (row-sharded resident split, or the
    rotating split's row-sharded slabs) over one epoch; ``adj_path`` the
    combined graph's distance pickle."""
    jmesh = make_mesh("data:2", jax.devices()[:2])
    jcfg, params, state, opt, opt_state = _jax_start(case, jmesh)
    feats, labels = cases.cache_split()
    rng = np.random.RandomState(cases.PLAN_SEED)
    pipe = jax_pipeline(
        graph_type="combined", filter_type=jcfg.filter_type, top_k=3,
        use_fft=True, time_step_size=1,
        scaler=JaxScaler(cases.MEAN, cases.STD), augment=False,
        adj_mat_dir=adj_path)
    loss_fn = supervised_loss_fn(jax_build_model(jcfg), "detection",
                                 input_pipeline=pipe,
                                 cache_gather=local_cache_gather(jmesh))
    step = make_mesh_cached_train_step(loss_fn, opt, cases.T, cases.B,
                                       donate=False)
    if case == "cached":
        jc = jdc.DeviceDatasetCache(feats, labels, cases.T, mesh=jmesh)
        plans = [({"x": jc.x, "y": jc.y, "seq": jc.seq},
                  *jc.mesh_epoch_plan(cases.B, WORLD, True, rng))]
    else:
        jr = jrc.RotatingDeviceCache(feats, labels, cases.T,
                                     budget_bytes=cases.rotating_budget(),
                                     min_shards=2, mesh=jmesh)
        plans = []
        for sid in jr.epoch_shard_order(rng):
            slab = jr.prefetch(sid)
            plans.append((slab, *jr.mesh_shard_plan(sid, cases.B, True,
                                                    rng)))
    spec = NamedSharding(jmesh, P(None, "data"))
    key, seen, out = jax.random.PRNGKey(0), jnp.int32(0), []
    for cache_d, idx_mat, mask_mat in plans:
        idx_d = global_put(idx_mat, spec, axis=1)
        mask_d = global_put(mask_mat, spec, axis=1)
        k_steps = idx_mat.shape[0]
        counter, losses = jnp.int32(0), jnp.zeros((k_steps,), jnp.float32)
        for k in range(k_steps):
            (params, state, opt_state, key, counter, seen,
             losses) = step(params, state, opt_state, key, counter, seen,
                            losses, cache_d, idx_d, mask_d)
            out.append((float(losses[k]), _state_dict(params)))
    return out


def _close(got_rank, want, case):
    n = len(want)
    assert sum(k.startswith(f"{case}/") and k.endswith("/loss")
               for k in got_rank) == n
    np.testing.assert_allclose(
        [float(got_rank[f"{case}/{i}/loss"]) for i in range(n)],
        [w[0] for w in want], rtol=1e-4, atol=1e-5, err_msg=case)
    for i, (_, sd) in enumerate(want):
        for k, v in sd.items():
            if k.endswith("num_batches_tracked"):  # no JAX counterpart
                continue
            np.testing.assert_allclose(got_rank[f"{case}/{i}/{k}"], v,
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{case} step {i} {k}")


@pytest.mark.parametrize("case", ["detection", "classification", "ssl",
                                  "densecnn"])
def test_dp_step_matches_jax_mesh(ranks, case):
    """Two ranks against the JAX data:2 mesh step over 3 steps: the global
    losses and every parameter (the Dense-CNN's running statistics too)
    after each step."""
    _close(ranks.result(0), _jax_host_run(case), case)


@pytest.mark.parametrize("case", ["cached", "rotating"])
def test_dp_cached_steps_match_jax_mesh(ranks, case):
    """The mesh cached step on the row-sharded resident split and on the
    striped rotating slabs, an epoch of each (2 steps), against JAX's
    ``make_mesh_cached_train_step`` with ``local_cache_gather`` over the
    same seeded plans."""
    adj = os.path.join(ranks.out_dir, "adj.pkl")
    _close(ranks.result(0), _jax_cached_run(case, adj), case)


def test_ranks_hold_bitwise_equal_state_after_every_step(ranks):
    """Every case, every step: rank 1's losses and state equal rank 0's
    bit for bit (one gradient all-reduce, then the same update)."""
    a, b = ranks.result(0), ranks.result(1)
    assert a.keys() == b.keys()
    for k in a:
        if k != "counts":
            assert np.array_equal(a[k], b[k]), k


def test_each_step_launches_one_gradient_all_reduce(ranks):
    """The collectives the ranks counted: one gradient all-reduce a step
    (3 steps in each host case, 2 in each cached one), one starting
    broadcast a case and dtype (the Dense-CNN's floats and its int64
    batch counter), and the differentiable all-reduce only
    in SSL (forward and backward, a step) and the Dense-CNN's BatchNorm
    (the same)."""
    calls = ranks.result(0)["counts"][0::2]  # (calls, bytes) per counter
    steps = 4 * cases.STEPS + 2 * 2
    assert calls[0] == steps                   # all_reduce_grads
    assert calls[1] == 2 * 2 * cases.STEPS     # all_reduce_sum
    assert calls[2] == 0                       # all_gather_rows
    assert calls[3] == 5 + 2                   # broadcast_ (Dense-CNN: 2)
