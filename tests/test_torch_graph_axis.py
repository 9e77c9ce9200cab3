"""The port's graph axis on four gloo ranks on the CPU against the JAX
package's ``graph:4`` mesh (the virtual CPU devices of tests/conftest.py),
from the same inputs and weights (``tests/torch_graph_cases.py``):

- the ring SpMM at tests/test_sparse_distributed.py's four shapes (250
  nodes and 777 edges keep the node and edge padding paths at p=4), and
  its dx and dvalues against ``jax.grad`` through JAX's ring, at 1e-4;
- the sparse encoder (2 layers, K=2) against JAX ``sparse_encoder_apply``
  and against the port's dense encoder, at rtol 2e-4 / atol 2e-5;
- 3 sparse train steps against JAX ``make_sparse_train_step`` with the
  optimizer carried (losses rtol 1e-4, atol 1e-5; parameters atol 1e-5,
  tests/test_torch_train.py's criterion), and the first step's gradients
  against the dense path's (rtol 2e-3, atol 1e-5: JAX's test);
- a ``data:2,graph:2`` mesh's coordinates and groups against the JAX
  mesh's device layout, and the data-parallel detection step through it
  bit for bit equal to the plain ``data:2`` mesh's (held against JAX in
  tests/test_torch_dp_step.py);
- ``dryrun_multichip(4)``.

The ranks start once for the module (a worker process each, started
before the JAX references are computed) and run every case.
"""

import dataclasses
import functools
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_gnn_tpu.graphs.sparse import SparseGraph as JaxSparseGraph
from eeg_gnn_tpu.graphs.sparse import from_dense_batch as jax_from_dense
from eeg_gnn_tpu.models.dcgru import encoder_configs as jax_encoder_configs
from eeg_gnn_tpu.parallel.edge_partition import (
    edge_partitioned_spmm as jax_ring,
    partition_by_dest as jax_partition,
    place_edge_partitioned as jax_place,
)
from eeg_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from eeg_gnn_tpu.parallel.sparse_model import (
    make_sparse_train_step as jax_sparse_step,
    sparse_encoder_apply as jax_sparse_encoder,
)
from eeg_gnn_tpu.train.optim import make_optimizer as jax_make_optimizer
from eeg_gnn_tpu_torch.io import params_from_jax, params_to_jax
from eeg_gnn_tpu_torch.models.dcgru import encoder_apply
from eeg_gnn_tpu_torch.train.losses import bce_with_logits

import torch_graph_cases as cases

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_graph_cases.py")
WORLD = 4


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Ranks:
    """The four rank processes of the module; ``result(rank)`` waits for
    all (once) and reads a rank's arrays."""

    def __init__(self, out_dir):
        self.out_dir = str(out_dir)
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
    r = _Ranks(tmp_path_factory.mktemp("graph_axis"))
    yield r
    for p in r.procs:
        if p.poll() is None:
            p.kill()


def _jmesh(spec="graph:4"):
    return jax_make_mesh(spec, jax.devices()[:WORLD])


@functools.lru_cache(maxsize=None)
def _jax_ring(i):
    """JAX's ring at shape ``i``: (out (n, D), dvalues (p*Es,), dx (n,
    D)) of sum(out * w)."""
    n = cases.RING_SHAPES[i][0]
    rows, cols, vals, x, w = cases.ring_inputs(i)
    mesh = _jmesh()
    g = JaxSparseGraph(jnp.asarray(rows), jnp.asarray(cols),
                       jnp.asarray(vals), n)
    g_sh, x_sh = jax_place(mesh, g, jnp.asarray(x))

    def loss(v, xx):
        out = jax_ring(mesh, dataclasses.replace(g_sh, values=v), xx)
        return jnp.sum(out * w), out

    (_, out), (dv, dx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(g_sh.values, x_sh)
    return np.asarray(out), np.asarray(dv), np.asarray(dx)[:n]


@pytest.mark.parametrize("i", range(len(cases.RING_SHAPES)))
def test_ring_spmm_matches_jax(ranks, i):
    out, _, _ = _jax_ring(i)
    for r in range(WORLD):
        got = ranks.result(r)[f"ring/{i}/out"]
        np.testing.assert_allclose(got, out, rtol=1e-4, atol=1e-4)
    # and the dense product
    n = cases.RING_SHAPES[i][0]
    rows, cols, vals, x, _ = cases.ring_inputs(i)
    dense = np.zeros((n, n), np.float64)
    np.add.at(dense, (rows, cols), vals)
    np.testing.assert_allclose(ranks.result(0)[f"ring/{i}/out"], dense @ x,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("i", range(len(cases.RING_SHAPES)))
def test_ring_spmm_grads_match_jax(ranks, i):
    _, dv, dx = _jax_ring(i)
    got = ranks.result(0)
    assert got[f"ring/{i}/dvalues"].shape == dv.shape
    np.testing.assert_allclose(got[f"ring/{i}/dvalues"], dv, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[f"ring/{i}/dx"], dx, rtol=1e-4, atol=1e-4)


def _encoder_inputs():
    model = cases.init_model(cases.ENC_LAYERS, 1)
    x, _, sup = cases.clip_inputs(1)
    return model, x, sup


def test_sparse_encoder_matches_jax(ranks):
    model, x, sup = _encoder_inputs()
    cfgs = jax_encoder_configs(cases.DIN, cases.H, cases.K, cases.N, 1,
                               cases.ENC_LAYERS, recurrence="naive")
    params = params_to_jax(model.state_dict())["encoder"]
    sgraph = jax_partition(jax_from_dense(sup), WORLD)
    stack, seq = jax_sparse_encoder(cfgs, params, _jmesh(), sgraph,
                                    jnp.asarray(x))
    for r in range(WORLD):
        got = ranks.result(r)
        np.testing.assert_allclose(got["encoder/stack"], np.asarray(stack),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(got["encoder/seq"], np.asarray(seq),
                                   rtol=2e-4, atol=2e-5)


def test_sparse_encoder_matches_dense(ranks):
    model, x, sup = _encoder_inputs()
    with torch.no_grad():
        stack, seq = encoder_apply(
            model.cell_cfgs, [c.params() for c in model.encoder],
            torch.from_numpy(sup)[None], torch.from_numpy(x))
    got = ranks.result(0)
    np.testing.assert_allclose(got["encoder/stack"], stack.numpy(),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["encoder/seq"], seq.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_sparse_train_steps_match_jax(ranks):
    model = cases.init_model(cases.STEP_LAYERS, 2)
    x, y, sup = cases.clip_inputs(2)
    cfgs = jax_encoder_configs(cases.DIN, cases.H, cases.K, cases.N, 1,
                               cases.STEP_LAYERS, recurrence="naive")
    params = jax.tree_util.tree_map(jnp.asarray,
                                    params_to_jax(model.state_dict()))
    opt = jax_make_optimizer(*cases.OPT)
    opt_state = opt.init(params)
    step = jax_sparse_step(cfgs, opt, _jmesh())
    sgraph = jax_partition(jax_from_dense(sup), WORLD)
    for i in range(cases.STEPS):
        params, opt_state, loss = step(params, opt_state, sgraph,
                                       jnp.asarray(x), jnp.asarray(y))
        want = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
        for r in range(WORLD):
            got = ranks.result(r)
            np.testing.assert_allclose(got[f"step/{i}/loss"], float(loss),
                                       rtol=1e-4, atol=1e-5)
            for k, v in want.items():
                np.testing.assert_allclose(got[f"step/{i}/{k}"], v.numpy(),
                                           atol=1e-5, err_msg=f"step {i} {k}")
    # every rank's parameters bitwise equal; the ring shifted
    for r in range(1, WORLD):
        for k in want:
            key = f"step/{cases.STEPS - 1}/{k}"
            np.testing.assert_array_equal(ranks.result(r)[key],
                                          ranks.result(0)[key])
    shifts = dict(zip(
        ("all_reduce_grads", "all_reduce_sum", "all_gather_rows",
         "broadcast_", "ring_shift"),
        ranks.result(0)["step/counts"].reshape(-1, 2)))
    assert shifts["all_reduce_grads"][0] == cases.STEPS
    assert shifts["ring_shift"][0] > 0


def test_sparse_step_gradients_match_dense(ranks):
    model = cases.init_model(cases.STEP_LAYERS, 2)
    x, y, sup = cases.clip_inputs(2)
    lengths = torch.full((cases.B,), cases.T)
    logits = model(torch.from_numpy(x).transpose(0, 1), lengths,
                   torch.from_numpy(sup)[None])
    bce_with_logits(logits, torch.from_numpy(y)).backward()
    got = ranks.result(0)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(got[f"step/grad/{k}"], p.grad.numpy(),
                                   rtol=2e-3, atol=1e-5, err_msg=k)


def test_data_graph_mesh_layout_matches_jax(ranks):
    """Rank r of data:2,graph:2 sits where the JAX mesh puts device r;
    its data group is its column, its graph ring its row."""
    ids = np.vectorize(lambda d: d.id)(_jmesh("data:2,graph:2").devices)
    for r in range(WORLD):
        got = ranks.result(r)
        d, g = (int(i) for i in np.argwhere(ids == r)[0])
        np.testing.assert_array_equal(got["mesh/coords"], [d, 2, g, 2])
        np.testing.assert_array_equal(got["mesh/data_ranks"], ids[:, g])
        np.testing.assert_array_equal(got["mesh/graph_ranks"], ids[d])
        for axis, members in (("data", ids[:, g]), ("graph", ids[d])):
            want = np.zeros(WORLD)
            want[members] = 1.0
            np.testing.assert_array_equal(got[f"mesh/{axis}_members"], want)


def test_data_step_through_graph_mesh_is_bitwise_data2(ranks):
    """The data-parallel detection step (tests/torch_dp_cases.py) over a
    data:2,graph:2 mesh: each graph index a replica, and every rank's
    state after every step bitwise equal to the plain data:2 mesh's."""
    ref = ranks.result(0)
    keys = [k for k in ref if k.startswith("d2/")]
    assert keys
    for r in range(WORLD):
        got = ranks.result(r)
        for k in keys:
            np.testing.assert_array_equal(got["dg/" + k[3:]], ref[k],
                                          err_msg=f"rank {r} {k}")
    for k in keys:
        np.testing.assert_array_equal(ranks.result(1)[k], ref[k])


def test_dryrun_multichip_on_four_ranks(ranks):
    """Every rank ran ``dryrun_multichip(4)`` (it raises on a failure) and
    wrote its results after it."""
    for r in range(WORLD):
        assert "ring/0/out" in ranks.result(r)
