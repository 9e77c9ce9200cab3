"""The port's data-parallel pieces that need no second process, against
the JAX package on the CPU: ``parse_mesh_shape``; the loaders' per-rank
batch indices and global ``valid`` (``process_shard``); the row-sharded
caches' plans (``mesh_plan``, ``mesh_epoch_plan``, ``mesh_shard_plan``)
and the rows a rank featurizes (``_process_rows``, ``_stripe_rows``; the
JAX ones under a patched ``jax.process_count`` / ``process_index``),
array for array from the same seeds; the draws for the global batch; and,
on a one-rank gloo group in this process, the gradient all-reduce's
bytes (at most 3x the parameters', the bound of
tests/test_collectives.py) and a one-rank mesh step bitwise equal to the
step without a mesh. The two-rank runs: tests/test_torch_dp_step.py and
tests/test_torch_dp_cli.py.
"""

import socket

import numpy as np
import pytest
import torch

import jax

from eeg_gnn_tpu.data import device_cache as jdc
from eeg_gnn_tpu.data import loader as jloader
from eeg_gnn_tpu.data import rotating_cache as jrc
from eeg_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from eeg_gnn_tpu.parallel.mesh import parse_mesh_shape as jax_parse
from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.data import device_cache as tdc
from eeg_gnn_tpu_torch.data import loader as tloader
from eeg_gnn_tpu_torch.data import rotating_cache as trc
from eeg_gnn_tpu_torch.models.densecnn import GlobalBatchNorm1d
from eeg_gnn_tpu_torch.models.registry import build_model
from eeg_gnn_tpu_torch.parallel import distributed, make_mesh
from eeg_gnn_tpu_torch.parallel.mesh import (
    Mesh,
    global_draws,
    parse_mesh_shape,
    rand,
)
from eeg_gnn_tpu_torch.train import TrainStep


def _mesh(rank, world=2):
    return Mesh(("data",), (world,), rank, world, torch.device("cpu"),
                "gloo")


@pytest.mark.parametrize("spec,n", [("data:-1", 4), ("data:2", 8),
                                    ("data:4,graph:2", 8),
                                    ("data:-1,graph:2", 8)])
def test_parse_mesh_shape_matches_jax(spec, n):
    assert parse_mesh_shape(spec, n) == jax_parse(spec, n)


@pytest.mark.parametrize("n,bsz,count", [(10, 4, 2), (12, 4, 2), (3, 4, 2),
                                         (37, 6, 3)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_rank_batches_match_jax(n, bsz, count, shuffle):
    """Each rank's index arrays and the global valid counts of 3
    consecutive epochs equal the JAX loader's under the same
    ``process_shard``; the ranks' rows together are the global batch
    padded at its end with its first sample."""
    data = list(range(n))
    for rank in range(count):
        ours = tloader.DataLoader(data, bsz, shuffle=shuffle, seed=5,
                                  process_shard=(rank, count))
        theirs = jloader.DataLoader(data, bsz, shuffle=shuffle, seed=5,
                                    process_shard=(rank, count))
        for _ in range(3):
            got, want = ours._batch_indices(), theirs._batch_indices()
            assert len(got) == len(want) == len(ours)
            for (ia, va), (ib, vb) in zip(got, want):
                np.testing.assert_array_equal(ia, ib)
                assert va == vb
    with pytest.raises(ValueError, match="not divisible"):
        tloader.DataLoader(data, 5, process_shard=(0, 2))


@pytest.mark.parametrize("num_real,block,p,bsz", [(7, 4, 2, 4), (8, 4, 2, 4),
                                                  (5, 3, 2, 2), (9, 3, 4, 8),
                                                  (1, 1, 2, 2)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_mesh_plans_equal_jax(num_real, block, p, bsz, shuffle):
    j_rng, t_rng = np.random.RandomState(3), np.random.RandomState(3)
    for _ in range(2):
        for a, b in zip(tdc.mesh_plan(num_real, block, p, bsz, shuffle,
                                      t_rng),
                        jdc.mesh_plan(num_real, block, p, bsz, shuffle,
                                      j_rng)):
            np.testing.assert_array_equal(a, b)
    feats = np.zeros((num_real, 2, 3, 4), np.float32)
    labels = np.zeros(num_real, np.float32)
    port = tdc.DeviceDatasetCache(feats, labels, 2, device="cpu")
    theirs = jdc.DeviceDatasetCache(feats, labels, 2)
    for a, b in zip(port.mesh_epoch_plan(bsz, p, shuffle, t_rng),
                    theirs.mesh_epoch_plan(bsz, p, shuffle, j_rng)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,budget", [(7, 3 * 96 * 2), (11, 3 * 96 * 2),
                                      (16, 3 * 96 * 3)])
def test_rotating_mesh_plans_equal_jax(n, budget):
    """A striped rotating cache's geometry, shard order and per-shard
    plans against the JAX single-process mesh cache's (data:2 over the
    virtual devices), from one RandomState."""
    feats = np.zeros((n, 2, 3, 4), np.float32)  # 96 B a clip
    labels = np.arange(n, dtype=np.float32)
    theirs = jrc.RotatingDeviceCache(
        feats, labels, 2, budget_bytes=budget,
        mesh=jax_make_mesh("data:2", jax.devices()[:2]))
    port = trc.RotatingDeviceCache(feats, labels, 2, budget_bytes=budget,
                                   mesh=_mesh(0), device="cpu")
    assert (port.num_shards, port.shard_rows) == (theirs.num_shards,
                                                  theirs.shard_rows)
    j_rng, t_rng = np.random.RandomState(9), np.random.RandomState(9)
    order = theirs.epoch_shard_order(j_rng)
    got = list(port.mesh_shard_plans(4, True, t_rng))
    assert len(got) == len(order)
    for sid, (slab, idx, mask) in zip(order, got):
        assert slab.shard == sid
        want = theirs.mesh_shard_plan(sid, 4, True, j_rng)
        np.testing.assert_array_equal(idx, want[0])
        np.testing.assert_array_equal(mask, want[1])


class _Items:
    """A dataset of (features, label, ...) items of fixed shapes."""

    def __init__(self, n, ssl=False):
        self.n, self.ssl = n, ssl

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        x = np.full((2, 3, 4), i, np.float32)
        return (x, x[:1] if self.ssl else np.float32(i % 2), 2, [], [],
                f"c{i}")


@pytest.mark.parametrize("n", [5, 8, 13])
def test_rank_rows_match_jax(monkeypatch, n):
    """The dataset rows rank r featurizes: its block of the padded split
    (resident) and its stripes of every shard (rotating), as JAX's
    process r of 2 (the JAX functions under a patched process count and
    index)."""
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    jmesh = type("JaxMesh", (), {"shape": {"data": 2}})()
    assert tdc._process_rows(n, _mesh(0, 1)) == (None, None)
    for rank in (0, 1):
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        assert tdc._process_rows(n, _mesh(rank)) == \
            jdc._process_rows(n, jmesh)
        for kind in ("detection", "ssl"):
            ds = _Items(n, kind == "ssl")
            args = (ds, kind, "float32", 3 * 96 * 2, 2)
            assert trc._stripe_rows(*args, _mesh(rank)) == \
                jrc._stripe_rows(*args, jmesh)


def test_draws_for_the_global_batch():
    """Under ``global_draws`` each rank's rows of a draw are the global
    draw's rows, whatever the batch axis; outside, a plain draw."""
    shape = (6, 3)
    want = torch.rand(shape, generator=torch.Generator().manual_seed(1))
    got = []
    for rank in range(3):
        with global_draws(rank * 2, 6):
            got.append(rand((2, 3), torch.Generator().manual_seed(1), "cpu"))
    torch.testing.assert_close(torch.cat(got), want, rtol=0, atol=0)
    want = torch.rand((2, 6), generator=torch.Generator().manual_seed(2))
    with global_draws(4, 6):
        got = rand((2, 2), torch.Generator().manual_seed(2), "cpu",
                   batch_axis=1)
    torch.testing.assert_close(got, want[:, 4:], rtol=0, atol=0)
    plain = rand((2, 3), torch.Generator().manual_seed(1), "cpu")
    torch.testing.assert_close(plain, torch.rand(
        (2, 3), generator=torch.Generator().manual_seed(1)), rtol=0, atol=0)


def test_global_batchnorm_without_mesh_is_batchnorm():
    bn = GlobalBatchNorm1d(5)
    ref = torch.nn.BatchNorm1d(5)
    x = torch.randn(4, 5, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(bn(x), ref(x), rtol=0, atol=0)
    torch.testing.assert_close(bn.running_var, ref.running_var)


@pytest.fixture()
def one_rank_group():
    """A one-rank gloo group on the CPU in this process (torn down
    after)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    distributed.initialize(f"tcp://127.0.0.1:{port}", 1, 0, device="cpu")
    try:
        yield make_mesh("data:-1")
    finally:
        distributed.shutdown()


def _flagship_small():
    cfg = ExperimentConfig(graph_type="combined", max_seq_len=4,
                           num_rnn_layers=2, rnn_units=16,
                           max_diffusion_step=2, input_dim=12,
                           dropout=0.5).finalize()
    rng = np.random.RandomState(0)
    adj = np.abs(rng.rand(4, 19, 19)).astype(np.float32)
    batch = {"x": rng.randn(4, 4, 19, 12).astype(np.float32),
             "y": rng.randint(0, 2, size=4).astype(np.float32),
             "adjacency": (adj + adj.transpose(0, 2, 1)) / 2, "valid": 3}
    return cfg, batch


def test_gradient_all_reduce_bytes_are_param_bound(one_rank_group):
    """A one-rank mesh: each step launches exactly one gradient
    all-reduce and no other collective, of at most 3x the parameter
    bytes (tests/test_collectives.py:117-133's bound; here the
    gradients and the loss: 1x + 4 B), and its parameters equal a step
    without a mesh bit for bit (dropout 0.5 drawn for the global
    batch)."""
    mesh = one_rank_group
    assert distributed.process_batch_slice(8) == (0, 8)
    assert distributed.process_shard() is None  # one rank: no sharding
    cfg, batch = _flagship_small()
    plain = TrainStep(cfg, build_model(cfg, torch.Generator().manual_seed(
        0)), 2, device="cpu")
    meshed = TrainStep(cfg, build_model(cfg, torch.Generator().manual_seed(
        0)), 2, mesh=mesh)
    param_bytes = sum(p.numel() * p.element_size()
                      for p in meshed.model.parameters())
    distributed.reset_counts()
    for _ in range(3):
        a, b = plain(batch), meshed(batch)
        assert float(a) == float(b)
    counts = distributed.counts()
    calls, nbytes = counts["all_reduce_grads"]
    assert calls == 3
    assert 0 < nbytes / 3 <= 3 * param_bytes
    assert nbytes / 3 == param_bytes + 4
    assert all(c == (0, 0) for k, c in counts.items()
               if k != "all_reduce_grads")
    for (k, p), q in zip(plain.model.state_dict().items(),
                         meshed.model.state_dict().values()):
        assert torch.equal(p, q), k


def test_mesh_shape_asks_for_ranks_that_do_not_run(tmp_path):
    """One process and --mesh_shape data:2: the CLI raises before the run
    directory exists (no fallback to one rank)."""
    from eeg_gnn_tpu_torch.cli import train as cli

    with pytest.raises(ValueError, match="more ranks than the one"):
        cli.main(["--do_train", "--save_dir", str(tmp_path),
                  "--mesh_shape", "data:2"], device="cpu")
    assert not list(tmp_path.iterdir())
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh("data:-1")


def test_shard_batch_keeps_the_rows_jax_puts_on_a_device():
    """``shard_batch`` of rank r's host rows gives the arrays JAX's
    ``shard_batch`` puts on device r of a data:2 mesh (supports by axis
    1, ``valid`` as it is); ``local_cache_gather`` gathers a rank's block
    by its local indices."""
    from eeg_gnn_tpu.train.step import shard_batch as jax_shard_batch
    from eeg_gnn_tpu_torch.train.step import local_cache_gather, shard_batch

    rng = np.random.RandomState(4)
    full = {"x": rng.randn(4, 3, 5).astype(np.float32),
            "supports": rng.randn(2, 4, 5, 5).astype(np.float32),
            "valid": np.int32(3)}
    jmesh = jax_make_mesh("data:2", jax.devices()[:2])
    want = jax_shard_batch(full, jmesh)
    for rank in (0, 1):
        mesh = _mesh(rank)
        rows = mesh.rows(4)
        got = shard_batch({"x": full["x"][rows],
                           "supports": full["supports"][:, rows],
                           "valid": full["valid"]}, mesh)
        for k in ("x", "supports"):
            shard = next(s for s in want[k].addressable_shards
                         if s.device == jax.devices()[rank])
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(shard.data))
        assert got["valid"] == 3
        block = torch.arange(12.0).reshape(6, 2)
        idx = torch.tensor([2, 0])
        torch.testing.assert_close(local_cache_gather(mesh)(block, idx),
                                   block[[2, 0]])
