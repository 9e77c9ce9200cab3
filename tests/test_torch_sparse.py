"""The graph axis's in-process pieces against the JAX package, on the CPU:
``graphs/sparse.py`` (both modes of ``from_dense_batch``, top-k ties
included, ``spmm``, ``row_normalize``, the dual random walk and
``batch_supports_to_sparse``), ``partition_by_dest`` bit for bit, each
rank's edge buckets, the ring on one rank (the SpMM and its VJP, the
sparse encoder and step against the dense path), ``parse_mesh_shape`` and
the rank grid against the JAX mesh's device layout, ``make_mesh`` on a
one-rank group, the utilities and ``entry()``'s forward.

The four-rank ring is tests/test_torch_graph_axis.py.
"""

import dataclasses
import json
import os
import socket

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jax_entry
from eeg_gnn_tpu.graphs import sparse as jsparse
from eeg_gnn_tpu.parallel.edge_partition import (
    partition_by_dest as jax_partition,
)
from eeg_gnn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from eeg_gnn_tpu.parallel.mesh import parse_mesh_shape as jax_parse
from eeg_gnn_tpu_torch import entry as tentry
from eeg_gnn_tpu_torch.graphs import sparse as tsparse
from eeg_gnn_tpu_torch.io import params_from_jax
from eeg_gnn_tpu_torch.models.dcgru import encoder_apply
from eeg_gnn_tpu_torch.parallel import distributed
from eeg_gnn_tpu_torch.parallel.edge_partition import (
    edge_partitioned_spmm,
    gather_blocks,
    partition_by_dest,
    place_edge_partitioned,
    shard_edges,
)
from eeg_gnn_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    parse_mesh_shape,
    rank_grid,
)
from eeg_gnn_tpu_torch.parallel.sparse_model import (
    make_sparse_train_step,
    sparse_encoder_apply,
)
from eeg_gnn_tpu_torch.train.losses import bce_with_logits
from eeg_gnn_tpu_torch.train.optim import make_optimizer
from eeg_gnn_tpu_torch.utils import profiling, timing

import torch_graph_cases as cases

ONE_RANK = Mesh(("graph",), (1,), 0, 1, torch.device("cpu"), "gloo")


def _adj(rng, b=4, n=19):
    a = np.abs(rng.rand(b, n, n)).astype(np.float32)
    for m in a:
        np.fill_diagonal(m, 1.0)
    return a


def _same(t_graph, j_graph):
    """A port SparseGraph bitwise equal to a JAX one."""
    assert t_graph.num_nodes == j_graph.num_nodes
    for k in ("rows", "cols", "values"):
        got, want = getattr(t_graph, k).numpy(), np.asarray(
            getattr(j_graph, k))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)


def test_from_dense_batch_all_slots_matches_jax(rng):
    adj = _adj(rng)
    got = tsparse.from_dense_batch(torch.from_numpy(adj))
    want = jsparse.from_dense_batch(jnp.asarray(adj))
    _same(got, want)
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  np.asarray(want.to_dense()))
    np.testing.assert_array_equal(got.transpose().to_dense().numpy(),
                                  np.asarray(want.to_dense()).T)


def test_from_dense_batch_top_k_keeps_jax_tie_order(rng):
    """Magnitudes on a coarse grid, signs mixed: many exact ties, at the
    cut too; ``lax.top_k`` keeps the lower flat index, and so must the
    port."""
    adj = (np.round(rng.rand(4, 19, 19) * 4) / 4).astype(np.float32)
    adj *= np.where(rng.rand(4, 19, 19) < 0.5, -1.0, 1.0).astype(np.float32)
    for e_clip in (64, 100):
        got = tsparse.from_dense_batch(torch.from_numpy(adj), e_clip)
        _same(got, jsparse.from_dense_batch(jnp.asarray(adj), e_clip))


def test_spmm_matches_jax(rng):
    adj = _adj(rng)
    x = rng.randn(4 * 19, 8).astype(np.float32)
    got = tsparse.spmm(tsparse.from_dense_batch(torch.from_numpy(adj)),
                       torch.from_numpy(x))
    want = jsparse.spmm(jsparse.from_dense_batch(jnp.asarray(adj)),
                        jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_row_normalize_matches_jax(rng):
    adj = _adj(rng)
    adj[1, 3, :] = 0.0  # a row of degree 0 stays 0
    got = tsparse.row_normalize(tsparse.from_dense_batch(
        torch.from_numpy(adj)))
    want = jsparse.row_normalize(jsparse.from_dense_batch(jnp.asarray(adj)))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))


@pytest.mark.parametrize("filter_type", ["random_walk", "dual_random_walk"])
def test_batch_supports_to_sparse_matches_jax(rng, filter_type):
    adj = _adj(rng)
    got = tsparse.batch_supports_to_sparse(torch.from_numpy(adj),
                                           filter_type)
    want = jsparse.batch_supports_to_sparse(jnp.asarray(adj), filter_type)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.to_dense().numpy(),
                                   np.asarray(w.to_dense()), rtol=1e-6,
                                   atol=1e-7)
    fwd, bwd = tsparse.dual_random_walk_sparse(
        tsparse.from_dense_batch(torch.from_numpy(adj)))
    jfwd, jbwd = jsparse.dual_random_walk_sparse(
        jsparse.from_dense_batch(jnp.asarray(adj)))
    for g, w in ((fwd, jfwd), (bwd, jbwd)):
        np.testing.assert_allclose(g.to_dense().numpy(),
                                   np.asarray(w.to_dense()), rtol=1e-6,
                                   atol=1e-7)
    with pytest.raises(ValueError, match="laplacian"):
        tsparse.batch_supports_to_sparse(torch.from_numpy(adj), "laplacian")
    assert tsparse.edges_per_second(10, 4, 2.0) == \
        jsparse.edges_per_second(10, 4, 2.0)


@pytest.mark.parametrize("i", range(len(cases.RING_SHAPES)))
@pytest.mark.parametrize("p", [3, 4, 8])
def test_partition_by_dest_is_jax_bit_for_bit(i, p):
    n = cases.RING_SHAPES[i][0]
    rows, cols, vals, _, _ = cases.ring_inputs(i)
    got = partition_by_dest(tsparse.SparseGraph(
        torch.from_numpy(rows), torch.from_numpy(cols),
        torch.from_numpy(vals), n), p)
    want = jax_partition(jsparse.SparseGraph(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals), n), p)
    for f in ("num_nodes", "num_nodes_padded", "block", "num_partitions"):
        assert getattr(got, f) == getattr(want, f), f
    _same(got, want)


def test_edge_shards_bucket_by_source_block(rng):
    """Each rank's shard holds the partition's edges of its destination
    block, grouped by source block, values in the partition's order."""
    n, p = 250, 4
    rows, cols, vals, _, _ = cases.ring_inputs(3)
    pg = partition_by_dest(tsparse.SparseGraph(
        torch.from_numpy(rows), torch.from_numpy(cols),
        torch.from_numpy(vals), n), p)
    es, blk = pg.shard_edges, pg.block
    for g in range(p):
        sh = shard_edges(pg, g)
        part = slice(g * es, (g + 1) * es)
        np.testing.assert_array_equal(sh.values.numpy(),
                                      pg.values[part].numpy())
        order = sh.order.numpy()
        np.testing.assert_array_equal(np.sort(order), np.arange(es))
        np.testing.assert_array_equal(sh.dst.numpy() + g * blk,
                                      pg.rows[part].numpy()[order])
        src_block = pg.cols[part].numpy()[order] // blk
        for j in range(p):
            assert (src_block[sh.bounds[j]:sh.bounds[j + 1]] == j).all()
        np.testing.assert_array_equal(
            sh.src.numpy() + src_block * blk, pg.cols[part].numpy()[order])


def test_ring_on_one_rank_matches_spmm_and_its_vjp(rng):
    """On a ring of one nothing moves: the SpMM, dx and dvalues equal
    ``graphs.sparse.spmm`` and its autograd."""
    n, feat = 250, 16
    rows, cols, vals, x, w = cases.ring_inputs(3)
    g = tsparse.SparseGraph(torch.from_numpy(rows), torch.from_numpy(cols),
                            torch.from_numpy(vals), n)
    shard, xb = place_edge_partitioned(ONE_RANK, g, torch.from_numpy(x))
    v = shard.values.clone().requires_grad_()
    xb.requires_grad_()
    out = gather_blocks(ONE_RANK, edge_partitioned_spmm(
        ONE_RANK, dataclasses.replace(shard, values=v), xb), n)
    (out * torch.from_numpy(w)).sum().backward()
    rv = torch.from_numpy(vals).requires_grad_()
    rx = torch.from_numpy(x).requires_grad_()
    ref = tsparse.spmm(tsparse.SparseGraph(g.rows, g.cols, rv, n), rx)
    (ref * torch.from_numpy(w)).sum().backward()
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xb.grad, rx.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(v.grad[:len(vals)], rv.grad, rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="node block"):
        edge_partitioned_spmm(ONE_RANK, shard, xb[:-1])
    with pytest.raises(TypeError, match="partition_by_dest"):
        edge_partitioned_spmm(ONE_RANK, g, xb)


def test_sparse_encoder_and_step_on_one_rank_match_dense(rng):
    """graph:1: the sparse encoder against the dense (stacked) encoder,
    and the sparse step's gradients against the dense classifier's."""
    model = cases.init_model(cases.ENC_LAYERS, 3)
    x, y, sup = cases.clip_inputs(3)
    sgraph = partition_by_dest(tsparse.from_dense_batch(
        torch.from_numpy(sup)), 1)
    params = [c.params() for c in model.encoder]
    with torch.no_grad():
        got = sparse_encoder_apply(model.cell_cfgs, params, ONE_RANK,
                                   sgraph, torch.from_numpy(x))
        want = encoder_apply(model.cell_cfgs, params,
                             torch.from_numpy(sup)[None],
                             torch.from_numpy(x))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)
    step = make_sparse_train_step(
        model, make_optimizer(model.parameters(), *cases.OPT), ONE_RANK)
    step.loss_and_grads(sgraph, x, y)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad()
    logits = model(torch.from_numpy(x).transpose(0, 1),
                   torch.full((cases.B,), cases.T),
                   torch.from_numpy(sup)[None])
    bce_with_logits(logits, torch.from_numpy(y)).backward()
    for k, p in model.named_parameters():
        torch.testing.assert_close(grads[k], p.grad, rtol=2e-3, atol=1e-5)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert torch.isfinite(step(sgraph, x, y))
    assert any(not torch.equal(before[k], v)
               for k, v in model.state_dict().items())


@pytest.mark.parametrize("spec,n", [("data:4,graph:2", 8),
                                    ("data:-1,graph:2", 8),
                                    ("graph:2,data:4", 8), ("graph:8", 8),
                                    ("data:-1", 8), ("graph:-1", 4)])
def test_mesh_shape_and_rank_grid_match_jax(spec, n):
    """``parse_mesh_shape`` as JAX's, and rank r where the JAX mesh puts
    device r: under data:4,graph:2, data index r // 2, graph index r % 2."""
    names, sizes = parse_mesh_shape(spec, n)
    assert (names, sizes) == jax_parse(spec, n)
    ids = np.vectorize(lambda d: d.id)(
        jax_make_mesh(spec, jax.devices()[:n]).devices)
    grid = rank_grid(names, sizes)
    if names[0] == "graph" and len(names) == 2:
        ids = ids.T
    np.testing.assert_array_equal(grid, ids.reshape(grid.shape))
    if spec == "data:4,graph:2":
        for r in range(n):
            assert tuple(np.argwhere(grid == r)[0]) == (r // 2, r % 2)


@pytest.fixture()
def one_rank_group():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize(f"tcp://127.0.0.1:{port}", 1, 0, device="cpu")
    try:
        yield
    finally:
        distributed.shutdown()


def test_make_mesh_builds_graph_axes(one_rank_group):
    for spec in ("graph:1", "data:1,graph:1", "graph:-1"):
        mesh = make_mesh(spec)
        assert (mesh.rank, mesh.world, mesh.graph_rank,
                mesh.graph_world) == (0, 1, 0, 1)
        assert mesh.data_ranks == mesh.graph_ranks == (0,)
    for spec in ("graph:2", "data:1,graph:2", "data:2,graph:1"):
        with pytest.raises(ValueError, match="asks for"):
            make_mesh(spec)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        make_mesh("model:1")


def test_timing_and_profiling(tmp_path, capsys):
    with timing.timer("x"):
        pass
    assert "[x] done in" in capsys.readouterr().out
    t = timing.Timer()
    assert t.check() >= 0.0
    profiling.reset()
    for _ in range(3):
        with profiling.timed("eeg.test.timing") as block:
            torch.ones(()).item()
        assert block.seconds >= 0.0
    assert profiling.totals()["eeg.test.timing"].count == 3
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("eeg.test.span"):
            torch.ones(8).sum()
    assert prof is not None
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "eeg.test.span" in names
    profiling.reset()
    assert profiling.totals() == {}


def test_entry_forward_matches_jax(monkeypatch):
    """``entry()``'s forward on the CPU from the JAX entry's weights and
    inputs equals the JAX forward; without ``device`` it means the card."""
    jfn, (jparams, jx, jlens, jsup) = jax_entry.entry()
    want = np.asarray(jax.jit(jfn)(jparams, jx, jlens, jsup))
    fn, (params, x, lens, sup) = tentry.entry(device="cpu")
    assert set(params) == set(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_allclose(sup.numpy(), np.asarray(jsup), rtol=1e-4,
                               atol=1e-5)
    got = fn(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams)),
             torch.from_numpy(np.array(jx)), lens,
             torch.from_numpy(np.array(jsup)))
    assert got.shape == want.shape == (8, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry()
