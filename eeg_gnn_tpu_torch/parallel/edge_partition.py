"""Edge-partitioned distributed SpMM over a mesh's ``graph`` axis
(``eeg_gnn_tpu/parallel/edge_partition.py``).

The edges of a sparse graph (a batch's block-diagonal clip graph) are
partitioned by destination node block over the p ranks of a graph ring,
node features are split in the same blocks, and

    out = A @ X

is p ring steps with a **stationary output**: each rank owns the output
rows of its block and accumulates into ONLY that (N/p, D) block, while
the X blocks circulate around the ring (``distributed.ring_shift``, one
``batch_isend_irecv`` a step, started before the step's local sum so the
exchange overlaps it). Every local edge's destination lies in the owned
block by construction, so no reduction follows.

Per rank, memory is O(N/p * D) for the owned block, the circulating
block and the received one, O(E/p) for the edge shard and O(E/p * D) at
most for a step's gathered-edge temporary (the edges whose source lies
in the block at hand). The backward (:class:`_RingSpMM`) runs the ring
again in the same direction: dx accumulators travel with the X blocks,
each rank adding the transposed products of its own edges into the
accumulator of the block at hand, and one more shift delivers every
accumulator to its owner; dvalues come from the X blocks as they pass.
It saves nothing but this rank's own X block, never the p blocks.

Nodes and edges are padded as the JAX package pads them
(:func:`partition_by_dest`), so neither p | N nor p | E is needed;
padding edges carry value 0. Each rank additionally buckets its edge
shard by source block (:func:`shard_edges`, a stable sort on the host),
so ring step s touches only the edges whose source block is at hand,
where the JAX body masks the whole shard every step. The local sum is
``index_add_``; on a card it adds with atomics, so its order is not
fixed.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

from eeg_gnn_tpu_torch.graphs.sparse import SparseGraph
from eeg_gnn_tpu_torch.parallel import distributed
from eeg_gnn_tpu_torch.parallel.mesh import Mesh


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """A SparseGraph re-laid-out for the stationary-output ring SpMM.

    Edge arrays are (p * shard_edges,) with shard d = slice
    ``[d*shard_edges : (d+1)*shard_edges]`` holding exactly the edges whose
    destination row lies in node block d (padded with value-0 edges): the
    JAX package's layout, bit for bit.
    """

    rows: torch.Tensor    # (p*Es,) int32 global destination rows
    cols: torch.Tensor    # (p*Es,) int32 global source columns
    values: torch.Tensor  # (p*Es,) float32; padding edges are exactly 0
    num_nodes: int
    num_nodes_padded: int
    block: int            # rows a rank
    num_partitions: int

    @property
    def shard_edges(self) -> int:
        return self.rows.shape[0] // self.num_partitions


@dataclasses.dataclass(frozen=True)
class EdgeShard:
    """Graph index ``index``'s share of a :class:`PartitionedGraph`: the
    edges whose destination lies in its node block.

    ``values`` is the shard in the partition's order (the SpMM's
    differentiable input: replace it to differentiate by the edge
    weights). ``dst`` / ``src`` are the same edges' destination row within
    this block and source row within the source's block, bucketed by
    source block (``order[i]`` is sorted edge i's position in the shard):
    the edges from block j are ``[bounds[j], bounds[j+1])``.
    """

    values: torch.Tensor  # (Es,) float32
    dst: torch.Tensor     # (Es,) int32
    src: torch.Tensor     # (Es,) int32
    order: torch.Tensor   # (Es,) int64
    bounds: Tuple[int, ...]
    index: int
    num_nodes: int
    num_nodes_padded: int
    block: int
    num_partitions: int


def partition_by_dest(graph: SparseGraph, p: int) -> PartitionedGraph:
    """Host-side prep: pad nodes to p * ceil(N/p), bucket edges by
    destination block, pad every bucket to the largest bucket's size
    (padding edges: row the bucket's first row, column 0, value 0)."""
    rows = np.asarray(graph.rows.cpu(), np.int64)
    cols = np.asarray(graph.cols.cpu(), np.int64)
    vals = np.asarray(graph.values.detach().cpu(), np.float32)

    n = graph.num_nodes
    blk = -(-n // p)
    n_pad = blk * p

    dest = rows // blk
    buckets = [np.flatnonzero(dest == d) for d in range(p)]
    es = max(1, max(len(b) for b in buckets))

    out_r = np.empty((p, es), np.int32)
    out_c = np.zeros((p, es), np.int32)
    out_v = np.zeros((p, es), np.float32)
    for d, idx in enumerate(buckets):
        out_r[d] = d * blk  # padding rows: any owned row (values are 0)
        out_r[d, : len(idx)] = rows[idx]
        out_c[d, : len(idx)] = cols[idx]
        out_v[d, : len(idx)] = vals[idx]

    return PartitionedGraph(
        torch.from_numpy(out_r.reshape(-1)),
        torch.from_numpy(out_c.reshape(-1)),
        torch.from_numpy(out_v.reshape(-1)), n, n_pad, blk, p)


def shard_edges(graph: PartitionedGraph, index: int,
                device=None) -> EdgeShard:
    """Graph index ``index``'s :class:`EdgeShard` of ``graph`` on
    ``device`` (host numpy for the bucketing, then one copy)."""
    es, blk, p = graph.shard_edges, graph.block, graph.num_partitions
    part = slice(index * es, (index + 1) * es)
    rows = graph.rows[part].cpu().numpy().astype(np.int64)
    cols = graph.cols[part].cpu().numpy().astype(np.int64)
    order = np.argsort(cols // blk, kind="stable")
    bounds = np.searchsorted(cols[order] // blk, np.arange(p + 1))
    put = lambda a, dtype: torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dtype)
    return EdgeShard(
        graph.values[part].to(device=device, dtype=torch.float32),
        put(rows[order] - index * blk, torch.int32),
        put(cols[order] % blk, torch.int32), put(order, torch.int64),
        tuple(int(b) for b in bounds), index, graph.num_nodes,
        graph.num_nodes_padded, blk, p)


def local_shard(mesh: Mesh, graph: Union[PartitionedGraph, EdgeShard]
                ) -> EdgeShard:
    """This rank's shard: ``graph`` itself when it is one (checked
    against the mesh), else cut from the whole partition."""
    if isinstance(graph, SparseGraph):
        raise TypeError(
            "the ring SpMM needs a partitioned graph; call "
            "partition_by_dest(graph, p) once first")
    if graph.num_partitions != mesh.graph_world:
        raise ValueError(f"graph partitioned {graph.num_partitions} ways; "
                         f"the mesh's graph axis has {mesh.graph_world}")
    if isinstance(graph, EdgeShard):
        if graph.index != mesh.graph_rank:
            raise ValueError(f"edge shard {graph.index} on graph index "
                             f"{mesh.graph_rank}")
        return graph
    return shard_edges(graph, mesh.graph_rank, mesh.device)


def node_block(mesh: Mesh, x: torch.Tensor, num_nodes_padded: int,
               dim: int = 0) -> torch.Tensor:
    """This rank's node block of ``x`` (the whole, the same on every
    rank) along ``dim``: padded with zeros to ``num_nodes_padded``, rows
    ``[g*blk, (g+1)*blk)`` for graph index g."""
    blk = num_nodes_padded // mesh.graph_world
    lo, n = mesh.graph_rank * blk, x.shape[dim]
    x = x.narrow(dim, lo, max(0, min(blk, n - lo)))
    if x.shape[dim] < blk:
        pad = list(x.shape)
        pad[dim] = blk - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim)
    return x


class _GatherBlocks(torch.autograd.Function):
    """The graph ring's node blocks concatenated in graph order. Every
    rank computes what follows the gather (the same on every rank), so
    the cotangent of this rank's block is its rows of the whole one."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        ctx.mesh, ctx.dim, ctx.blk = mesh, dim, t.shape[dim]
        if mesh.graph_world == 1:
            return t.clone()
        moved = t.movedim(dim, 0)
        full = distributed.all_gather_rows(moved, mesh, axis="graph")
        return full.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.graph_rank * ctx.blk
        return g.narrow(ctx.dim, lo, ctx.blk), None, None


def gather_blocks(mesh: Mesh, t: torch.Tensor, num_nodes: int,
                  dim: int = 0) -> torch.Tensor:
    """The whole (``num_nodes`` along ``dim``) from every rank's node
    block ``t``: an all-gather over the graph ring, differentiable (see
    :class:`_GatherBlocks`)."""
    return _GatherBlocks.apply(t, mesh, dim).narrow(dim, 0, num_nodes)


def _edges(shard: EdgeShard, j: int):
    lo, hi = shard.bounds[j], shard.bounds[j + 1]
    return lo, hi, shard.src[lo:hi], shard.dst[lo:hi]


def _ring_forward(mesh: Mesh, shard: EdgeShard, vals: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """The owned block of ``A @ X``: at step s this rank holds the X block
    of ``owner = (g - s) mod p`` and sums its own edges from it."""
    p, g = shard.num_partitions, shard.index
    out = x.new_zeros(x.shape)
    x_blk = x
    for s in range(p):
        shift = distributed.ring_shift(x_blk, mesh) if s + 1 < p else None
        lo, hi, src, dst = _edges(shard, (g - s) % p)
        if hi > lo:
            gathered = x_blk.index_select(0, src).mul_(vals[lo:hi, None])
            out.index_add_(0, dst, gathered)
            del gathered
        if shift is not None:
            x_blk = shift.wait()
    return out


def _ring_backward(mesh: Mesh, shard: EdgeShard, vals: torch.Tensor,
                   x: torch.Tensor, dout: torch.Tensor, need_dx: bool,
                   need_dv: bool):
    """(dx of this rank's block, dvalues of its sorted edges). The X
    blocks (for dvalues) and the dx accumulators travel the ring in the
    forward's direction, one message a step; at step s this rank holds
    those of block ``(g - s) mod p``, and after the p-th shift the
    accumulator of its own block."""
    p, g, d = shard.num_partitions, shard.index, x.shape[1]
    acc = torch.zeros_like(x) if need_dx else None
    dv = vals.new_zeros(vals.shape) if need_dv else None
    x_blk = x if need_dv else None
    for s in range(p):
        lo, hi, src, dst = _edges(shard, (g - s) % p)
        if hi > lo:
            dg = dout.index_select(0, dst)
            if need_dv:
                dv[lo:hi] = (dg * x_blk.index_select(0, src)).sum(1)
            if need_dx:
                acc.index_add_(0, src, dg.mul_(vals[lo:hi, None]))
            del dg
        if p == 1:
            break
        last = s + 1 == p
        parts = ([x_blk] if need_dv and not last else []) + \
            ([acc] if need_dx else [])
        if not parts:
            continue
        got = distributed.ring_shift(
            parts[0] if len(parts) == 1 else torch.cat(parts, 1),
            mesh).wait()
        if need_dv and not last:
            x_blk = got[:, :d]
        if need_dx:
            acc = got[:, -d:]
    return acc, dv


class _RingSpMM(torch.autograd.Function):
    """This rank's block of ``A @ X`` over the graph ring, and its VJP
    by the reverse products on the same ring (module docstring)."""

    @staticmethod
    def forward(ctx, values, x, shard, mesh):
        vals = values.index_select(0, shard.order)
        ctx.save_for_backward(vals, x)
        ctx.shard, ctx.mesh = shard, mesh
        return _ring_forward(mesh, shard, vals, x)

    @staticmethod
    def backward(ctx, dout):
        vals, x = ctx.saved_tensors
        shard = ctx.shard
        need_dv, need_dx = ctx.needs_input_grad[0], ctx.needs_input_grad[1]
        dx, dv = _ring_backward(ctx.mesh, shard, vals, x,
                                dout.contiguous(), need_dx, need_dv)
        dvalues = None
        if need_dv:
            dvalues = torch.zeros_like(dv).index_copy_(0, shard.order, dv)
        return dvalues, dx, None, None


def edge_partitioned_spmm(mesh: Mesh,
                          graph: Union[PartitionedGraph, EdgeShard],
                          x: torch.Tensor) -> torch.Tensor:
    """Distributed A @ X with O(N/p * D) memory a rank.

    Args:
        mesh: a mesh whose graph axis has ``graph.num_partitions`` ranks.
        graph: this rank's :class:`EdgeShard` (``place_edge_partitioned``)
            or the whole :class:`PartitionedGraph` (cut here, each call).
        x: this rank's (block, D) node block of the features.

    Returns:
        This rank's (block, D) block of the result (``gather_blocks`` for
        the whole); differentiable in ``x`` and in the shard's values.
    """
    shard = local_shard(mesh, graph)
    if x.shape[0] != shard.block:
        raise ValueError(f"x has {x.shape[0]} rows; this rank's node "
                         f"block has {shard.block}")
    return _RingSpMM.apply(shard.values, x.contiguous(), shard, mesh)


def place_edge_partitioned(mesh: Mesh, graph: SparseGraph,
                           x: torch.Tensor):
    """Partition ``graph`` over the mesh's graph ring and keep this
    rank's share, on its device.

    ``graph`` and ``x`` (num_nodes, D) are the same on every rank. Graph
    index g keeps the edges whose destination lies in node block g (rows
    ``[g*blk, (g+1)*blk)`` of the padded ``p * blk`` nodes) and those rows
    of ``x`` (zero past ``num_nodes``). Returns ``(shard, x_block)``: its
    :class:`EdgeShard` and (blk, D) feature block, the arguments of
    :func:`edge_partitioned_spmm`; ``gather_blocks(mesh, out_block,
    num_nodes)`` gives the whole result.
    """
    pg = partition_by_dest(graph, mesh.graph_world)
    x_block = node_block(mesh, x, pg.num_nodes_padded)
    return (shard_edges(pg, mesh.graph_rank, mesh.device),
            x_block.to(mesh.device).contiguous())
