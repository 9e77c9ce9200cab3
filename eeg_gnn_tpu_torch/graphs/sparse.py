"""Sparse adjacency store and block-diagonal batched clip graphs
(``eeg_gnn_tpu/graphs/sparse.py``).

B clips of N nodes become one (B*N, B*N) graph with no cross-clip edges,
held as padded COO:

- ``SparseGraph``: ``rows`` / ``cols`` (int32) and ``values`` tensors
  with ``from_dense_batch`` / ``to_dense`` converters;
- ``spmm``: edge gather and scatter-add (``index_select``,
  ``index_add_``), the JAX package's gather and ``segment_sum``;
- per-edge normalizations mirroring ``graphs/supports.py``, so
  random-walk supports are built without densifying.

Every clip contributes the same number of edge slots; absent edges carry
value 0. On a CUDA tensor ``index_add_`` sums with atomics, so the order
of a row's sum (and its last bits) is not fixed there.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class SparseGraph:
    """Padded COO sparse matrix of shape (num_nodes, num_nodes)."""

    rows: torch.Tensor    # (E,) int32 destination node per edge
    cols: torch.Tensor    # (E,) int32 source node per edge
    values: torch.Tensor  # (E,) float edge weights (0 for padding)
    num_nodes: int

    def to_dense(self) -> torch.Tensor:
        dense = torch.zeros((self.num_nodes, self.num_nodes),
                            dtype=self.values.dtype, device=self.values.device)
        return dense.index_put_((self.rows.long(), self.cols.long()),
                                self.values, accumulate=True)

    def transpose(self) -> "SparseGraph":
        return SparseGraph(self.cols, self.rows, self.values, self.num_nodes)


def from_dense_batch(adj_batch: torch.Tensor,
                     max_edges_per_clip: Optional[int] = None) -> SparseGraph:
    """Batched (B, N, N) dense adjacencies -> one block-diagonal SparseGraph.

    Every clip contributes ``max_edges_per_clip`` edge slots (default N*N,
    every (i, j) in row-major order). Fewer keeps each clip's largest
    entries by magnitude, ties to the lower flat index, as
    ``jax.lax.top_k`` gives them: a stable descending sort
    (``torch.topk`` does not promise that order).
    """
    adj_batch = torch.as_tensor(adj_batch)
    b, n, _ = adj_batch.shape
    e_clip = n * n if max_edges_per_clip is None else max_edges_per_clip
    dev = adj_batch.device
    flat = adj_batch.reshape(b, n * n)
    if e_clip == n * n:
        idx = torch.arange(n * n, device=dev).expand(b, n * n)
        vals = flat
    else:
        idx = torch.sort(flat.abs(), dim=1, descending=True,
                         stable=True).indices[:, :e_clip]
        vals = torch.gather(flat, 1, idx)
    base = (torch.arange(b, device=dev) * n)[:, None]
    rows = (base + idx // n).reshape(-1).to(torch.int32)
    cols = (base + idx % n).reshape(-1).to(torch.int32)
    return SparseGraph(rows, cols, vals.reshape(-1), b * n)


def _segment_sum(data: torch.Tensor, segments: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, segments, data)


def spmm(graph: SparseGraph, x: torch.Tensor) -> torch.Tensor:
    """Sparse @ dense: (num_nodes, num_nodes) x (num_nodes, D) -> (num_nodes,
    D); each row sums over its in-edges, as dense ``A @ X``."""
    gathered = x.index_select(0, graph.cols) * graph.values[:, None]
    return _segment_sum(gathered, graph.rows, graph.num_nodes)


def row_normalize(graph: SparseGraph) -> SparseGraph:
    """D^-1 A on the sparse store (random-walk transition matrix)."""
    deg = _segment_sum(graph.values, graph.rows, graph.num_nodes)
    pos = deg > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, deg, torch.ones_like(deg)),
                      torch.zeros_like(deg))
    return SparseGraph(graph.rows, graph.cols,
                       graph.values * inv.index_select(0, graph.rows),
                       graph.num_nodes)


def dual_random_walk_sparse(graph: SparseGraph):
    """[(D^-1 A)^T, (D_in^-1 A^T)^T] as SparseGraphs: numerically
    ``compute_supports(.., 'dual_random_walk')``."""
    fwd = row_normalize(graph).transpose()
    bwd = row_normalize(graph.transpose()).transpose()
    return fwd, bwd


def batch_supports_to_sparse(adj_batch: torch.Tensor, filter_type: str):
    """Batched dense adjacency -> list of block-diagonal sparse supports.

    Random-walk families only (the laplacian needs an eigensolve and stays
    dense)."""
    g = from_dense_batch(adj_batch)
    if filter_type == "random_walk":
        return [row_normalize(g).transpose()]
    if filter_type == "dual_random_walk":
        return list(dual_random_walk_sparse(g))
    raise ValueError(f"sparse supports not defined for {filter_type}")


def edges_per_second(num_edges: int, feat_dim: int, seconds: float) -> float:
    """Effective edges/s of an SpMM of E edges by D features (each
    edge-feature pair is one multiply-add)."""
    return num_edges * feat_dim / seconds
