"""Correlation ("individual") graph construction, as
``eeg_gnn_tpu/graphs/xcorr.py``.

The reference builds a per-clip graph from the pairwise zero-lag
normalized cross-correlation of the flattened clip signals, one
``scipy.signal.correlate`` call per pair (reference
``data/dataloader_detection.py:258-307``, ``data/data_utils.py:174-222``).
Zero-lag 'valid' cross-correlation of equal-length signals is a dot
product and its normalization ``sqrt(cxx0 * cyy0)`` the product of the
signal norms, so the whole adjacency is one normalized Gram matrix
``|X X^T| / (||x_i|| ||x_j||)``.

Two implementations of the same math:

- host numpy oracles that follow the reference loop (float64), including
  its degenerate zero-energy case and the swap quirk;
- batched torch versions (float32) on the clip's device. The Gram is one
  ``torch.matmul`` in full float32 (TF32 off), as the JAX package asks for
  ``HIGHEST`` precision: top-k is sensitive to near-ties.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Top-k sparsification
# ---------------------------------------------------------------------------


def keep_topk(adj_mat: np.ndarray, top_k: int = 3,
              directed: bool = True) -> np.ndarray:
    """Keep the top-k off-diagonal neighbours per row (plus the diagonal).

    Parity: reference ``data/data_utils.py:174-200``: the diagonal is left
    out of the ranking but always kept in the mask.
    """
    adj = np.asarray(adj_mat)
    no_self = adj.copy()
    np.fill_diagonal(no_self, 0)
    top_k_idx = (-no_self).argsort(axis=-1)[:, :top_k]
    mask = np.eye(adj.shape[0], dtype=bool)
    rows = np.repeat(np.arange(adj.shape[0]), top_k)
    mask[rows, top_k_idx.reshape(-1)] = True
    if not directed:
        mask[top_k_idx.reshape(-1), rows] = True
    return mask * adj


def keep_topk_torch(adj: torch.Tensor, top_k: int = 3,
                    directed: bool = True) -> torch.Tensor:
    """Batched top-k sparsification over the leading dims of ``adj``.

    Ties go to the lowest column index, as ``jax.lax.top_k`` gives them in
    ``keep_topk_jnp``: a stable descending sort (``torch.topk`` does not
    promise that order on CUDA)."""
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=adj.device)
    no_self = torch.where(eye, torch.zeros((), dtype=adj.dtype,
                                           device=adj.device), adj)
    idx = torch.sort(no_self, dim=-1, descending=True,
                     stable=True).indices[..., :top_k]
    sel = torch.zeros(adj.shape, dtype=torch.bool, device=adj.device)
    sel.scatter_(-1, idx, True)
    mask = sel | eye
    if not directed:
        mask = mask | sel.transpose(-1, -2)
    return torch.where(mask, adj, torch.zeros((), dtype=adj.dtype,
                                              device=adj.device))


# ---------------------------------------------------------------------------
# Correlation adjacency
# ---------------------------------------------------------------------------


def comp_xcorr_zero_lag(x: np.ndarray, y: np.ndarray,
                        normalize: bool = True) -> float:
    """Zero-lag 'valid' cross-correlation of two equal-length 1-D signals
    (reference ``data/data_utils.py:203-222``; normalization as MATLAB's
    xcorr, skipped when either signal has zero energy)."""
    xcorr = float(np.dot(x, y))
    cxx0 = float(np.sum(np.abs(x) ** 2))
    cyy0 = float(np.sum(np.abs(y) ** 2))
    if normalize and cxx0 != 0 and cyy0 != 0:
        xcorr /= (cxx0 * cyy0) ** 0.5
    return xcorr


def correlation_adjacency(eeg_clip: np.ndarray, top_k: Optional[int] = 3,
                          swap_nodes=None,
                          apply_swap: bool = False) -> np.ndarray:
    """Host oracle of one clip's correlation adjacency.

    Args:
        eeg_clip: (seq_len, num_nodes, input_dim) clip features.
        top_k: neighbours kept per node (None: dense).
        swap_nodes: reflection-augmentation index pairs.
        apply_swap: QUIRK: in the reference ``swap_nodes`` only remaps a
            dict that is never read again (``dataloader_detection.py:
            278-291``), so the default False has the reference's observable
            behaviour (no effect); True applies the intended permutation.

    Returns:
        (num_nodes, num_nodes) float32 adjacency with unit diagonal.
    """
    n = eeg_clip.shape[1]
    flat = np.transpose(np.asarray(eeg_clip, dtype=np.float64),
                        (1, 0, 2)).reshape(n, -1)
    if apply_swap and swap_nodes is not None:
        perm = np.arange(n)
        for a, b in swap_nodes:
            perm[a], perm[b] = perm[b], perm[a]
        flat = flat[perm]
    adj = np.eye(n, dtype=np.float64)
    for i in range(n):
        for j in range(i + 1, n):
            v = comp_xcorr_zero_lag(flat[i], flat[j], normalize=True)
            adj[i, j] = v
            adj[j, i] = v
    adj = np.abs(adj)
    if top_k is not None:
        adj = keep_topk(adj, top_k=top_k, directed=True)
    return adj.astype(np.float32)


@contextlib.contextmanager
def full_f32_matmul():
    """float32 matrix products in full float32 (TF32 off) inside the
    block, whatever the caller set; restored after."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def correlation_adjacency_torch(eeg_clip: torch.Tensor,
                                top_k: Optional[int] = 3) -> torch.Tensor:
    """Batched correlation adjacency as one normalized Gram product.

    Args:
        eeg_clip: (..., seq_len, num_nodes, input_dim) clip features.
        top_k: neighbours kept per node (None: dense).

    Returns:
        (..., num_nodes, num_nodes) float32 adjacency, unit diagonal: the
        zero-lag normalized xcorr Gram, abs, directed top-k with the
        diagonal kept (``correlation_adjacency_jnp``).
    """
    n = eeg_clip.shape[-2]
    flat = eeg_clip.transpose(-3, -2).reshape(*eeg_clip.shape[:-3], n, -1)
    flat = flat.float()
    with full_f32_matmul():
        gram = torch.matmul(flat, flat.transpose(-1, -2))
    energy = (flat * flat).sum(dim=-1)
    denom = torch.sqrt(energy[..., :, None] * energy[..., None, :])
    # the reference skips normalization when a signal has zero energy; the
    # diagonal it pins to 1
    pos = denom > 0
    normed = torch.where(pos, gram / torch.where(pos, denom,
                                                 torch.ones_like(denom)),
                         gram)
    eye = torch.eye(n, dtype=torch.bool, device=flat.device)
    adj = torch.where(eye, torch.ones_like(normed), normed).abs()
    if top_k is not None:
        adj = keep_topk_torch(adj, top_k=top_k, directed=True)
    return adj
