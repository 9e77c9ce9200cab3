"""Spectral graph supports for diffusion convolution.

Two implementations of the same math, as in the JAX package:

- host numpy (float64) oracles for a single adjacency (reference
  ``utils.py:205-255``);
- batched torch (float32) twins that build per-clip supports on the
  device the adjacency lives on.

Support families (reference ``data/dataloader_detection.py:335-354``):

- ``laplacian``        -> [scaled Laplacian (2/lmax)*L - I] (ChebNet)
- ``random_walk``      -> [(D^-1 A)^T]
- ``dual_random_walk`` -> [(D^-1 A)^T, (D^-1 A^T)^T]

The random-walk supports are emitted transposed so that left
multiplication by a support aggregates over in-neighbours.
"""

from __future__ import annotations

import numpy as np
import torch

FILTER_NUM_SUPPORTS = {
    "laplacian": 1,
    "random_walk": 1,
    "dual_random_walk": 2,
}


def num_supports_for(filter_type: str) -> int:
    """Number of support matrices for a filter type (reference cell.py:151-158)."""
    return FILTER_NUM_SUPPORTS.get(filter_type, 1)


# ---------------------------------------------------------------------------
# Host (numpy, float64) implementations
# ---------------------------------------------------------------------------


def normalized_laplacian(adj: np.ndarray) -> np.ndarray:
    """L = I - D^-1/2 A^T D^-1/2 with D = diag(A 1) (reference utils.py:205-217,
    including its transpose of A for asymmetric inputs)."""
    adj = np.asarray(adj, dtype=np.float64)
    d = adj.sum(axis=1)
    with np.errstate(divide="ignore"):
        d_inv_sqrt = np.power(d, -0.5)
    d_inv_sqrt[np.isinf(d_inv_sqrt)] = 0.0
    n = adj.shape[0]
    return np.eye(n) - (adj * d_inv_sqrt[None, :]).T * d_inv_sqrt[None, :]


def scaled_laplacian(adj: np.ndarray, lambda_max=2, undirected: bool = True) -> np.ndarray:
    """Chebyshev-scaled Laplacian (2/lmax) L - I (reference utils.py:240-255);
    ``lambda_max=None`` computes the largest eigenvalue exactly."""
    adj = np.asarray(adj, dtype=np.float64)
    if undirected:
        adj = np.maximum(adj, adj.T)
    L = normalized_laplacian(adj)
    if lambda_max is None:
        lambda_max = float(np.linalg.eigvalsh((L + L.T) / 2.0)[-1])
    n = L.shape[0]
    return (2.0 / lambda_max) * L - np.eye(n)


def random_walk(adj: np.ndarray) -> np.ndarray:
    """Row-normalized transition matrix D^-1 A (reference utils.py:220-230)."""
    adj = np.asarray(adj, dtype=np.float64)
    d = adj.sum(axis=1)
    with np.errstate(divide="ignore"):
        d_inv = np.power(d, -1.0)
    d_inv[np.isinf(d_inv)] = 0.0
    return d_inv[:, None] * adj


def compute_supports(adj: np.ndarray, filter_type: str, dtype=np.float32):
    """List of support matrices for a single adjacency (reference
    data/dataloader_detection.py:335-354)."""
    if filter_type == "laplacian":
        sup = [scaled_laplacian(adj, lambda_max=None)]
    elif filter_type == "random_walk":
        sup = [random_walk(adj).T]
    elif filter_type == "dual_random_walk":
        sup = [random_walk(adj).T, random_walk(adj.T).T]
    else:
        sup = [scaled_laplacian(adj)]
    return [np.asarray(s, dtype=dtype) for s in sup]


# ---------------------------------------------------------------------------
# Batched torch implementations (any leading batch dims, on adj's device)
# ---------------------------------------------------------------------------


def _bcast_diag_scale(adj: torch.Tensor, d_pow: float) -> torch.Tensor:
    """Row-sum -> elementwise power with 0 where the row sum is not positive."""
    d = adj.sum(dim=-1)
    pos = d > 0
    return torch.where(pos, torch.where(pos, d, torch.ones_like(d)).pow(d_pow),
                       torch.zeros_like(d))


def normalized_laplacian_torch(adj: torch.Tensor) -> torch.Tensor:
    """Batched L = I - D^-1/2 A^T D^-1/2 over the leading dims of ``adj``."""
    inv_sqrt = _bcast_diag_scale(adj, -0.5)
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=adj.dtype, device=adj.device)
    scaled = (adj * inv_sqrt[..., None, :]).transpose(-1, -2) \
        * inv_sqrt[..., None, :]
    return eye - scaled


def scaled_laplacian_torch(adj: torch.Tensor, lambda_max=None,
                           undirected: bool = True) -> torch.Tensor:
    """Batched Chebyshev-scaled Laplacian; exact lmax from ``eigvalsh`` of
    the symmetrised L in float32."""
    if undirected:
        adj = torch.maximum(adj, adj.transpose(-1, -2))
    L = normalized_laplacian_torch(adj)
    n = L.shape[-1]
    if lambda_max is None:
        sym = (L + L.transpose(-1, -2)) / 2.0
        lambda_max = torch.linalg.eigvalsh(sym.float())[..., -1][..., None, None]
        lambda_max = lambda_max.to(L.dtype)
    return (2.0 / lambda_max) * L - torch.eye(n, dtype=L.dtype, device=L.device)


def random_walk_torch(adj: torch.Tensor) -> torch.Tensor:
    """Batched row-normalized transition matrix D^-1 A."""
    return _bcast_diag_scale(adj, -1.0)[..., :, None] * adj


def compute_supports_torch(adj: torch.Tensor, filter_type: str) -> torch.Tensor:
    """Batched supports: (S, ..., N, N) stacked along a new axis 0."""
    if filter_type == "laplacian":
        sups = [scaled_laplacian_torch(adj, lambda_max=None)]
    elif filter_type == "random_walk":
        sups = [random_walk_torch(adj).transpose(-1, -2)]
    elif filter_type == "dual_random_walk":
        sups = [random_walk_torch(adj).transpose(-1, -2),
                random_walk_torch(adj.transpose(-1, -2)).transpose(-1, -2)]
    else:
        sups = [scaled_laplacian_torch(adj, lambda_max=2.0)]
    return torch.stack(sups, dim=0)
