"""The correlation ("individual") graph in float64, in plain PyTorch: the
benchmark's reference for the Corr-DCRNN's per-clip graphs.

It follows the published graph (github.com/tsy935/eeg-gnn-ssl,
``data/dataloader_detection.py:258-307``, ``data/data_utils.py:174-222``):
each pair of a clip's channels, flattened over time and features, gives
its zero-lag cross-correlation normalized by the two signals' norms (no
mean removed); the absolute value; each node keeps its ``top_k`` largest
off-diagonal neighbours (directed) and the diagonal. Then the dual random
walk (``dcrnn.supports``) of each clip's graph.

The near-tie rule. Rounding can reorder two neighbours whose |corr| lie
closer than the rounding: where a node's k-th and (k+1)-th float64
|corr| lie within ``tie_bound`` of each other, the node's top-k may be
any k of the columns around the cut, and the reference takes the
program's choice there if it keeps every column above the band and
takes the rest from the band. Everywhere else, and where the program's
choice breaks that, the reference keeps its own top-k.

It imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import dcrnn


def abs_correlation(feats: torch.Tensor, precision: str = "f64"
                    ) -> torch.Tensor:
    """(B, T, N, D) clips -> (B, N, N) |corr| with a unit diagonal, in
    float64 (``f64``) or with the Gram's operands rounded to TF32 and
    float32 sums (``tf32``, the control)."""
    b, t, n, d = feats.shape
    flat = feats.transpose(1, 2).reshape(b, n, t * d)
    if precision == "f64":
        flat = flat.double()
        gram = torch.matmul(flat, flat.transpose(1, 2))
    elif precision == "tf32":
        r = dcrnn.tf32_round(flat.float())
        gram = torch.matmul(r, r.transpose(1, 2))
        flat = flat.float()
    else:
        raise ValueError(f"unknown precision {precision!r}")
    energy = (flat * flat).sum(dim=-1)
    denom = torch.sqrt(energy[:, :, None] * energy[:, None, :])
    corr = torch.where(denom > 0, gram / torch.where(denom > 0, denom,
                                                     torch.ones_like(denom)),
                       gram).abs()
    eye = torch.eye(n, dtype=torch.bool, device=feats.device)
    return torch.where(eye, torch.ones_like(corr), corr)


def _off_diagonal(corr: torch.Tensor) -> torch.Tensor:
    n = corr.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=corr.device)
    return torch.where(eye, torch.full_like(corr, -float("inf")), corr)


def top_k_mask(corr: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, N) bool: each row's k largest off-diagonal entries (the
    lowest column first on an exact tie)."""
    idx = torch.sort(_off_diagonal(corr), dim=-1, descending=True,
                     stable=True).indices[..., :k]
    return torch.zeros_like(corr, dtype=torch.bool).scatter_(-1, idx, True)


def margins(corr: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N): each node's k-th less its (k+1)-th largest off-diagonal
    |corr|."""
    v = torch.sort(_off_diagonal(corr), dim=-1, descending=True).values
    return v[..., k - 1] - v[..., k]


def resolve_ties(corr: torch.Tensor, k: int, tie_bound: float,
                 choice: torch.Tensor):
    """The reference's top-k under the near-tie rule.

    ``corr`` (B, N, N) float64 |corr|; ``choice`` (B, N, N) bool, the
    program's kept off-diagonal neighbours (no diagonal). Returns (mask (B, N, N) bool,
    near (B, N) bool: the near-tie nodes, taken (B, N) bool: the nodes
    whose top-k is the program's choice and differs from float64's)."""
    own = top_k_mask(corr, k)
    off = _off_diagonal(corr)
    v = torch.sort(off, dim=-1, descending=True).values
    kth, next_ = v[..., k - 1:k], v[..., k:k + 1]
    near = (kth - next_)[..., 0] <= tie_bound
    above = off > kth + tie_bound
    band = (off >= next_ - tie_bound) & ~above
    fits = ((choice.sum(-1) == k) & (above & ~choice).sum(-1).eq(0)
            & (choice & ~above & ~band).sum(-1).eq(0))
    take = near & fits
    mask = torch.where(take[..., None], choice, own)
    return mask, near, take & (choice != own).any(-1)


def adjacency(corr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The kept entries of ``corr`` and its diagonal."""
    eye = torch.eye(corr.shape[-1], dtype=torch.bool, device=corr.device)
    return torch.where(mask | eye, corr, torch.zeros_like(corr))


def supports(adj: torch.Tensor) -> torch.Tensor:
    """(B, N, N) graphs -> (2, B, N, N) float32 dual random walks, each
    clip's in float64 NumPy (``dcrnn.supports``)."""
    a = adj.detach().double().cpu().numpy()
    sup = np.stack([dcrnn.supports(g, "dual_random_walk") for g in a],
                   axis=1)
    return torch.from_numpy(sup).to(adj.device)


class PerBatch:
    """Supports that follow the step being trained: iterating yields the
    current batch's (B, N, N) slabs, one a support, as ``dcrnn``'s
    diffusion iterates a shared (S, N, N) stack. :meth:`follow` walks the
    batches and moves the current one, so ``train.train_readings`` trains
    each batch on its own clips' graphs."""

    def __init__(self, sups: list):
        self.sups = sups
        self.i = 0

    def __iter__(self):
        return iter(self.sups[self.i])

    def follow(self, batches: list):
        for i, batch in enumerate(batches):
            self.i = i
            yield batch
