"""Diffusion graph convolution primitives (reference ``model/cell.py:17-118``).

Supports are applied with broadcasting ``torch.matmul``, so one code path
handles a shared (N, N) support, per-clip (B, N, N) supports and extra
leading time axes. The stacked features keep the reference layout
(feature-major, diffusion-order-minor): row ``d*M + m`` of a weight
consumes input feature ``d`` diffused by matrix ``m``.
"""

from __future__ import annotations

import torch


def chebyshev_diffusion(supports, x, max_diffusion_step: int):
    """Stack K-step diffusion features.

    Args:
        supports: (S, ..., N, N) stacked supports; the dims after S must
            broadcast against x's batch dims.
        x: (..., N, D) node features.
        max_diffusion_step: K; 0 returns the identity feature only.

    Returns:
        (..., N, D, M) with M = S*K + 1, in the reference concat order
        (``cell.py:76-96``): [identity, s0@1..s0@K, s1@1..s1@K].

    QUIRK reproduced deliberately (cell.py:83-93): ``x1, x0`` are NOT reset
    between supports, so the second support's recurrence seeds from the
    first support's leftover state. For dual_random_walk K=2 the terms are
    [x, S0 x, 2 S0^2 x - x, S1 S0 x, 2 S1^2 S0 x - S0 x].
    """
    feats = [x]
    if max_diffusion_step > 0:
        x0_, x1_ = x, None
        for s in supports:
            x1_ = torch.matmul(s, x0_)
            feats.append(x1_)
            for _ in range(2, max_diffusion_step + 1):
                x2 = 2.0 * torch.matmul(s, x1_) - x0_
                feats.append(x2)
                x1_, x0_ = x2, x1_
    return torch.stack(feats, dim=-1)


def diffusion_conv(supports, x, weight, bias, max_diffusion_step: int):
    """Diffuse -> flatten (d-major) -> GEMM + bias (reference
    ``DiffusionGraphConv.forward``, model/cell.py:66-118).

    weight: (D*M, out) in reference layout; bias: (out,). -> (..., N, out).
    """
    stacked = chebyshev_diffusion(supports, x, max_diffusion_step)
    flat = stacked.reshape(*stacked.shape[:-2], -1)
    return torch.matmul(flat, weight) + bias
