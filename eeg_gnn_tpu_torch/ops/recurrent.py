"""Operator-stacked DCGRU recurrence, forward half.

The diffusion conv is linear in its input, so the K-step Chebyshev
recurrence over supports (including the cross-support carry-over quirk of
``ops/diffusion.py``) collapses once per batch into operators
``A_m = cheb_m(supports) @ I``:

    feats_m(x) = A_m @ x          for m = 0..M-1  (A_0 = I)
    conv(x)    = sum_m (A_m @ x) @ W_m + b

with ``W_m`` the (H, O) block of the reference-layout weight rows
``h*M + m``. Forward step (state h, input projections gx/cx computed
outside the loop by ``models/dcgru.py``):

    ru  = sigmoid(gx[t] + sum_m A_m h W^g_m + b_g);  r, u = split(ru)
    c   = act(cx[t] + sum_m A_m (r*h) W^c_m + b_c)
    h'  = u*h + (1-u)*c

:func:`_scan_forward` is that loop in plain PyTorch: the ``stacked``
recurrence of the model and the plain version of the hoisted-input CUDA
kernel (``ops/cuda_recurrent.py``). The hand-written BPTT comes with the
training slice.
"""

from __future__ import annotations

import torch

from eeg_gnn_tpu_torch.ops.diffusion import chebyshev_diffusion


def chebyshev_operators(supports, max_diffusion_step: int):
    """Collapse the Chebyshev recurrence into an operator stack.

    supports: (S, B, N, N) or (S, N, N) -> (M, B, N, N) or (M, N, N) with
    M = S*K + 1 (A_0 = I), ordering and carry-over as
    :func:`chebyshev_diffusion`.
    """
    n = supports.shape[-1]
    eye = torch.eye(n, dtype=supports.dtype, device=supports.device)
    eye = eye.expand(supports.shape[1:])
    stacked = chebyshev_diffusion(supports, eye, max_diffusion_step)
    return torch.movedim(stacked, -1, 0)


def rearrange_hidden_weight(w, num_units: int, num_matrices: int):
    """Reference hidden-rows weight (H*M, O), row = h*M + m -> (M, H, O)."""
    return w.reshape(num_units, num_matrices, -1).transpose(0, 1)


def _apply_ops(a_ops, x):
    """feats_m = A_m @ x for all m in one batched matmul.

    a_ops: (M, B or 1, N, N); x: (B, N, D) -> (M, B, N, D).
    """
    m, ba, n, _ = a_ops.shape
    b = x.shape[0]
    lhs = torch.movedim(a_ops, 0, 1).reshape(ba, m * n, n)
    out = torch.matmul(lhs, x)  # (B, M*N, D)
    return torch.movedim(out.reshape(b, m, n, -1), 1, 0)


def _contract_w(feats, w_r):
    """sum_m feats_m @ W_m. feats: (M, B, N, H); w_r: (M, H, O) -> (B,N,O)."""
    return torch.tensordot(feats, w_r, dims=([0, 3], [0, 1]))


def _act_pair(name: str):
    """(activation, derivative as a function of the activation's output)."""
    if name in (None, "tanh"):
        return torch.tanh, lambda c: 1.0 - c * c
    if name == "relu":
        return torch.relu, lambda c: (c > 0).to(c.dtype)
    if name == "linear":
        return (lambda x: x), torch.ones_like
    raise ValueError(f"unknown activation {name!r}")


def _scan_forward(a_ops, gate_x, cand_x, wg_r, wc_r, gate_b, cand_b, h0,
                  activation: str, residual_dtype=torch.float32):
    """Plain loop over T. gate_x (T,B,N,2H) / cand_x (T,B,N,H) in f32.

    Returns (h_last, h_seq, ru_seq, c_seq); h_seq in f32, ru/c in
    ``residual_dtype``.
    """
    act, _ = _act_pair(activation)
    h_units = h0.shape[-1]
    t = gate_x.shape[0]
    h = h0
    h_seq = torch.empty((t,) + tuple(h0.shape), dtype=torch.float32,
                        device=h0.device)
    ru_seq = torch.empty(tuple(gate_x.shape), dtype=residual_dtype,
                         device=h0.device)
    c_seq = torch.empty(tuple(cand_x.shape), dtype=residual_dtype,
                        device=h0.device)
    for ti in range(t):
        ru = torch.sigmoid(gate_x[ti] + _contract_w(_apply_ops(a_ops, h), wg_r)
                           + gate_b)
        r, u = ru[..., :h_units], ru[..., h_units:]
        c = act(cand_x[ti] + _contract_w(_apply_ops(a_ops, r * h), wc_r)
                + cand_b)
        h = u * h + (1.0 - u) * c
        h_seq[ti] = h
        ru_seq[ti] = ru
        c_seq[ti] = c
    return h, h_seq, ru_seq, c_seq


def dcgru_layer_recurrence(a_ops, gate_x, cand_x, wg_r, wc_r, gate_b,
                           cand_b, h0, activation: str = "tanh"):
    """DCGRU layer recurrence over time on an operator stack (forward).

    Args:
        a_ops: (M, B or 1, N, N) operator stack (:func:`chebyshev_operators`).
        gate_x: (T, B, N, 2H) input contribution to the gate (no bias).
        cand_x: (T, B, N, H) input contribution to the candidate.
        wg_r: (M, H, 2H); wc_r: (M, H, H) (:func:`rearrange_hidden_weight`).
        gate_b: (2H,); cand_b: (H,); h0: (B, N, H).

    Returns:
        (h_last, h_seq): (B, N, H) and (T, B, N, H), float32.
    """
    h_last, h_seq, _, _ = _scan_forward(a_ops, gate_x, cand_x, wg_r, wc_r,
                                        gate_b, cand_b, h0, activation)
    return h_last, h_seq
