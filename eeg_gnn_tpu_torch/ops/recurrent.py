"""Operator-stacked DCGRU recurrence with a hand-written BPTT.

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

Backward step (reverse loop; saved: h_seq, ru_seq, c_seq):

    g       = dh_carry + dh_seq[t]
    du      = g*(h_prev - c);  dc = g*(1-u);  dc_pre = dc * act'(c)
    dW_c   += (A (r h_prev))^T dc_pre;   db_c += sum dc_pre
    drh     = sum_m A_m^T (dc_pre W_c_m^T)
    dr      = drh*h_prev
    dru_pre = [dr, du] * ru * (1-ru)
    dW_g   += (A h_prev)^T dru_pre;      db_g += sum dru_pre
    dh_prev = g*u + drh*r + sum_m A_m^T (dru_pre W_g_m^T)
    dgx[t]  = dru_pre;  dcx[t] = dc_pre

:func:`_scan_forward` and :func:`_scan_backward` are those loops in plain
PyTorch: the ``stacked`` recurrence of the model (an autograd Function,
:func:`dcgru_layer_recurrence`) and the plain versions of the
hoisted-input CUDA kernels (``ops/cuda_recurrent.py``). No gradient is
produced for the operators: supports are data, never trained.
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

    a_ops: (M, B or 1, N, N); x: (..., B, N, D) -> (M, ..., B, N, D).
    """
    m, ba, n, _ = a_ops.shape
    lhs = torch.movedim(a_ops, 0, 1).reshape(ba, m * n, n)
    out = torch.matmul(lhs, x)  # (..., B, M*N, D)
    out = out.reshape(*out.shape[:-2], m, n, out.shape[-1])
    return torch.movedim(out, -3, 0)


def _apply_ops_t(a_ops, g):
    """sum_m A_m^T @ g_m: adjoint of :func:`_apply_ops`.

    a_ops: (M, B or 1, N, N); g: (M, ..., B, N, D) -> (..., B, N, D).
    """
    m, ba, n, _ = a_ops.shape
    lhs = torch.movedim(a_ops, 0, 1).reshape(ba, m * n, n)
    rhs = torch.movedim(g, 0, -3)  # (..., B, M, N, D)
    rhs = rhs.reshape(*rhs.shape[:-3], m * n, rhs.shape[-1])
    return torch.matmul(lhs.transpose(-1, -2), rhs)


def _contract_w(feats, w_r):
    """sum_m feats_m @ W_m. feats: (M, B, N, H); w_r: (M, H, O) -> (B,N,O)."""
    return torch.tensordot(feats, w_r, dims=([0, 3], [0, 1]))


def _contract_w_t(g, w_r):
    """Adjoint of :func:`_contract_w` wrt feats: g (B, N, O), w_r (M, H, O)
    -> (M, B, N, H), contracting O."""
    return torch.movedim(torch.tensordot(g, w_r, dims=([2], [2])), 2, 0)


def _weight_grad(feats, g):
    """dW_m = feats_m^T-contraction: feats (M,B,N,H), g (B,N,O) -> (M,H,O)."""
    return torch.tensordot(feats, g, dims=([1, 2], [0, 1]))


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


def _scan_backward(a_ops, wg_r, wc_r, h_prev_seq, ru_seq, c_seq, d_seq,
                   activation: str):
    """The hand-written BPTT: a plain reverse loop over T.

    h_prev_seq (T,B,N,H) = [h0, h_seq[:-1]]; ru_seq, c_seq and d_seq (the
    cotangent of h_seq, the last step's h_last cotangent already added)
    in any float dtype; everything is computed in float32.

    Returns (dgx (T,B,N,2H), dcx (T,B,N,H), dwg (M,H,2H), dwc (M,H,H),
    dbg (2H,), dbc (H,), dh0 (B,N,H)), all float32.
    """
    _, act_grad = _act_pair(activation)
    h_units = wc_r.shape[-1]
    t = d_seq.shape[0]
    dh = torch.zeros(d_seq.shape[1:], dtype=torch.float32,
                     device=d_seq.device)
    dwg = torch.zeros_like(wg_r, dtype=torch.float32)
    dwc = torch.zeros_like(wc_r, dtype=torch.float32)
    dbg = torch.zeros(wg_r.shape[-1], dtype=torch.float32, device=dh.device)
    dbc = torch.zeros(h_units, dtype=torch.float32, device=dh.device)
    dgx = torch.empty(tuple(ru_seq.shape), dtype=torch.float32,
                      device=dh.device)
    dcx = torch.empty(tuple(c_seq.shape), dtype=torch.float32,
                      device=dh.device)
    for ti in reversed(range(t)):
        h_prev = h_prev_seq[ti].float()
        ru = ru_seq[ti].float()
        c = c_seq[ti].float()
        g = dh + d_seq[ti].float()
        r, u = ru[..., :h_units], ru[..., h_units:]

        du = g * (h_prev - c)
        dc_pre = g * (1.0 - u) * act_grad(c)

        rhm = _apply_ops(a_ops, r * h_prev)
        dwc += _weight_grad(rhm, dc_pre)
        dbc += dc_pre.sum(dim=(0, 1))
        drh = _apply_ops_t(a_ops, _contract_w_t(dc_pre, wc_r))

        dru_pre = torch.cat([drh * h_prev, du], dim=-1) * ru * (1.0 - ru)
        hm = _apply_ops(a_ops, h_prev)
        dwg += _weight_grad(hm, dru_pre)
        dbg += dru_pre.sum(dim=(0, 1))
        dh = (g * u + drh * r
              + _apply_ops_t(a_ops, _contract_w_t(dru_pre, wg_r)))
        dgx[ti] = dru_pre
        dcx[ti] = dc_pre
    return dgx, dcx, dwg, dwc, dbg, dbc, dh


def shift_h_prev(h0, h_seq):
    """[h0, h_1 .. h_{T-1}]: each step's incoming state, in h_seq's dtype
    (``pallas_recurrent.py:975-977``)."""
    return torch.cat([h0.to(h_seq.dtype)[None], h_seq[:-1]], dim=0)


class _StackedRecurrence(torch.autograd.Function):
    """The stacked loop with its hand-written BPTT (the JAX package's
    ``custom_vjp`` of ``ops/recurrent.py:161-253``)."""

    @staticmethod
    def forward(ctx, a_ops, gate_x, cand_x, wg_r, wc_r, gate_b, cand_b, h0,
                activation):
        h_last, h_seq, ru_seq, c_seq = _scan_forward(
            a_ops, gate_x, cand_x, wg_r, wc_r, gate_b, cand_b, h0,
            activation)
        ctx.save_for_backward(a_ops, wg_r, wc_r, h0, h_seq, ru_seq, c_seq)
        ctx.activation = activation
        return h_last, h_seq

    @staticmethod
    def backward(ctx, d_last, d_seq):
        a_ops, wg_r, wc_r, h0, h_seq, ru_seq, c_seq = ctx.saved_tensors
        d_seq = torch.zeros_like(h_seq) if d_seq is None else d_seq.clone()
        if d_last is not None:
            d_seq[-1] += d_last
        dgx, dcx, dwg, dwc, dbg, dbc, dh0 = _scan_backward(
            a_ops, wg_r, wc_r, shift_h_prev(h0, h_seq), ru_seq, c_seq,
            d_seq, ctx.activation)
        return None, dgx, dcx, dwg, dwc, dbg, dbc, dh0, None


def dcgru_layer_recurrence(a_ops, gate_x, cand_x, wg_r, wc_r, gate_b,
                           cand_b, h0, activation: str = "tanh"):
    """DCGRU layer recurrence over time with a hand-written BPTT.

    Args:
        a_ops: (M, B or 1, N, N) operator stack (:func:`chebyshev_operators`).
            No gradient is produced for it.
        gate_x: (T, B, N, 2H) input contribution to the gate (no bias).
        cand_x: (T, B, N, H) input contribution to the candidate.
        wg_r: (M, H, 2H); wc_r: (M, H, H) (:func:`rearrange_hidden_weight`).
        gate_b: (2H,); cand_b: (H,); h0: (B, N, H).

    Returns:
        (h_last, h_seq): (B, N, H) and (T, B, N, H), float32.
    """
    return _StackedRecurrence.apply(a_ops, gate_x, cand_x, wg_r, wc_r,
                                    gate_b, cand_b, h0, activation)
