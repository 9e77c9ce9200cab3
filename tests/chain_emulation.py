"""The arithmetic of the encoder's state-loop kernels with bf16 streams
(``csrc/dcgru_recurrence.cu``, ``csrc/dcgru_recurrence_bwd.cu``), in plain
PyTorch on any device: every hidden product takes bf16 operands (the
diffused features or the cotangent, and the weights, rounded to nearest)
with f32 sums; the diffusions, the A^T applies, the gates, the state and
its cotangent stay f32. Imports neither JAX nor the JAX package, so the
card's tests use it too."""

import torch

from eeg_gnn_tpu_torch.ops.recurrent import (
    _act_pair,
    _apply_ops,
    _apply_ops_t,
    _contract_w,
    _contract_w_t,
)


def bf16_operand(v):
    """A tensor-core bf16 operand: rounded to nearest, used in f32."""
    return v.to(torch.bfloat16).float()


def chain_fwd(xp, a, wg, wc, bg, bc, h0, stream, activation="tanh"):
    """The forward loop fed the f32 projection xp (T, B, N, 3H): h_seq,
    ru_seq, c_seq in the stream dtype."""
    act, _ = _act_pair(activation)
    h_units = h0.shape[-1]
    wg, wc = bf16_operand(wg), bf16_operand(wc)
    h, out = h0, ([], [], [])
    for t in range(xp.shape[0]):
        ru = torch.sigmoid(_contract_w(bf16_operand(_apply_ops(a, h)), wg)
                           + bg + xp[t, ..., :2 * h_units])
        r, u = ru[..., :h_units], ru[..., h_units:]
        c = act(_contract_w(bf16_operand(_apply_ops(a, r * h)), wc) + bc
                + xp[t, ..., 2 * h_units:])
        h = u * h + (1.0 - u) * c
        for seq, v in zip(out, (h, ru, c)):
            seq.append(v.to(stream))
    return tuple(torch.stack(s) for s in out)


def chain_bwd(a, wg, wc, h_prev, ru_seq, c_seq, d_seq, activation="tanh"):
    """The backward loop: (dpre (T, B, N, 3H) f32, dh0 f32)."""
    _, act_grad = _act_pair(activation)
    h_units = wc.shape[-1]
    wg, wc = bf16_operand(wg), bf16_operand(wc)
    dh = torch.zeros(d_seq.shape[1:], device=d_seq.device)
    dpre = torch.empty(d_seq.shape[:-1] + (3 * h_units,),
                       device=d_seq.device)
    for t in reversed(range(d_seq.shape[0])):
        hp, ru, c = h_prev[t].float(), ru_seq[t].float(), c_seq[t].float()
        r, u = ru[..., :h_units], ru[..., h_units:]
        g = dh + d_seq[t].float()
        dc = g * (1.0 - u) * act_grad(c)
        du = g * (hp - c) * u * (1.0 - u)
        drh = _apply_ops_t(a, _contract_w_t(bf16_operand(dc), wc))
        dru = torch.cat([drh * hp * r * (1.0 - r), du], dim=-1)
        dh = (g * u + drh * r
              + _apply_ops_t(a, _contract_w_t(bf16_operand(dru), wg)))
        dpre[t] = torch.cat([dru, dc], dim=-1)
    return dpre, dh
