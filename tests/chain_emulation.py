"""The arithmetic of the state-loop kernels with bf16 streams, the
encoder's (``csrc/dcgru_recurrence.cu``, ``csrc/dcgru_recurrence_bwd.cu``)
and the seq2seq decoder's (``csrc/dcgru_decoder.cu``), in plain PyTorch on
any device: every weight product takes bf16 operands (the diffused
features or the cotangent, and the weights, rounded to nearest) with f32
sums; the diffusions, the A^T applies, the gates, the state and its
cotangent stay f32. Imports neither JAX nor the JAX package, so the
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


def _cells(a, d, h_units, num_layers, layer0, shared):
    """Per layer (wxg, wxc, wg, wc, bg, bc): the weights as bf16 operands,
    (M, Din, O), the biases as they are; layers >= 1 share one cell."""
    m = a.shape[0]

    def cell(w, d_in):
        wxg, wxc, wg, wc, bg, bc = w
        r = lambda v, k: bf16_operand(v).reshape(m, k, -1)
        return (r(wxg, d_in), r(wxc, d_in), r(wg, h_units), r(wc, h_units),
                bg, bc)
    tied = [cell(shared, h_units)] * (num_layers - 1) if num_layers > 1 \
        else []
    return [cell(layer0, d)] + tied


def dec_chain_fwd(a, x_seq, force, wx0g, wx0c, wh0g, wh0c, b0g, b0c, wxsg,
                  wxsc, whsg, whsc, bsg, bsc, wp, bp, h0_stack, num_layers,
                  activation="tanh", out_dtype=None):
    """The decoder's forward loop (arguments as ``dcgru_decoder_fwd``):
    (proj, in0, h_seq, ru_seq, c_seq) in ``out_dtype`` (by default the
    stream dtype), the residuals layer-major. Every cell product and the projection take bf16
    operands; the feedback uses the f32 projection."""
    act, _ = _act_pair(activation)
    t, b, n, d = x_seq.shape
    h_units = h0_stack.shape[-1]
    cells = _cells(a, d, h_units, num_layers,
                   (wx0g, wx0c, wh0g, wh0c, b0g, b0c),
                   (wxsg, wxsc, whsg, whsc, bsg, bsc))
    wp = bf16_operand(wp)
    h = list(h0_stack.float().unbind(0))
    inp = torch.zeros((b, n, d), device=x_seq.device)
    out = {k: [] for k in ("proj", "in0", "h", "ru", "c")}
    for ti in range(t):
        out["in0"].append(inp)
        x, step = inp, {"h": [], "ru": [], "c": []}
        for li, (wxg, wxc, wg, wc, bg, bc) in enumerate(cells):
            xf = bf16_operand(_apply_ops(a, x))
            ru = torch.sigmoid(_contract_w(bf16_operand(_apply_ops(a, h[li])),
                                           wg) + _contract_w(xf, wxg) + bg)
            r, u = ru[..., :h_units], ru[..., h_units:]
            c = act(_contract_w(bf16_operand(_apply_ops(a, r * h[li])), wc)
                    + _contract_w(xf, wxc) + bc)
            h[li] = x = u * h[li] + (1.0 - u) * c
            for k, v in (("h", x), ("ru", ru), ("c", c)):
                step[k].append(v)
        proj = torch.matmul(bf16_operand(x), wp) + bp
        out["proj"].append(proj)
        for k, v in step.items():
            out[k].append(torch.stack(v))
        inp = force[ti] * x_seq[ti].float() + (1.0 - force[ti]) * proj
    return tuple(torch.stack(out[k], dim=1 if k in ("h", "ru", "c") else 0)
                 .to(out_dtype or x_seq.dtype)
                 for k in ("proj", "in0", "h", "ru", "c"))


def dec_chain_bwd(a, wx0g, wx0c, wh0g, wh0c, wxsg, wxsc, whsg, whsc, wp,
                  h_prev, ru_seq, c_seq, d_seq, force, num_layers,
                  activation="tanh", out_dtype=None):
    """The decoder's backward state loop (arguments as
    ``dcgru_dec_bwd_loop``): (dx in ``out_dtype``, by default the stream
    dtype; dh0, dpre, dproj f32). The products dproj Wp^T, dc_pre Wc^T, dru_pre
    Wg^T and the input's [dru_pre | dc_pre] [Wxg | Wxc]^T take bf16
    operands, the last one A^T apply for both halves of the input
    cotangent, as the kernel sums it."""
    _, act_grad = _act_pair(activation)
    ll, t, b, n, h_units = h_prev.shape
    d = d_seq.shape[-1]
    zeros = torch.zeros(2 * h_units)
    cells = _cells(a, d, h_units, ll, (wx0g, wx0c, wh0g, wh0c, zeros, zeros),
                   (wxsg, wxsc, whsg, whsc, zeros, zeros))
    wp = bf16_operand(wp)
    dev = d_seq.device
    dpre = torch.empty((ll, t, b, n, 3 * h_units), device=dev)
    dproj = torch.empty((t, b, n, d), device=dev)
    dx = torch.empty(d_seq.shape, dtype=out_dtype or d_seq.dtype, device=dev)
    dh = [torch.zeros((b, n, h_units), device=dev) for _ in range(ll)]
    din = torch.zeros((b, n, d), device=dev)
    for ti in reversed(range(t)):
        f = force[ti]
        dproj[ti] = d_seq[ti].float() + (1.0 - f) * din
        dx[ti] = f * din
        dcur = torch.matmul(bf16_operand(dproj[ti]), wp.t())
        for li in reversed(range(ll)):
            wxg, wxc, wg, wc, _, _ = cells[li]
            hp, ru = h_prev[li, ti].float(), ru_seq[li, ti].float()
            c = c_seq[li, ti].float()
            r, u = ru[..., :h_units], ru[..., h_units:]
            g = dh[li] + dcur
            dc = g * (1.0 - u) * act_grad(c)
            du = g * (hp - c) * u * (1.0 - u)
            drh = _apply_ops_t(a, _contract_w_t(bf16_operand(dc), wc))
            dru = torch.cat([drh * hp * r * (1.0 - r), du], dim=-1)
            dh[li] = (g * u + drh * r
                      + _apply_ops_t(a, _contract_w_t(bf16_operand(dru), wg)))
            pre = torch.cat([dru, dc], dim=-1)
            dpre[li, ti] = pre
            dinp = _apply_ops_t(a, _contract_w_t(
                bf16_operand(pre), torch.cat([wxg, wxc], dim=-1)))
            if li == 0:
                din = dinp
            else:
                dcur = dinp
    return dx, torch.stack(dh), dpre, dproj


def dw_chain(a, h_prev, ru_seq, x, dpre, bf16=True):
    """The bulk dW kernel's arithmetic (``csrc/dcgru_xin_gemm.cu``,
    ``xin_dw_kernel``) summed over every (t, b) pair: G_m = A_m^T dpre per
    clip, then dW_m = [x | h_prev | r h_prev]^T G_m and db = sum dpre.
    With ``bf16`` the diffusion takes bf16 A_m^T and dpre with f32 sums,
    G_m and r h_prev are rounded to bf16, and the products sum in f32;
    without, everything is f32 (the kernel's 3xTF32). Returns the flat
    slab [dWxg | dWxc | dWg | dWc | dbg | dbc]."""
    rnd = bf16_operand if bf16 else (lambda v: v.float())
    h_units = h_prev.shape[-1]
    g = rnd(_apply_ops(rnd(a.transpose(-1, -2)), rnd(dpre)))
    h = h_prev.float()
    rh = rnd(ru_seq.float()[..., :h_units] * h)
    prod = lambda f, gm: torch.einsum("tbni,mtbnj->mij", f, gm)
    dwx = prod(x.float(), g)
    dwx = dwx.reshape(-1, dwx.shape[-1])
    return torch.cat([
        dwx[:, :2 * h_units].reshape(-1), dwx[:, 2 * h_units:].reshape(-1),
        prod(h, g[..., :2 * h_units]).reshape(-1),
        prod(rh, g[..., 2 * h_units:]).reshape(-1),
        dpre.float().sum(dim=(0, 1, 2))])


def proj_chain(a, x, wx, bf16=True):
    """The bulk projection kernel's arithmetic (``csrc/dcgru_xin_gemm.cu``,
    ``xin_bulk_kernel``): F_m = A_m x per clip (F_0 = x), then
    XP = sum_m F_m Wx_m in f32. With ``bf16`` the diffusion takes bf16 A_m
    and x with f32 sums, F_m is rounded to bf16 and Wx_m is bf16; without,
    everything is f32 (the kernel's 3xTF32). x (T, B, N, D), wx (M*D,
    3H) -> XP (T, B, N, 3H) f32."""
    rnd = bf16_operand if bf16 else (lambda v: v.float())
    m = a.shape[0]
    f = rnd(_apply_ops(rnd(a), rnd(x.float())))
    w = rnd(wx).reshape(m, x.shape[-1], -1)
    return torch.einsum("mtbnd,mdc->tbnc", f, w)


def dx_chain(a, wx, dpre, dtype, bf16=True):
    """The bulk dx kernel's arithmetic: G_m = A_m^T dpre per clip
    (G_0 = dpre), then dx = sum_m G_m Wx_m^T in f32, cast to ``dtype``.
    With ``bf16`` the diffusion takes bf16 A_m^T and dpre with f32 sums,
    G_m is rounded to bf16 and Wx_m is bf16; without, f32. wx (M*D, 3H),
    dpre (T, B, N, 3H) -> dx (T, B, N, D)."""
    rnd = bf16_operand if bf16 else (lambda v: v.float())
    m = a.shape[0]
    g = rnd(_apply_ops(rnd(a.transpose(-1, -2)), rnd(dpre)))
    w = rnd(wx).reshape(m, wx.shape[0] // m, -1)
    return torch.einsum("mtbnj,mdj->tbnd", g, w).to(dtype)
