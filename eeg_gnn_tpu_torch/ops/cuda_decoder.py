"""Whole-sequence DCGRU seq2seq decoder: CUDA kernels, their wrappers,
their plain PyTorch versions, and the autograd Function built on them.

The counterpart of the JAX package's ``ops/pallas_decoder.py``. Kernels of
``csrc/dcgru_decoder.cu`` replace its Pallas kernels:

- :func:`dcgru_decoder_fwd` <- ``_fwd_kernel_dec``: every step's L DCGRU
  cells (layer 0 at the output width D, layers >= 1 one shared cell, the
  reference's tied-weight quirk), the output projection and the
  scheduled-sampling feedback select by the per-step force ``f_t``;
- :func:`dcgru_decoder_bwd` <- ``_bwd_kernel_dec``: its BPTT, which
  launches no kernel of its own. :func:`dcgru_dec_bwd_loop` carries the
  per-layer dh and the ``din0`` feedback cotangent
  (``pallas_decoder.py:31-41``) and writes each layer's ``dpre =
  [dru_pre | dc_pre]`` and each step's ``dproj`` in float32; the cells'
  dW and db then come from the bulk x-in dW kernel
  (``ops/cuda_recurrent.dcgru_xin_dw``), once for layer 0 and once for
  the shared cell over layers 1..L-1 stacked as (L-1)*T steps (the sum
  over layers that the weight tying needs), and dWp / dbp from
  :func:`dcgru_dec_dwp`; ``dcgru_dw_reduce`` sums each one's partials.
  No dW is accumulated in the serial loop.

The two state loops (:func:`dcgru_decoder_fwd`, :func:`dcgru_dec_bwd_loop`)
run each step's products on tensor cores, as the encoder's loops do: the
wrapper stages the weights at every launch as the kernels' A fragments
(:func:`decoder_fwd_weights`, :func:`decoder_bwd_weights`), bfloat16 for
bf16 streams (the reference's one bf16 pass) and float32 for f32 streams
(split into 3xTF32 in the kernel); the kernel copies as much of the tied
cell's as fits into shared memory and reads the rest from L2
(:func:`decoder_plan`).

Each kernel's wrapper computes with its plain version when its input lies
on the CPU, launches the kernel when it lies on a CUDA device, and raises
otherwise or on what the kernel does not take; each counts its launches
in ``<wrapper>.launches``.

Layouts are the JAX kernels' weights: m-major (input rows (M*Din, O),
hidden rows (M*H, O)), ``wp`` = ``proj_w.T`` (H, D). The residuals are
layer-major, so each layer's stream (and layers 1..L-1 together) is
contiguous: in0 (T, B, N, D), h_seq and c_seq (L, T, B, N, H), ru_seq
(L, T, B, N, 2H). The x stream, proj, the residuals, the proj cotangent
and dx are float32 or bfloat16 (the stream dtype); operators, force,
weights, biases, h0_stack, dh0, dpre, dproj, every weight gradient and
every sum are float32 (``pallas_decoder.py:441-449, 527-536``).

:func:`dcgru_decoder_recurrence` is the ``torch.autograd.Function``
counterpart of the ``custom_vjp`` ``dcgru_decoder_pallas``: no gradient
for the operators or the force vector, and with ``num_layers == 1`` no
shared cell (its arguments are None) and none of its gradients.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from eeg_gnn_tpu_torch.ops import _build
from eeg_gnn_tpu_torch.ops.cuda_recurrent import (
    _ACT_CODES,
    _check,
    _check_shapes,
    _ptr,
    _raise_on,
    _split_dw,
    _stream,
    dcgru_dw_reduce,
    _tile_layout,
    dcgru_xin_dw,
    xin_cell_step,
)
from eeg_gnn_tpu_torch.ops.recurrent import (
    _act_pair,
    _apply_ops,
    _apply_ops_t,
    _contract_w_t,
    _weight_grad,
)

_LIB = "dcgru_decoder"
_DWP_ROWS = 256  # csrc kDwpRows: node rows a dWp split sums

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load(_LIB))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a ``csrc/dcgru_decoder.cu`` library."""
    lib.dcgru_decoder_fwd.argtypes = (
        [_P, _P, _P, _I, _P] + [_P] * 5 + [_P] + [_P] * 5 + [_I] * 9 + [_P])
    lib.dcgru_decoder_fwd.restype = _I
    lib.dcgru_dec_bwd_loop.argtypes = (
        [_P, _I, _P] + [_P] * 5 + [_P] * 4 + [_I] * 9 + [_P])
    lib.dcgru_dec_bwd_loop.restype = _I
    lib.dcgru_dec_plan.argtypes = [_I] * 7 + [_P]
    lib.dcgru_dec_plan.restype = _I
    lib.dcgru_dec_dwp.argtypes = [_P] * 3 + [_I] * 4 + [_P]
    lib.dcgru_dec_dwp.restype = _I
    lib.dcgru_error_string.argtypes = [_I]
    lib.dcgru_error_string.restype = ctypes.c_char_p
    return lib


def decoder_plan(fwd: bool, n: int, d: int, h_units: int, m: int,
                 num_layers: int, bf16: bool) -> dict:
    """The launch plan the forward (``fwd``) or the backward state loop
    takes on the current CUDA card: the bytes of its staged weights
    (``staged``), how many of them (a prefix: the tied cell's first) sit
    in shared memory (``in_smem``; the rest is read from L2), and the
    block's shared memory (``smem``)."""
    out = (ctypes.c_int * 3)()
    err = _lib().dcgru_dec_plan(int(fwd), n, d, h_units, m, num_layers,
                                int(bf16), ctypes.addressof(out))
    _raise_on(err, "dcgru_dec_plan", _lib)
    return {"in_smem": out[0], "smem": out[1], "staged": out[2]}


def _fwd_operands(layer0, shared, wp):
    """The forward loop's A operands, in the kernel's order: per cell, the
    tied one first when there is one, the gates [Wg^T | Wxg^T] (2H,
    M(H+Din)) and the candidate [Wc^T | Wxc^T] (H, M(H+Din)); then Wp^T
    (D, H)."""
    def cell(wxg, wxc, wg, wc):
        return (torch.cat([wg, wxg]).t(), torch.cat([wc, wxc]).t())
    return (cell(*shared) if shared else ()) + cell(*layer0) + (wp.t(),)


def _bwd_operands(layer0, shared, wp):
    """The backward loop's A operands, in the kernel's order: per cell,
    the tied one first, Wg (M*H, 2H), Wx = [Wxg | Wxc] (M*Din, 3H) and Wc
    (M*H, H); then Wp (H, D)."""
    def cell(wxg, wxc, wg, wc):
        return (wg, torch.cat([wxg, wxc], dim=1), wc)
    return (cell(*shared) if shared else ()) + cell(*layer0) + (wp,)


@functools.lru_cache(maxsize=16)
def _staging_index(operands, shapes, bf16, device):
    """Where each element of the staged weights comes from: 1 + its
    position in the weights flattened one after another (``shapes``, in
    the order ``operands`` takes them), 0 for the tiles' zero padding."""
    at, idx = 1, []
    for shape in shapes:
        n = int(np.prod(shape))
        idx.append(torch.arange(at, at + n, device=device).view(shape))
        at += n
    mats = operands(idx[:4], idx[4:-1], idx[-1])
    return torch.cat([_tile_layout(a, bf16).reshape(-1) for a in mats])


def _stage(operands, layer0, shared, wp, bf16):
    """The A operands of ``operands`` as tensor-core fragments, one
    gather from the weights (the layout of
    :func:`~eeg_gnn_tpu_torch.ops.cuda_recurrent.stage_chain_weights`)."""
    ws = (*layer0, *shared, wp)
    idx = _staging_index(operands, tuple(tuple(w.shape) for w in ws), bf16,
                         wp.device)
    src = torch.cat([wp.new_zeros(1)] + [w.reshape(-1) for w in ws])
    staged = src[idx]
    return staged.to(torch.bfloat16) if bf16 else staged


def decoder_fwd_weights(layer0, shared, wp, bf16: bool):
    """The forward loop's weights, staged once per launch as tensor-core A
    fragments (:func:`_fwd_operands`, in the layout of
    :func:`~eeg_gnn_tpu_torch.ops.cuda_recurrent.stage_chain_weights`):
    bfloat16 (rounded to nearest) or float32. ``layer0`` / ``shared``:
    (wxg, wxc, wg, wc) m-major 2-D, ``shared`` empty with one layer; ``wp``
    (H, D)."""
    return _stage(_fwd_operands, layer0, shared, wp, bf16)


def decoder_bwd_weights(layer0, shared, wp, bf16: bool):
    """The backward loop's weights, staged as :func:`decoder_fwd_weights`
    (:func:`_bwd_operands`)."""
    return _stage(_bwd_operands, layer0, shared, wp, bf16)


def dwp_splits(rows: int) -> int:
    """The splits of :func:`dcgru_dec_dwp`'s partials for ``rows`` =
    T*B*N node rows: one per 256 rows, on every device (split s sums rows
    [256 s, 256 (s+1)))."""
    return max(1, -(-rows // _DWP_ROWS))


def decoder_h_prev(h0_stack, h_seq):
    """Each step's incoming states, layer-major (L, T, B, N, H) in
    h_seq's dtype: [h0_l, h_seq[l, :-1]] for every layer l."""
    return torch.cat([h0_stack.to(h_seq.dtype)[:, None], h_seq[:, :-1]],
                     dim=1)


def _cell_shapes(m, d_in, h_units):
    """(wxg, wxc, wg, wc, bg, bc) of a cell with input width d_in."""
    return ((m * d_in, 2 * h_units), (m * d_in, h_units),
            (m * h_units, 2 * h_units), (m * h_units, h_units),
            (2 * h_units,), (h_units,))


def _cells_r(m, d, h_units, num_layers, layer0, shared):
    """Per-layer (wxg, wxc, wg, wc) as (M, Din, O) views, then the rest of
    each cell's tuple unchanged."""
    def r(cell, d_in):
        return (cell[0].reshape(m, d_in, -1), cell[1].reshape(m, d_in, -1),
                cell[2].reshape(m, h_units, -1),
                cell[3].reshape(m, h_units, -1), *cell[4:])
    return [r(layer0, d)] + [r(shared, h_units) for _ in range(num_layers - 1)]


# ---------------------------------------------------------------------------
# Plain versions (same function, torch ops, Python loops over T and L)
# ---------------------------------------------------------------------------


def dcgru_decoder_fwd_plain(a_ops, x_seq, force, wx0g, wx0c, wh0g, wh0c,
                            b0g, b0c, wxsg, wxsc, whsg, whsc, bsg, bsc, wp,
                            bp, h0_stack, num_layers, activation="tanh",
                            residuals=False):
    """Plain version of :func:`dcgru_decoder_fwd` (same arguments and
    results), the math of ``_fwd_kernel_dec``; differentiable by
    autograd."""
    t, b, n, d = x_seq.shape
    m = a_ops.shape[0]
    h_units = h0_stack.shape[-1]
    act, _ = _act_pair(activation)
    cells = _cells_r(m, d, h_units, num_layers,
                     (wx0g, wx0c, wh0g, wh0c, b0g, b0c),
                     (wxsg, wxsc, whsg, whsc, bsg, bsc))
    h = list(h0_stack.float().unbind(0))
    inp = torch.zeros((b, n, d), dtype=torch.float32, device=x_seq.device)
    # per step: proj, in0; per step and layer: h, ru, c
    seqs = {"proj": [], "in0": [], "h": [], "ru": [], "c": []}
    for ti in range(t):
        seqs["in0"].append(inp)
        out, step = inp, {"h": [], "ru": [], "c": []}
        for li in range(num_layers):
            out, ru, c = xin_cell_step(a_ops, out, h[li], *cells[li], act)
            h[li] = out
            for k, v in (("h", out), ("ru", ru), ("c", c)):
                step[k].append(v)
        proj = torch.matmul(out, wp) + bp
        seqs["proj"].append(proj)
        for k, v in step.items():
            seqs[k].append(torch.stack(v))
        # scheduled sampling: the feedback uses the f32 projection
        f = force[ti]
        inp = f * x_seq[ti].float() + (1.0 - f) * proj
    # the layer residuals layer-major: (T, L, ...) -> (L, T, ...)
    outs = [torch.stack(seqs[k], dim=1 if k in ("h", "ru", "c") else 0)
            .to(x_seq.dtype) for k in
            (("proj", "in0", "h", "ru", "c") if residuals else ("proj",))]
    return tuple(outs) + (None,) * (5 - len(outs))


def _xin_cell_bwd_state(a_ops, h_prev, ru, c, g, wxg_r, wxc_r, wg_r, wc_r,
                        act_grad):
    """The state part of the BPTT of
    :func:`~eeg_gnn_tpu_torch.ops.cuda_recurrent.xin_cell_step` at one
    step, g the cotangent of h'. Returns (dh_prev, dx, dru_pre, dc_pre),
    all float32."""
    h_units = h_prev.shape[-1]
    r, u = ru[..., :h_units], ru[..., h_units:]
    du = g * (h_prev - c)
    dc_pre = g * (1.0 - u) * act_grad(c)
    drh = _apply_ops_t(a_ops, _contract_w_t(dc_pre, wc_r))
    dx = _apply_ops_t(a_ops, _contract_w_t(dc_pre, wxc_r))
    dru_pre = torch.cat([drh * h_prev, du], dim=-1) * ru * (1.0 - ru)
    dh_prev = (g * u + drh * r
               + _apply_ops_t(a_ops, _contract_w_t(dru_pre, wg_r)))
    dx = dx + _apply_ops_t(a_ops, _contract_w_t(dru_pre, wxg_r))
    return dh_prev, dx, dru_pre, dc_pre


def _xin_cell_bwd(a_ops, h_prev, ru, c, x, g, wxg_r, wxc_r, wg_r, wc_r,
                  act_grad):
    """BPTT of :func:`~eeg_gnn_tpu_torch.ops.cuda_recurrent.xin_cell_step`
    at one step, g the cotangent of h'. Returns (dh_prev, dx, (dwxg_r,
    dwxc_r, dwg_r, dwc_r, dbg, dbc)), all float32."""
    h_units = h_prev.shape[-1]
    dh_prev, dx, dru_pre, dc_pre = _xin_cell_bwd_state(
        a_ops, h_prev, ru, c, g, wxg_r, wxc_r, wg_r, wc_r, act_grad)
    hf = _apply_ops(a_ops, h_prev)
    rf = _apply_ops(a_ops, ru[..., :h_units] * h_prev)
    xf = _apply_ops(a_ops, x)
    grads = (_weight_grad(xf, dru_pre), _weight_grad(xf, dc_pre),
             _weight_grad(hf, dru_pre), _weight_grad(rf, dc_pre),
             dru_pre.sum(dim=(0, 1)), dc_pre.sum(dim=(0, 1)))
    return dh_prev, dx, grads


def dcgru_decoder_bwd_plain(a_ops, wx0g, wx0c, wh0g, wh0c, wxsg, wxsc, whsg,
                            whsc, wp, h_prev, h_seq, ru_seq, c_seq, in0,
                            d_seq, force, num_layers, activation="tanh"):
    """Plain version of :func:`dcgru_decoder_bwd`: the reverse loop of
    ``_bwd_kernel_dec``, every dW summed inside it as the TPU kernel does
    (same arguments and results)."""
    t, b, n, d = in0.shape
    m = a_ops.shape[0]
    h_units = wp.shape[0]
    ll = num_layers
    _, act_grad = _act_pair(activation)
    cells = _cells_r(m, d, h_units, ll, (wx0g, wx0c, wh0g, wh0c),
                     (wxsg, wxsc, whsg, whsc))
    # one gradient list per cell: layer 0, then the shared cell
    grads = [[torch.zeros(w.shape, device=in0.device) for w in cell]
             + [torch.zeros(2 * h_units, device=in0.device),
                torch.zeros(h_units, device=in0.device)]
             for cell in cells[:2]]
    dwp = torch.zeros((h_units, d), device=in0.device)
    dbp = torch.zeros(d, device=in0.device)
    dh = [torch.zeros((b, n, h_units), device=in0.device) for _ in range(ll)]
    din = torch.zeros((b, n, d), device=in0.device)
    dx = torch.empty_like(in0)
    for ti in reversed(range(t)):
        f = force[ti]
        dproj = d_seq[ti].float() + (1.0 - f) * din
        dx[ti] = f * din
        top = h_seq[ll - 1, ti].float()
        dwp += torch.tensordot(top, dproj, dims=([0, 1], [0, 1]))
        dbp += dproj.sum(dim=(0, 1))
        dcur = torch.matmul(dproj, wp.t())  # into the top layer's h
        for li in reversed(range(ll)):
            inp = in0[ti] if li == 0 else h_seq[li - 1, ti]
            dh[li], dinp, cell_grads = _xin_cell_bwd(
                a_ops, h_prev[li, ti].float(), ru_seq[li, ti].float(),
                c_seq[li, ti].float(), inp.float(), dh[li] + dcur,
                *cells[li], act_grad)
            for acc, g in zip(grads[min(li, 1)], cell_grads):
                acc += g
            if li == 0:
                din = dinp  # for x_{t-1} and proj_{t-1}
            else:
                dcur = dinp  # into the layer below's h at this step
    flat = [[g.reshape(-1, g.shape[-1]) if g.ndim == 3 else g for g in cell]
            for cell in grads]
    shared = flat[1] if ll > 1 else [None] * 6
    return (dx, torch.stack(dh), *flat[0], *shared, dwp, dbp)


def dcgru_dec_bwd_loop_plain(a_ops, wx0g, wx0c, wh0g, wh0c, wxsg, wxsc,
                             whsg, whsc, wp, h_prev, ru_seq, c_seq, d_seq,
                             force, num_layers, activation="tanh"):
    """Plain version of :func:`dcgru_dec_bwd_loop`: the reverse loop of
    :func:`dcgru_decoder_bwd_plain` without any dW (same arguments and
    results)."""
    ll, t, b, n, h_units = h_prev.shape
    d = d_seq.shape[-1]
    m = a_ops.shape[0]
    _, act_grad = _act_pair(activation)
    cells = _cells_r(m, d, h_units, ll, (wx0g, wx0c, wh0g, wh0c),
                     (wxsg, wxsc, whsg, whsc))
    dev = d_seq.device
    dpre = torch.empty((ll, t, b, n, 3 * h_units), device=dev)
    dproj = torch.empty((t, b, n, d), device=dev)
    dh = [torch.zeros((b, n, h_units), device=dev) for _ in range(ll)]
    din = torch.zeros((b, n, d), device=dev)
    dx = torch.empty_like(d_seq)
    for ti in reversed(range(t)):
        f = force[ti]
        dproj[ti] = d_seq[ti].float() + (1.0 - f) * din
        dx[ti] = f * din
        dcur = torch.matmul(dproj[ti], wp.t())  # into the top layer's h
        for li in reversed(range(ll)):
            dh[li], dinp, dru_pre, dc_pre = _xin_cell_bwd_state(
                a_ops, h_prev[li, ti].float(), ru_seq[li, ti].float(),
                c_seq[li, ti].float(), dh[li] + dcur, *cells[li], act_grad)
            dpre[li, ti] = torch.cat([dru_pre, dc_pre], dim=-1)
            if li == 0:
                din = dinp  # for x_{t-1} and proj_{t-1}
            else:
                dcur = dinp  # into the layer below's h at this step
    return dx, torch.stack(dh), dpre, dproj


def dcgru_dec_dwp_plain(h_top, dproj, splits=None):
    """Plain version of :func:`dcgru_dec_dwp`: the same split partials
    (``splits`` of them; by default :func:`dwp_splits`)."""
    h_units, d = h_top.shape[-1], dproj.shape[-1]
    hs = h_top.reshape(-1, h_units).float()
    gs = dproj.reshape(-1, d).float()
    rows = hs.shape[0]
    splits = dwp_splits(rows) if splits is None else splits
    per = max(1, -(-rows // splits))
    out = []
    for s in range(splits):
        sl = slice(min(rows, s * per), min(rows, (s + 1) * per))
        out.append(torch.cat([(hs[sl].t() @ gs[sl]).reshape(-1),
                              gs[sl].sum(dim=0)]))
    return torch.stack(out)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def dcgru_decoder_fwd(a_ops, x_seq, force, wx0g, wx0c, wh0g, wh0c, b0g, b0c,
                      wxsg, wxsc, whsg, whsc, bsg, bsc, wp, bp, h0_stack,
                      num_layers, activation="tanh", residuals=False):
    """The whole decoder forward over T_out steps.

    Args:
        a_ops: (M, B or 1, N, N) Chebyshev operator stack, float32.
        x_seq: (T, B, N, D) teacher-forcing inputs in the stream dtype.
        force: (T,) float32 per-step force, 1 feeds x_t to step t+1 and 0
            the projection.
        wx0g, wx0c, wh0g, wh0c, b0g, b0c: the layer-0 cell, m-major
            ((M*D, 2H), (M*D, H), (M*H, 2H), (M*H, H), (2H,), (H,)).
        wxsg .. bsc: the shared cell of layers >= 1 (input width H); None
            when ``num_layers == 1``.
        wp: (H, D) = ``proj_w.T``; bp: (D,); h0_stack: (L, B, N, H) f32.
        residuals: also return in0 (T, B, N, D), h_seq (L, T, B, N, H),
            ru_seq (L, T, B, N, 2H) and c_seq (L, T, B, N, H).

    Returns:
        (proj, in0, h_seq, ru_seq, c_seq) in the stream dtype: proj
        (T, B, N, D) and the residuals (None unless asked for).
    """
    if x_seq.device.type == "cpu":
        return dcgru_decoder_fwd_plain(
            a_ops, x_seq, force, wx0g, wx0c, wh0g, wh0c, b0g, b0c, wxsg,
            wxsc, whsg, whsc, bsg, bsc, wp, bp, h0_stack, num_layers,
            activation, residuals)
    t, b, n, d = x_seq.shape
    m = a_ops.shape[0]
    h_units = h0_stack.shape[-1]
    ll = num_layers
    name = "dcgru_decoder_fwd"
    layer0 = (wx0g, wx0c, wh0g, wh0c, b0g, b0c)
    shared = (wxsg, wxsc, whsg, whsc, bsg, bsc) if ll > 1 else ()
    _check(name, (x_seq,), a_ops, (force, *layer0, *shared, wp, bp,
                                   h0_stack), activation, b, n, h_units)
    if d % 4:
        raise ValueError(f"{name}: D={d} is not a multiple of 4")
    _check_shapes(name, "force, h0_stack or projection",
                  (force, h0_stack, wp, bp),
                  ((t,), (ll, b, n, h_units), (h_units, d), (d,)))
    _check_shapes(name, "layer-0 weight", layer0,
                  _cell_shapes(m, d, h_units))
    _check_shapes(name, "shared weight", shared,
                  _cell_shapes(m, h_units, h_units))
    mk = lambda w: torch.empty((t, b, n, w), dtype=x_seq.dtype,
                               device=x_seq.device)
    proj = mk(d)
    mkl = lambda w: torch.empty((ll, t, b, n, w), dtype=x_seq.dtype,
                                device=x_seq.device)
    res = ((mk(d), mkl(h_units), mkl(2 * h_units), mkl(h_units))
           if residuals else (None,) * 4)
    if b == 0 or t == 0:
        return (proj, *res)
    bf16 = x_seq.dtype == torch.bfloat16
    biases = [_ptr(v) for v in (b0g, b0c, *shared[4:])] + [None] * (
        2 if ll == 1 else 0)
    with torch.cuda.device(x_seq.device):
        w = decoder_fwd_weights(layer0[:4], shared[:4], wp, bf16)
        err = _lib().dcgru_decoder_fwd(
            x_seq.data_ptr(), force.data_ptr(), a_ops.data_ptr(),
            a_ops.shape[1], w.data_ptr(), *biases, bp.data_ptr(),
            h0_stack.data_ptr(), proj.data_ptr(), *(_ptr(r) for r in res),
            t, b, n, d, h_units, m, ll, _ACT_CODES[activation], int(bf16),
            _stream(x_seq))
    _raise_on(err, name, _lib)
    dcgru_decoder_fwd.launches += 1
    return (proj, *res)


dcgru_decoder_fwd.launches = 0


def _cell_grads(flat, m, d_in, h_units):
    """A cell's reduced dW slab -> (dwxg, dwxc, dwg, dwc, dbg, dbc) in the
    decoder's m-major 2-D layout."""
    dwxg, dwxc, dwg, dwc, dbg, dbc = _split_dw(flat, m, d_in, h_units)
    return (dwxg, dwxc, dwg.reshape(m * h_units, -1),
            dwc.reshape(m * h_units, -1), dbg, dbc)


def _steps(s):
    """A layer-major stream (L', T, B, N, W) as L'*T steps."""
    return s.reshape((-1,) + tuple(s.shape[2:]))


def decoder_dw_cells(a_ops, h_prev, h_seq, ru_seq, in0, dpre):
    """The bulk dW product's arguments (a_ops, h_prev, ru_seq, x, dpre)
    for each cell: layer 0, fed in0; with L > 1 the shared cell, its
    layers 1..L-1 stacked as (L-1)*T steps, each fed the layer below's h.
    Step p of the stack holds clip p % B, so every row meets its own
    operators, and the stack's sum is the sum over the tied layers."""
    cells = [(a_ops, h_prev[0], ru_seq[0], in0, dpre[0])]
    if h_prev.shape[0] > 1:
        cells.append((a_ops, _steps(h_prev[1:]), _steps(ru_seq[1:]),
                      _steps(h_seq[:-1]), _steps(dpre[1:])))
    return cells


def decoder_bwd_pieces(a_ops, wx0g, wx0c, wh0g, wh0c, wxsg, wxsc, whsg, whsc,
                       wp, h_prev, h_seq, ru_seq, c_seq, in0, d_seq, force,
                       num_layers, activation="tanh"):
    """:func:`dcgru_decoder_bwd`'s arguments as its pieces take them: the
    state loop's arguments (:func:`dcgru_dec_bwd_loop`), a function from
    the loop's dpre to the bulk dW launches' arguments
    (:func:`decoder_dw_cells`), and dWp's h_top (the top layer's h)."""
    loop = (a_ops, wx0g, wx0c, wh0g, wh0c, wxsg, wxsc, whsg, whsc, wp,
            h_prev, ru_seq, c_seq, d_seq, force, num_layers, activation)
    dw_cells = functools.partial(decoder_dw_cells, a_ops, h_prev, h_seq,
                                 ru_seq, in0)
    return loop, dw_cells, h_seq[num_layers - 1]


def dcgru_decoder_bwd(a_ops, wx0g, wx0c, wh0g, wh0c, wxsg, wxsc, whsg, whsc,
                      wp, h_prev, h_seq, ru_seq, c_seq, in0, d_seq, force,
                      num_layers, activation="tanh"):
    """BPTT of :func:`dcgru_decoder_fwd` over all T_out steps.

    On a CUDA device: the state loop (:func:`dcgru_dec_bwd_loop`: dx, dh0,
    dpre and dproj), the bulk dW kernel
    (``cuda_recurrent.dcgru_xin_dw``) for layer 0 and, with
    ``num_layers > 1``, for the shared cell over layers 1..L-1 stacked, the
    dWp / dbp kernel (:func:`dcgru_dec_dwp`), and ``dcgru_dw_reduce`` over
    each one's split partials. It launches no kernel of its own.

    Args:
        a_ops, the weights (the shared ones None when ``num_layers == 1``),
            wp, force: as the forward.
        h_prev: (L, T, B, N, H) each step's incoming states
            (:func:`decoder_h_prev`);
        h_seq, ru_seq, c_seq, in0: the forward's residuals;
        d_seq: (T, B, N, D) the cotangent of proj. All six in the stream
            dtype.

    Returns:
        (dx, dh0, dwx0g, dwx0c, dwh0g, dwh0c, db0g, db0c, dwxsg, dwxsc,
        dwhsg, dwhsc, dbsg, dbsc, dwp, dbp): dx (T, B, N, D) in the stream
        dtype, dh0 (L, B, N, H) and the rest float32 in their primals'
        shapes; the shared cell's six are None when ``num_layers == 1``.
    """
    if h_seq.device.type == "cpu":
        return dcgru_decoder_bwd_plain(
            a_ops, wx0g, wx0c, wh0g, wh0c, wxsg, wxsc, whsg, whsc, wp,
            h_prev, h_seq, ru_seq, c_seq, in0, d_seq, force, num_layers,
            activation)
    t, b, n, d = in0.shape
    m = a_ops.shape[0]
    h_units = wp.shape[0]
    ll = num_layers
    name = "dcgru_decoder_bwd"
    streams = (h_prev, h_seq, ru_seq, c_seq, in0, d_seq)
    _check(name, streams, a_ops, (force, wp), activation, b, n, h_units)
    _check_shapes(name, "stream", streams, (
        (ll, t, b, n, h_units), (ll, t, b, n, h_units),
        (ll, t, b, n, 2 * h_units), (ll, t, b, n, h_units), (t, b, n, d),
        (t, b, n, d)))
    loop, dw_cells, h_top = decoder_bwd_pieces(
        a_ops, wx0g, wx0c, wh0g, wh0c, wxsg, wxsc, whsg, whsc, wp, h_prev,
        h_seq, ru_seq, c_seq, in0, d_seq, force, ll, activation)
    dx, dh0, dpre, dproj = dcgru_dec_bwd_loop(*loop)
    cells = [_cell_grads(dcgru_dw_reduce(dcgru_xin_dw(*c)), m,
                         c[3].shape[-1], h_units) for c in dw_cells(dpre)]
    shared = cells[1] if ll > 1 else (None,) * 6
    flat = dcgru_dw_reduce(dcgru_dec_dwp(h_top, dproj))
    return (dx, dh0, *cells[0], *shared,
            flat[:h_units * d].view(h_units, d), flat[h_units * d:])


def dcgru_dec_bwd_loop(a_ops, wx0g, wx0c, wh0g, wh0c, wxsg, wxsc, whsg, whsc,
                       wp, h_prev, ru_seq, c_seq, d_seq, force, num_layers,
                       activation="tanh"):
    """The state loop of :func:`dcgru_decoder_bwd`: the reverse loop over
    T_out and the L layers without any dW.

    Args:
        a_ops, the weights, wp, force, num_layers, activation: as
            :func:`dcgru_decoder_bwd`; h_prev, ru_seq, c_seq (layer-major)
            and d_seq (T, B, N, D) in the stream dtype.

    Returns:
        (dx (T, B, N, D) in the stream dtype, dh0 (L, B, N, H), dpre (L, T,
        B, N, 3H) = [dru_pre | dc_pre] per layer, dproj (T, B, N, D)
        = d_seq + (1 - f) din0), the last three float32.
    """
    if h_prev.device.type == "cpu":
        return dcgru_dec_bwd_loop_plain(
            a_ops, wx0g, wx0c, wh0g, wh0c, wxsg, wxsc, whsg, whsc, wp,
            h_prev, ru_seq, c_seq, d_seq, force, num_layers, activation)
    ll, t, b, n, h_units = h_prev.shape
    d = d_seq.shape[-1]
    m = a_ops.shape[0]
    name = "dcgru_dec_bwd_loop"
    streams = (h_prev, ru_seq, c_seq, d_seq)
    layer0 = (wx0g, wx0c, wh0g, wh0c)
    shared = (wxsg, wxsc, whsg, whsc) if ll > 1 else ()
    _check(name, streams, a_ops, (force, *layer0, *shared, wp), activation,
           b, n, h_units)
    if d % 4:
        raise ValueError(f"{name}: D={d} is not a multiple of 4")
    _check_shapes(name, "stream", streams, (
        (ll, t, b, n, h_units), (ll, t, b, n, 2 * h_units),
        (ll, t, b, n, h_units), (t, b, n, d)))
    _check_shapes(name, "force or projection", (force, wp),
                  ((t,), (h_units, d)))
    _check_shapes(name, "layer-0 weight", layer0,
                  _cell_shapes(m, d, h_units)[:4])
    _check_shapes(name, "shared weight", shared,
                  _cell_shapes(m, h_units, h_units)[:4])
    dev = d_seq.device
    dx = torch.empty((t, b, n, d), dtype=d_seq.dtype, device=dev)
    dh0 = torch.empty((ll, b, n, h_units), dtype=torch.float32, device=dev)
    dpre = torch.empty((ll, t, b, n, 3 * h_units), dtype=torch.float32,
                       device=dev)
    dproj = torch.empty((t, b, n, d), dtype=torch.float32, device=dev)
    bf16 = d_seq.dtype == torch.bfloat16
    with torch.cuda.device(dev):
        w = decoder_bwd_weights(layer0, shared, wp, bf16)
        err = _lib().dcgru_dec_bwd_loop(
            a_ops.data_ptr(), a_ops.shape[1], w.data_ptr(),
            *(s.data_ptr() for s in streams), force.data_ptr(),
            dx.data_ptr(), dh0.data_ptr(), dpre.data_ptr(), dproj.data_ptr(),
            t, b, n, d, h_units, m, ll, _ACT_CODES[activation], int(bf16),
            _stream(d_seq))
    _raise_on(err, name, _lib)
    dcgru_dec_bwd_loop.launches += 1
    return dx, dh0, dpre, dproj


dcgru_dec_bwd_loop.launches = 0


def dcgru_dec_dwp(h_top, dproj):
    """The output projection's gradient over all T*B*N node rows at once:
    ``dWp = h_top^T dproj``, ``dbp = sum dproj``.

    Args:
        h_top: (T, B, N, H) the top layer's states, float32 or bfloat16.
        dproj: (T, B, N, D) float32, from :func:`dcgru_dec_bwd_loop`.

    Returns:
        (dwp_splits(T*B*N), H*D + D) float32 partials [dWp (H, D) | dbp
        (D)], one per split of the rows; their sum over axis 0
        (``dcgru_dw_reduce``) is the gradient.
    """
    if dproj.device.type == "cpu":
        return dcgru_dec_dwp_plain(h_top, dproj)
    name = "dcgru_dec_dwp"
    if dproj.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {dproj.device} are neither on "
                         "the CPU nor on a CUDA device")
    if h_top.dtype not in (torch.float32, torch.bfloat16) \
            or dproj.dtype != torch.float32:
        raise TypeError(f"{name}: takes h_top float32 or bfloat16 and dproj "
                        f"float32, got {h_top.dtype} and {dproj.dtype}")
    if h_top.device != dproj.device or not h_top.is_contiguous() \
            or not dproj.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors on "
                         "one device")
    t, b, n, h_units = h_top.shape
    d = dproj.shape[-1]
    if d % 4 or h_units % 4:
        raise ValueError(f"{name}: H={h_units} or D={d} is not a multiple "
                         "of 4")
    _check_shapes(name, "dproj", (dproj,), ((t, b, n, d),))
    rows = t * b * n
    part = torch.empty((dwp_splits(rows), h_units * d + d),
                       dtype=torch.float32, device=dproj.device)
    if rows == 0:
        return part.zero_()
    with torch.cuda.device(dproj.device):
        err = _lib().dcgru_dec_dwp(
            h_top.data_ptr(), dproj.data_ptr(), part.data_ptr(), rows,
            h_units, d, int(h_top.dtype == torch.bfloat16), _stream(dproj))
    _raise_on(err, name, _lib)
    dcgru_dec_dwp.launches += 1
    return part


dcgru_dec_dwp.launches = 0


# ---------------------------------------------------------------------------
# Autograd Function
# ---------------------------------------------------------------------------


class _DecoderRecurrence(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a_ops, x_seq, force, wx0g, wx0c, wh0g, wh0c, b0g, b0c,
                wxsg, wxsc, whsg, whsc, bsg, bsc, wp, bp, h0_stack,
                num_layers, activation):
        proj, in0, h_seq, ru_seq, c_seq = dcgru_decoder_fwd(
            a_ops, x_seq, force, wx0g, wx0c, wh0g, wh0c, b0g, b0c, wxsg,
            wxsc, whsg, whsc, bsg, bsc, wp, bp, h0_stack, num_layers,
            activation, residuals=True)
        ctx.save_for_backward(a_ops, force, wx0g, wx0c, wh0g, wh0c, wxsg,
                              wxsc, whsg, whsc, wp, h0_stack, in0, h_seq,
                              ru_seq, c_seq)
        ctx.num_layers, ctx.activation = num_layers, activation
        return proj

    @staticmethod
    def backward(ctx, d_proj):
        (a_ops, force, wx0g, wx0c, wh0g, wh0c, wxsg, wxsc, whsg, whsc, wp,
         h0_stack, in0, h_seq, ru_seq, c_seq) = ctx.saved_tensors
        dx, dh0, *dw = dcgru_decoder_bwd(
            a_ops, wx0g, wx0c, wh0g, wh0c, wxsg, wxsc, whsg, whsc, wp,
            decoder_h_prev(h0_stack, h_seq), h_seq, ru_seq, c_seq, in0,
            d_proj.to(h_seq.dtype).contiguous(), force, ctx.num_layers,
            ctx.activation)
        return (None, dx, None, *dw, dh0, None, None)


def dcgru_decoder_recurrence(a_ops, x_seq, force, wx0g, wx0c, wh0g, wh0c,
                             b0g, b0c, wxsg, wxsc, whsg, whsc, bsg, bsc, wp,
                             bp, h0_stack, num_layers, activation="tanh"):
    """Differentiable :func:`dcgru_decoder_fwd` (arguments as it has
    them): returns proj (T, B, N, D) in the stream dtype; its backward is
    :func:`dcgru_decoder_bwd`."""
    return _DecoderRecurrence.apply(
        a_ops, x_seq, force, wx0g, wx0c, wh0g, wh0c, b0g, b0c, wxsg, wxsc,
        whsg, whsc, bsg, bsc, wp, bp, h0_stack, num_layers, activation)
