"""Whole-sequence DCGRU layer recurrence: CUDA kernels, their wrappers,
their plain PyTorch versions, and the autograd Functions built on them.

Four kernels replace the JAX package's Pallas kernels
(``eeg_gnn_tpu/ops/pallas_recurrent.py``):

- :func:`dcgru_recurrence_xin_fwd` <- ``_fwd_kernel_xin``
  (``csrc/dcgru_recurrence.cu``): reads the raw (T, B, N, D) layer input
  and runs the input diffusion and projection inside the kernel (the
  default ``input_fusion`` path);
- :func:`dcgru_recurrence_fwd` <- ``_fwd_kernel`` (same source): the same
  recurrence fed a precomputed fused ``x_proj = [gate | cand]``
  (T, B, N, 3H) stream (``--no_input_fusion``);
- :func:`dcgru_recurrence_xin_bwd` <- ``_bwd_kernel_xin``
  (``csrc/dcgru_recurrence_bwd.cu``): the BPTT of the first;
- :func:`dcgru_recurrence_bwd` <- ``_bwd_kernel`` (same source): the BPTT
  of the second.

The backward kernels leave one f32 partial dW slab per clip; a fifth
kernel, :func:`dcgru_dw_reduce`, sums the slabs in a fixed order (the TPU
kernels summed into one resident block across their sequential grid).

Each wrapper computes the kernel's function with its plain version when
its input lies on the CPU, launches the kernel when it lies on a CUDA
device, and raises otherwise or on what the kernel does not take. Each
counts its launches in ``<wrapper>.launches``.

Streams (x / x_proj, h_seq, ru_seq, c_seq, the h_seq cotangent and the
x / x_proj cotangent) are float32 or bfloat16; operators, weights,
biases, ``h0``, the state, every gradient of a weight, bias or ``h0``,
and every accumulation are float32 (``pallas_recurrent.py:744,777,
807-813,1014-1021``).

:func:`dcgru_layer_recurrence_xin` and :func:`dcgru_layer_recurrence_fused`
are the ``torch.autograd.Function`` counterparts of the JAX package's
``dcgru_layer_recurrence_pallas_xin`` / ``_pallas_fused`` ``custom_vjp``
s: the forward kernel saves its ru/c residuals and the backward kernel
consumes them. No gradient is produced for the operators.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from eeg_gnn_tpu_torch.ops import _build
from eeg_gnn_tpu_torch.ops.recurrent import (
    _act_pair,
    _apply_ops,
    _apply_ops_t,
    _contract_w,
    _scan_backward,
    _scan_forward,
    shift_h_prev,
)

_ACT_CODES = {"tanh": 0, None: 0, "relu": 1, "linear": 2}
_STREAM_DTYPES = (torch.float32, torch.bfloat16)
_MAX_NODES = 32  # csrc kMaxNodes
_LIB = "dcgru_recurrence"
_LIB_BWD = "dcgru_recurrence_bwd"

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load(_LIB)
    lib.dcgru_recurrence_xin_fwd.argtypes = (
        [_P, _P, _I] + [_P] * 7 + [_P, _P, _P] + [_I] * 8 + [_P])
    lib.dcgru_recurrence_xin_fwd.restype = _I
    lib.dcgru_recurrence_fwd.argtypes = (
        [_P, _P, _I] + [_P] * 5 + [_P, _P, _P] + [_I] * 7 + [_P])
    lib.dcgru_recurrence_fwd.restype = _I
    lib.dcgru_error_string.argtypes = [_I]
    lib.dcgru_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib_bwd() -> ctypes.CDLL:
    lib = _build.load(_LIB_BWD)
    lib.dcgru_recurrence_xin_bwd.argtypes = (
        [_P, _I] + [_P] * 4 + [_P] * 5 + [_P] * 3 + [_I] * 9 + [_P])
    lib.dcgru_recurrence_xin_bwd.restype = _I
    lib.dcgru_recurrence_bwd.argtypes = (
        [_P, _I] + [_P] * 2 + [_P] * 4 + [_P] * 3 + [_I] * 7 + [_P])
    lib.dcgru_recurrence_bwd.restype = _I
    lib.dcgru_dw_reduce.argtypes = [_P, _P, _I, _I, _P]
    lib.dcgru_dw_reduce.restype = _I
    lib.dcgru_error_string.argtypes = [_I]
    lib.dcgru_error_string.restype = ctypes.c_char_p
    return lib


def _outputs(like, t, b, n, h_units, dtype, residuals):
    mk = lambda w: torch.empty((t, b, n, w), dtype=dtype, device=like.device)
    if residuals:
        return mk(h_units), mk(2 * h_units), mk(h_units)
    return mk(h_units), None, None


def dw_size(m: int, d: int, h_units: int) -> int:
    """Floats of one clip's dW partial slab: [dWxg (M*D, 2H) | dWxc (M*D,
    H) | dWg (M*H, 2H) | dWc (M*H, H) | dbg (2H) | dbc (H)]; d=0 for the
    hoisted kernel, which has no dWx."""
    return (m * d + m * h_units) * 3 * h_units + 3 * h_units


# ---------------------------------------------------------------------------
# Plain versions (same function, torch ops, a Python loop over T)
# ---------------------------------------------------------------------------


def xin_cell_step(a_ops, x, h, wxg_r, wxc_r, wg_r, wc_r, gate_b, cand_b,
                  act):
    """One step of the x-in-kernel cell in float32: x (B, N, D) and h
    (B, N, H) -> (h', ru, c); wxg_r / wxc_r are (M, D, 2H / H)."""
    h_units = h.shape[-1]
    feats = _apply_ops(a_ops, torch.cat([h, x], dim=-1))
    hf, xf = feats[..., :h_units], feats[..., h_units:]
    ru = torch.sigmoid(_contract_w(xf, wxg_r) + _contract_w(hf, wg_r)
                       + gate_b)
    r, u = ru[..., :h_units], ru[..., h_units:]
    c = act(_contract_w(xf, wxc_r)
            + _contract_w(_apply_ops(a_ops, r * h), wc_r) + cand_b)
    return u * h + (1.0 - u) * c, ru, c


def dcgru_recurrence_xin_fwd_plain(x, a_ops, wxg_f, wxc_f, wg_r, wc_r,
                                   gate_b, cand_b, h0, activation="tanh",
                                   residuals=False):
    """Plain version of :func:`dcgru_recurrence_xin_fwd` (same arguments and
    results)."""
    t, b, n, d = x.shape
    m = a_ops.shape[0]
    h_units = h0.shape[-1]
    act, _ = _act_pair(activation)
    wxg_r = wxg_f.reshape(m, d, -1)
    wxc_r = wxc_f.reshape(m, d, -1)
    h_seq, ru_seq, c_seq = _outputs(x, t, b, n, h_units, x.dtype, residuals)
    h = h0
    for ti in range(t):
        h, ru, c = xin_cell_step(a_ops, x[ti].float(), h, wxg_r, wxc_r, wg_r,
                                 wc_r, gate_b, cand_b, act)
        h_seq[ti] = h
        if residuals:
            ru_seq[ti] = ru
            c_seq[ti] = c
    return h_seq, ru_seq, c_seq


def dcgru_recurrence_fwd_plain(x_proj, a_ops, wg_r, wc_r, gate_b, cand_b,
                               h0, activation="tanh", residuals=False):
    """Plain version of :func:`dcgru_recurrence_fwd`: the operator-stacked
    loop of ``ops/recurrent.py`` on the fused x_proj stream."""
    h_units = h0.shape[-1]
    xp = x_proj.float()
    _, h_seq, ru_seq, c_seq = _scan_forward(
        a_ops, xp[..., :2 * h_units], xp[..., 2 * h_units:], wg_r, wc_r,
        gate_b, cand_b, h0, activation, x_proj.dtype)
    h_seq = h_seq.to(x_proj.dtype)
    return (h_seq, ru_seq, c_seq) if residuals else (h_seq, None, None)


def dcgru_recurrence_bwd_plain(a_ops, wg_r, wc_r, h_prev, ru_seq, c_seq,
                               d_seq, activation="tanh"):
    """Plain version of :func:`dcgru_recurrence_bwd`: the reverse loop of
    ``ops/recurrent.py``; dxp = [dru_pre | dc_pre] in the stream dtype."""
    dgx, dcx, dwg, dwc, dbg, dbc, dh0 = _scan_backward(
        a_ops, wg_r, wc_r, h_prev, ru_seq, c_seq, d_seq, activation)
    dxp = torch.cat([dgx, dcx], dim=-1).to(h_prev.dtype)
    return dxp, dwg, dwc, dbg, dbc, dh0


def dcgru_recurrence_xin_bwd_plain(a_ops, wxg_f, wxc_f, wg_r, wc_r, h_prev,
                                   ru_seq, c_seq, x, d_seq,
                                   activation="tanh", need_dx=True):
    """Plain version of :func:`dcgru_recurrence_xin_bwd`.

    The state path is the reverse loop over T; the input path follows from
    it over all T at once, since the layer's input projection is
    ``sum_m (A_m x) Wx_m``: ``dWx_m = sum (A_m x)^T [dru_pre | dc_pre]``
    and ``dx = sum_m A_m^T ([dru_pre | dc_pre] Wx_m^T)``.
    """
    _, _, _, d = x.shape
    m = a_ops.shape[0]
    h2 = wg_r.shape[-1]
    dgx, dcx, dwg, dwc, dbg, dbc, dh0 = _scan_backward(
        a_ops, wg_r, wc_r, h_prev, ru_seq, c_seq, d_seq, activation)
    dxp = torch.cat([dgx, dcx], dim=-1)  # (T, B, N, 3H) f32
    wx_r = torch.cat([wxg_f, wxc_f], dim=1).reshape(m, d, -1)
    xf = _apply_ops(a_ops, x.float())  # (M, T, B, N, D)
    dwx = torch.tensordot(xf, dxp, dims=([1, 2, 3], [0, 1, 2]))
    dwx = dwx.reshape(m * d, -1)
    dx = None
    if need_dx:
        dy = torch.movedim(torch.tensordot(dxp, wx_r, dims=([3], [2])), 3, 0)
        dx = _apply_ops_t(a_ops, dy).to(x.dtype)
    return (dx, dwx[:, :h2].contiguous(), dwx[:, h2:].contiguous(), dwg,
            dwc, dbg, dbc, dh0)


def dcgru_dw_reduce_plain(partials):
    """Plain version of :func:`dcgru_dw_reduce`: sum over the clip axis."""
    return partials.sum(dim=0)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name, streams, a_ops, f32s, activation, b, n, h_units):
    """Device, dtype, layout and size rules every kernel shares: streams
    are one dtype (float32 or bfloat16); operators and ``f32s`` (weights,
    biases, h0) float32; everything contiguous on one CUDA device."""
    lead = streams[0]
    if lead.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {lead.device} are neither "
                         "on the CPU nor on a CUDA device")
    for s in streams:
        if s.dtype not in _STREAM_DTYPES:
            raise TypeError(f"{name}: stream dtype {s.dtype} is not "
                            "float32 or bfloat16")
        if s.dtype != lead.dtype:
            raise TypeError(f"{name}: streams mix {s.dtype} and "
                            f"{lead.dtype}")
    if activation not in _ACT_CODES:
        raise ValueError(f"{name}: unknown activation {activation!r}")
    if n > _MAX_NODES:
        raise ValueError(f"{name}: {n} nodes > the kernel's {_MAX_NODES}")
    if h_units % 4:
        raise ValueError(f"{name}: H={h_units} is not a multiple of 4")
    if a_ops.ndim != 4 or a_ops.shape[1] not in (1, b) \
            or a_ops.shape[2:] != (n, n):
        raise ValueError(f"{name}: a_ops {tuple(a_ops.shape)} is not "
                         f"(M, 1 or {b}, {n}, {n})")
    for t in (*streams, a_ops, *f32s):
        if t.device != lead.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{lead.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    for t in (a_ops, *f32s):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: operators, weights, biases and h0 "
                            f"must be float32, got {t.dtype}")


def _check_shapes(name, what, tensors, shapes):
    for t, want in zip(tensors, shapes):
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{name}: {what} {tuple(t.shape)} != "
                             f"{tuple(want)}")


def _raise_on(err: int, name: str, lib=_lib):
    if err != 0:
        msg = lib().dcgru_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def dcgru_recurrence_xin_fwd(x, a_ops, wxg_f, wxc_f, wg_r, wc_r, gate_b,
                             cand_b, h0, activation="tanh", residuals=False):
    """One DCGRU layer over all T steps, input diffusion in-kernel.

    Args:
        x: (T, B, N, D) raw layer input, float32 or bfloat16 (the stream
            dtype).
        a_ops: (M, B or 1, N, N) Chebyshev operator stack, float32
            (per-clip, or one shared graph broadcast over the batch).
        wxg_f: (M*D, 2H); wxc_f: (M*D, H) m-major input weights.
        wg_r: (M, H, 2H); wc_r: (M, H, H) hidden weights.
        gate_b: (2H,); cand_b: (H,); h0: (B, N, H) float32.
        residuals: also return ru_seq (T,B,N,2H) and c_seq (T,B,N,H).

    Returns:
        (h_seq, ru_seq, c_seq) in the stream dtype; the residuals are None
        unless asked for.
    """
    if x.device.type == "cpu":
        return dcgru_recurrence_xin_fwd_plain(
            x, a_ops, wxg_f, wxc_f, wg_r, wc_r, gate_b, cand_b, h0,
            activation, residuals)
    t, b, n, d = x.shape
    m = a_ops.shape[0]
    h_units = h0.shape[-1]
    name = "dcgru_recurrence_xin_fwd"
    weights = (wxg_f, wxc_f, wg_r, wc_r, gate_b, cand_b)
    _check(name, (x,), a_ops, (*weights, h0), activation, b, n, h_units)
    if d % 4:
        raise ValueError(f"{name}: D={d} is not a multiple of 4")
    _check_shapes(name, "h0", (h0,), ((b, n, h_units),))
    _check_shapes(name, "weight", weights, (
        (m * d, 2 * h_units), (m * d, h_units), (m, h_units, 2 * h_units),
        (m, h_units, h_units), (2 * h_units,), (h_units,)))
    h_seq, ru_seq, c_seq = _outputs(x, t, b, n, h_units, x.dtype, residuals)
    if b == 0 or t == 0:
        return h_seq, ru_seq, c_seq
    with torch.cuda.device(x.device):
        err = _lib().dcgru_recurrence_xin_fwd(
            x.data_ptr(), a_ops.data_ptr(), a_ops.shape[1],
            *(w.data_ptr() for w in weights), h0.data_ptr(),
            h_seq.data_ptr(), _ptr(ru_seq), _ptr(c_seq),
            t, b, n, d, h_units, m, _ACT_CODES[activation],
            int(x.dtype == torch.bfloat16), _stream(x))
    _raise_on(err, name)
    dcgru_recurrence_xin_fwd.launches += 1
    return h_seq, ru_seq, c_seq


dcgru_recurrence_xin_fwd.launches = 0


def dcgru_recurrence_fwd(x_proj, a_ops, wg_r, wc_r, gate_b, cand_b, h0,
                         activation="tanh", residuals=False):
    """One DCGRU layer over all T steps fed a precomputed fused input
    projection ``x_proj`` (T, B, N, 3H) = [gate (2H) | cand (H)], without
    biases, in the stream dtype. Other arguments and results as
    :func:`dcgru_recurrence_xin_fwd`."""
    if x_proj.device.type == "cpu":
        return dcgru_recurrence_fwd_plain(x_proj, a_ops, wg_r, wc_r, gate_b,
                                          cand_b, h0, activation, residuals)
    t, b, n, w3 = x_proj.shape
    m = a_ops.shape[0]
    h_units = h0.shape[-1]
    name = "dcgru_recurrence_fwd"
    weights = (wg_r, wc_r, gate_b, cand_b)
    _check(name, (x_proj,), a_ops, (*weights, h0), activation, b, n,
           h_units)
    if w3 != 3 * h_units:
        raise ValueError(f"{name}: x_proj width {w3} != 3H = {3 * h_units}")
    _check_shapes(name, "h0", (h0,), ((b, n, h_units),))
    _check_shapes(name, "weight", weights, (
        (m, h_units, 2 * h_units), (m, h_units, h_units), (2 * h_units,),
        (h_units,)))
    h_seq, ru_seq, c_seq = _outputs(x_proj, t, b, n, h_units, x_proj.dtype,
                                    residuals)
    if b == 0 or t == 0:
        return h_seq, ru_seq, c_seq
    with torch.cuda.device(x_proj.device):
        err = _lib().dcgru_recurrence_fwd(
            x_proj.data_ptr(), a_ops.data_ptr(), a_ops.shape[1],
            *(w.data_ptr() for w in weights), h0.data_ptr(),
            h_seq.data_ptr(), _ptr(ru_seq), _ptr(c_seq),
            t, b, n, h_units, m, _ACT_CODES[activation],
            int(x_proj.dtype == torch.bfloat16), _stream(x_proj))
    _raise_on(err, name)
    dcgru_recurrence_fwd.launches += 1
    return h_seq, ru_seq, c_seq


dcgru_recurrence_fwd.launches = 0


def dcgru_dw_reduce(partials):
    """Sum (B, W) per-clip dW partial slabs over B -> (W,) float32, in a
    fixed order (deterministic, no atomics)."""
    if partials.device.type == "cpu":
        return dcgru_dw_reduce_plain(partials)
    name = "dcgru_dw_reduce"
    if partials.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {partials.device} are neither "
                         "on the CPU nor on a CUDA device")
    if partials.dtype != torch.float32 or partials.ndim != 2 \
            or not partials.is_contiguous():
        raise ValueError(f"{name}: takes a contiguous (B, W) float32 "
                         f"tensor, got {partials.dtype} "
                         f"{tuple(partials.shape)}")
    b, w = partials.shape
    out = torch.empty((w,), dtype=torch.float32, device=partials.device)
    with torch.cuda.device(partials.device):
        err = _lib_bwd().dcgru_dw_reduce(partials.data_ptr(), out.data_ptr(),
                                         b, w, _stream(partials))
    _raise_on(err, name, _lib_bwd)
    dcgru_dw_reduce.launches += 1
    return out


dcgru_dw_reduce.launches = 0


def _split_dw(flat, m, d, h_units):
    """The reduced slab -> (dwxg_f, dwxc_f, dwg_r, dwc_r, dbg, dbc)."""
    h2 = 2 * h_units
    sizes = (m * d * h2, m * d * h_units, m * h_units * h2,
             m * h_units * h_units, h2, h_units)
    dwxg, dwxc, dwg, dwc, dbg, dbc = torch.split(flat, sizes)
    return (dwxg.view(m * d, h2), dwxc.view(m * d, h_units),
            dwg.view(m, h_units, h2), dwc.view(m, h_units, h_units), dbg,
            dbc)


def _bwd_outputs(like, t, b, n, width, m, d, h_units):
    """dx or dx_proj (None when ``width`` is None), dh0 and the slabs."""
    dev = like.device
    return (None if width is None else
            torch.empty((t, b, n, width), dtype=like.dtype, device=dev),
            torch.empty((b, n, h_units), dtype=torch.float32, device=dev),
            torch.empty((b, dw_size(m, d, h_units)), dtype=torch.float32,
                        device=dev))


def _transposed(w2d):
    return w2d.t().contiguous()


def dcgru_recurrence_xin_bwd(a_ops, wxg_f, wxc_f, wg_r, wc_r, h_prev,
                             ru_seq, c_seq, x, d_seq, activation="tanh",
                             need_dx=True):
    """BPTT of :func:`dcgru_recurrence_xin_fwd` over all T steps.

    Args:
        a_ops, wxg_f, wxc_f, wg_r, wc_r: as the forward, float32.
        h_prev: (T, B, N, H) each step's incoming state [h0, h_seq[:-1]];
        ru_seq (T,B,N,2H), c_seq (T,B,N,H): the forward's residuals;
        x: (T, B, N, D) the layer input; d_seq: (T, B, N, H) the cotangent
            of h_seq. All five in the stream dtype.
        need_dx: False skips dx (returned as None), for a layer whose input
            needs no gradient.

    Returns:
        (dx, dwxg_f, dwxc_f, dwg_r, dwc_r, dbg, dbc, dh0): dx (T,B,N,D) in
        the stream dtype, the rest float32 in the shapes of their primals.
    """
    if h_prev.device.type == "cpu":
        return dcgru_recurrence_xin_bwd_plain(
            a_ops, wxg_f, wxc_f, wg_r, wc_r, h_prev, ru_seq, c_seq, x,
            d_seq, activation, need_dx)
    t, b, n, d = x.shape
    m = a_ops.shape[0]
    h_units = h_prev.shape[-1]
    name = "dcgru_recurrence_xin_bwd"
    streams = (h_prev, ru_seq, c_seq, x, d_seq)
    weights = (wxg_f, wxc_f, wg_r, wc_r)
    _check(name, streams, a_ops, weights, activation, b, n, h_units)
    if d % 4:
        raise ValueError(f"{name}: D={d} is not a multiple of 4")
    _check_shapes(name, "stream", streams, (
        (t, b, n, h_units), (t, b, n, 2 * h_units), (t, b, n, h_units),
        (t, b, n, d), (t, b, n, h_units)))
    _check_shapes(name, "weight", weights, (
        (m * d, 2 * h_units), (m * d, h_units), (m, h_units, 2 * h_units),
        (m, h_units, h_units)))
    dx, dh0, part = _bwd_outputs(x, t, b, n, d if need_dx else None, m, d,
                                 h_units)
    w_t = (_transposed(wxg_f), _transposed(wxc_f),
           _transposed(wg_r.reshape(m * h_units, -1)),
           _transposed(wc_r.reshape(m * h_units, -1)))
    with torch.cuda.device(x.device):
        err = _lib_bwd().dcgru_recurrence_xin_bwd(
            a_ops.data_ptr(), a_ops.shape[1], *(w.data_ptr() for w in w_t),
            *(s.data_ptr() for s in streams),
            _ptr(dx), dh0.data_ptr(), part.data_ptr(),
            t, b, n, d, h_units, m, _ACT_CODES[activation],
            int(x.dtype == torch.bfloat16), int(need_dx), _stream(x))
    _raise_on(err, name, _lib_bwd)
    dcgru_recurrence_xin_bwd.launches += 1
    return (dx, *_split_dw(dcgru_dw_reduce(part), m, d, h_units), dh0)


dcgru_recurrence_xin_bwd.launches = 0


def dcgru_recurrence_bwd(a_ops, wg_r, wc_r, h_prev, ru_seq, c_seq, d_seq,
                         activation="tanh"):
    """BPTT of :func:`dcgru_recurrence_fwd` over all T steps.

    Arguments as :func:`dcgru_recurrence_xin_bwd` without the input and
    its weights. Returns (dxp, dwg_r, dwc_r, dbg, dbc, dh0): dxp
    (T, B, N, 3H) = [dru_pre | dc_pre] in the stream dtype, the rest
    float32.
    """
    if h_prev.device.type == "cpu":
        return dcgru_recurrence_bwd_plain(a_ops, wg_r, wc_r, h_prev, ru_seq,
                                          c_seq, d_seq, activation)
    t, b, n, h_units = h_prev.shape
    m = a_ops.shape[0]
    name = "dcgru_recurrence_bwd"
    streams = (h_prev, ru_seq, c_seq, d_seq)
    weights = (wg_r, wc_r)
    _check(name, streams, a_ops, weights, activation, b, n, h_units)
    _check_shapes(name, "stream", streams, (
        (t, b, n, h_units), (t, b, n, 2 * h_units), (t, b, n, h_units),
        (t, b, n, h_units)))
    _check_shapes(name, "weight", weights, (
        (m, h_units, 2 * h_units), (m, h_units, h_units)))
    dxp, dh0, part = _bwd_outputs(h_prev, t, b, n, 3 * h_units, m, 0,
                                  h_units)
    w_t = (_transposed(wg_r.reshape(m * h_units, -1)),
           _transposed(wc_r.reshape(m * h_units, -1)))
    with torch.cuda.device(h_prev.device):
        err = _lib_bwd().dcgru_recurrence_bwd(
            a_ops.data_ptr(), a_ops.shape[1], *(w.data_ptr() for w in w_t),
            *(s.data_ptr() for s in streams),
            dxp.data_ptr(), dh0.data_ptr(), part.data_ptr(),
            t, b, n, h_units, m, _ACT_CODES[activation],
            int(h_prev.dtype == torch.bfloat16), _stream(h_prev))
    _raise_on(err, name, _lib_bwd)
    dcgru_recurrence_bwd.launches += 1
    _, _, dwg, dwc, dbg, dbc = _split_dw(dcgru_dw_reduce(part), m, 0,
                                         h_units)
    return dxp, dwg, dwc, dbg, dbc, dh0


dcgru_recurrence_bwd.launches = 0


# ---------------------------------------------------------------------------
# Autograd Functions
# ---------------------------------------------------------------------------


class _XinRecurrence(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, a_ops, wxg_f, wxc_f, wg_r, wc_r, gate_b, cand_b, h0,
                activation):
        h_seq, ru_seq, c_seq = dcgru_recurrence_xin_fwd(
            x, a_ops, wxg_f, wxc_f, wg_r, wc_r, gate_b, cand_b, h0,
            activation, residuals=True)
        ctx.save_for_backward(x, a_ops, wxg_f, wxc_f, wg_r, wc_r, h0, h_seq,
                              ru_seq, c_seq)
        ctx.activation = activation
        return h_seq

    @staticmethod
    def backward(ctx, d_seq):
        (x, a_ops, wxg_f, wxc_f, wg_r, wc_r, h0, h_seq, ru_seq,
         c_seq) = ctx.saved_tensors
        # the cotangent arrives as a transposed view (the model gathers
        # the last step from a batch-first view) and in h_seq's dtype
        d_seq = d_seq.to(h_seq.dtype).contiguous()
        # the first layer's input is data: its dx is never asked for
        dx, dwxg, dwxc, dwg, dwc, dbg, dbc, dh0 = dcgru_recurrence_xin_bwd(
            a_ops, wxg_f, wxc_f, wg_r, wc_r, shift_h_prev(h0, h_seq),
            ru_seq, c_seq, x, d_seq, ctx.activation,
            need_dx=ctx.needs_input_grad[0])
        return dx, None, dwxg, dwxc, dwg, dwc, dbg, dbc, dh0, None


class _FusedRecurrence(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x_proj, a_ops, wg_r, wc_r, gate_b, cand_b, h0,
                activation):
        h_seq, ru_seq, c_seq = dcgru_recurrence_fwd(
            x_proj, a_ops, wg_r, wc_r, gate_b, cand_b, h0, activation,
            residuals=True)
        ctx.save_for_backward(a_ops, wg_r, wc_r, h0, h_seq, ru_seq, c_seq)
        ctx.activation = activation
        return h_seq

    @staticmethod
    def backward(ctx, d_seq):
        a_ops, wg_r, wc_r, h0, h_seq, ru_seq, c_seq = ctx.saved_tensors
        d_seq = d_seq.to(h_seq.dtype).contiguous()
        dxp, dwg, dwc, dbg, dbc, dh0 = dcgru_recurrence_bwd(
            a_ops, wg_r, wc_r, shift_h_prev(h0, h_seq), ru_seq, c_seq,
            d_seq, ctx.activation)
        return dxp, None, dwg, dwc, dbg, dbc, dh0, None


def dcgru_layer_recurrence_xin(x, a_ops, wxg_f, wxc_f, wg_r, wc_r, gate_b,
                               cand_b, h0, activation="tanh"):
    """Differentiable :func:`dcgru_recurrence_xin_fwd` (arguments as it
    has them): returns h_seq (T, B, N, H) in the stream dtype; its
    backward is :func:`dcgru_recurrence_xin_bwd`."""
    return _XinRecurrence.apply(x, a_ops, wxg_f, wxc_f, wg_r, wc_r, gate_b,
                                cand_b, h0, activation)


def dcgru_layer_recurrence_fused(x_proj, a_ops, wg_r, wc_r, gate_b, cand_b,
                                 h0, activation="tanh"):
    """Differentiable :func:`dcgru_recurrence_fwd`: returns h_seq in the
    stream dtype; its backward is :func:`dcgru_recurrence_bwd`."""
    return _FusedRecurrence.apply(x_proj, a_ops, wg_r, wc_r, gate_b, cand_b,
                                  h0, activation)
