"""Whole-sequence DCGRU layer recurrence: CUDA kernels, their wrappers and
their plain PyTorch versions (forward).

Two kernels in ``csrc/dcgru_recurrence.cu`` replace the JAX package's
Pallas forward kernels (``eeg_gnn_tpu/ops/pallas_recurrent.py``):

- :func:`dcgru_recurrence_xin_fwd` <- ``_fwd_kernel_xin``: reads the raw
  (T, B, N, D) layer input and runs the input diffusion and projection
  inside the kernel (the default ``input_fusion`` path);
- :func:`dcgru_recurrence_fwd` <- ``_fwd_kernel``: the same recurrence fed
  a precomputed fused ``x_proj = [gate | cand]`` (T, B, N, 3H) stream
  (``--no_input_fusion``).

Each wrapper computes the kernel's function with its plain version when
its input lies on the CPU, launches the kernel when it lies on a CUDA
device, and raises otherwise or on what the kernel does not take. Each
counts its launches in ``<wrapper>.launches``.

Streams (x / x_proj and the h_seq, ru_seq, c_seq outputs) are float32 or
bfloat16; operators, weights, biases, ``h0``, the state and every
accumulation are float32 (``pallas_recurrent.py:744,777``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from eeg_gnn_tpu_torch.ops import _build
from eeg_gnn_tpu_torch.ops.recurrent import (
    _act_pair,
    _apply_ops,
    _contract_w,
    _scan_forward,
)

_ACT_CODES = {"tanh": 0, None: 0, "relu": 1, "linear": 2}
_STREAM_DTYPES = (torch.float32, torch.bfloat16)
_MAX_NODES = 32  # csrc kMaxNodes
_LIB = "dcgru_recurrence"

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


def _outputs(like, t, b, n, h_units, dtype, residuals):
    mk = lambda w: torch.empty((t, b, n, w), dtype=dtype, device=like.device)
    if residuals:
        return mk(h_units), mk(2 * h_units), mk(h_units)
    return mk(h_units), None, None


# ---------------------------------------------------------------------------
# Plain versions (same function, torch ops, a Python loop over T)
# ---------------------------------------------------------------------------


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
        feats = _apply_ops(a_ops, torch.cat([h, x[ti].float()], dim=-1))
        hf, xf = feats[..., :h_units], feats[..., h_units:]
        ru = torch.sigmoid(_contract_w(xf, wxg_r) + _contract_w(hf, wg_r)
                           + gate_b)
        r, u = ru[..., :h_units], ru[..., h_units:]
        c = act(_contract_w(xf, wxc_r)
                + _contract_w(_apply_ops(a_ops, r * h), wc_r) + cand_b)
        h = u * h + (1.0 - u) * c
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


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check(name, stream, a_ops, weights, h0, activation, b, n, h_units):
    if stream.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {stream.device} are neither "
                         "on the CPU nor on a CUDA device")
    if stream.dtype not in _STREAM_DTYPES:
        raise TypeError(f"{name}: stream dtype {stream.dtype} is not "
                        "float32 or bfloat16")
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
    if tuple(h0.shape) != (b, n, h_units):
        raise ValueError(f"{name}: h0 {tuple(h0.shape)} != {(b, n, h_units)}")
    for t in (stream, a_ops, h0, *weights):
        if t.device != stream.device:
            raise ValueError(f"{name}: tensors on {t.device} and "
                             f"{stream.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    for t in (a_ops, h0, *weights):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: operators, weights, biases and h0 "
                            f"must be float32, got {t.dtype}")


def _raise_on(err: int, name: str):
    if err != 0:
        msg = _lib().dcgru_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def _ptr(t):
    return None if t is None else t.data_ptr()


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
    _check(name, x, a_ops, weights, h0, activation, b, n, h_units)
    if d % 4:
        raise ValueError(f"{name}: D={d} is not a multiple of 4")
    shapes = ((m * d, 2 * h_units), (m * d, h_units), (m, h_units, 2 * h_units),
              (m, h_units, h_units), (2 * h_units,), (h_units,))
    for w, want in zip(weights, shapes):
        if tuple(w.shape) != want:
            raise ValueError(f"{name}: weight {tuple(w.shape)} != {want}")
    h_seq, ru_seq, c_seq = _outputs(x, t, b, n, h_units, x.dtype, residuals)
    if b == 0 or t == 0:
        return h_seq, ru_seq, c_seq
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().dcgru_recurrence_xin_fwd(
            x.data_ptr(), a_ops.data_ptr(), a_ops.shape[1],
            *(w.data_ptr() for w in weights), h0.data_ptr(),
            h_seq.data_ptr(), _ptr(ru_seq), _ptr(c_seq),
            t, b, n, d, h_units, m, _ACT_CODES[activation],
            int(x.dtype == torch.bfloat16), stream)
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
    _check(name, x_proj, a_ops, weights, h0, activation, b, n, h_units)
    shapes = ((m, h_units, 2 * h_units), (m, h_units, h_units),
              (2 * h_units,), (h_units,))
    if w3 != 3 * h_units:
        raise ValueError(f"{name}: x_proj width {w3} != 3H = {3 * h_units}")
    for w, want in zip(weights, shapes):
        if tuple(w.shape) != want:
            raise ValueError(f"{name}: weight {tuple(w.shape)} != {want}")
    h_seq, ru_seq, c_seq = _outputs(x_proj, t, b, n, h_units, x_proj.dtype,
                                    residuals)
    if b == 0 or t == 0:
        return h_seq, ru_seq, c_seq
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream(x_proj.device).cuda_stream
        err = _lib().dcgru_recurrence_fwd(
            x_proj.data_ptr(), a_ops.data_ptr(), a_ops.shape[1],
            *(w.data_ptr() for w in weights), h0.data_ptr(),
            h_seq.data_ptr(), _ptr(ru_seq), _ptr(c_seq),
            t, b, n, h_units, m, _ACT_CODES[activation],
            int(x_proj.dtype == torch.bfloat16), stream)
    _raise_on(err, name)
    dcgru_recurrence_fwd.launches += 1
    return h_seq, ru_seq, c_seq


dcgru_recurrence_fwd.launches = 0
