"""One fused diffusion convolution: its CUDA kernel, the kernel's wrapper,
its plain PyTorch version and the autograd Function built on them.

:func:`fused_diffusion_conv_fwd` replaces the JAX package's Pallas kernel
``_kernel`` (``eeg_gnn_tpu/ops/pallas_kernels.py:32``, launched from
``_fused_forward``): the Chebyshev recurrence over per-clip supports (with
the cross-support carry-over quirk of ``ops/diffusion.py``), each term
times its weight block, plus the bias, in one launch
(``csrc/fused_diffusion_conv.cu``; products on tensor cores in 3xTF32).
Only the ``use_pallas`` per-step loop of ``models/dcgru._layer_scan``
runs it: two launches per step and layer.

The kernel takes its operands staged as tensor-core fragments
(:func:`stage_fdc_operands`): the per-clip supports, split into TF32 hi
and lo, and each weight's W^T. The loop stages a layer's once a forward,
before its T steps, and hands them to every launch; a call without them
stages them itself.

The wrapper computes with the plain version when its input lies on the
CPU, launches the kernel when it lies on a CUDA device, and raises
otherwise or on what the kernel does not take; it counts its launches in
``fused_diffusion_conv_fwd.launches``.

Weight layout: the reference-layout (D*M, O) weight (row ``d*M + m``) is
re-laid to (M, D, O) by :func:`rearrange_weight`, so each term's weight
block is contiguous; :func:`restore_weight` inverts it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from eeg_gnn_tpu_torch.ops import _build
from eeg_gnn_tpu_torch.ops.cuda_recurrent import (
    _chain_tiles,
    _tile_layout,
    round_tf32,
)
from eeg_gnn_tpu_torch.ops.diffusion import diffusion_conv

_MAX_NODES = 32  # csrc kMaxNodes
_LIB = "fused_diffusion_conv"

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(_build.load(_LIB))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a ``csrc/fused_diffusion_conv.cu``
    library."""
    lib.fused_diffusion_conv_fwd.argtypes = [_P] * 5 + [_I] * 7 + [_P]
    lib.fused_diffusion_conv_fwd.restype = _I
    lib.fdc_plan_of.argtypes = [_I] * 7 + [_P]
    lib.fdc_plan_of.restype = _I
    lib.fdc_error_string.argtypes = [_I]
    lib.fdc_error_string.restype = ctypes.c_char_p
    return lib


def rearrange_weight(w, input_dim: int, num_matrices: int):
    """(D*M, O) reference-layout weight (row ``d*M + m``) -> (M, D, O)."""
    return w.reshape(input_dim, num_matrices, -1).transpose(0, 1)


def restore_weight(w_mdo):
    """(M, D, O) -> the reference (D*M, O) layout (inverse of
    :func:`rearrange_weight`)."""
    m, d, o = w_mdo.shape
    return w_mdo.transpose(0, 1).reshape(d * m, o)


def fdc_support_frags(supports):
    """The per-clip supports (S, B, N, N) as the kernel's tensor-core A
    fragments (:func:`cuda_recurrent._tile_layout`, m16n8k8 tiles), split
    into TF32 hi and lo: (B, S, RT, KT, 2, 32, 4) float32, a clip's S
    supports in one span."""
    tiles = _tile_layout(supports.transpose(0, 1), False)
    hi = round_tf32(tiles)
    return torch.stack([hi, tiles - hi], dim=-3).contiguous()


def fdc_weight_frags(w_mdo):
    """W^T (O x M*D) of an (M, D, O) weight as the kernel's float32 A
    fragments (split into 3xTF32 as it reads them): (ORT, WKT, 32, 4)."""
    m, d, o = w_mdo.shape
    return _chain_tiles(w_mdo.reshape(m * d, o).t(), False).contiguous()


def stage_fdc_operands(supports, *w_mdos):
    """The operands of :func:`fused_diffusion_conv_fwd` as the kernel
    takes them, staged once for every launch that shares them (the
    ``use_pallas`` loop: a layer's supports and its gate and candidate
    weights, once a forward): (support fragments, (one weight's fragments
    per ``w_mdos``)). They take no gradient."""
    with torch.no_grad():
        return (fdc_support_frags(supports),
                tuple(fdc_weight_frags(w) for w in w_mdos))


def fdc_plan(s: int, b: int, n: int, d: int, o: int, k: int) -> dict:
    """The launch plan the kernel takes at a shape, on the current CUDA
    device: blocks, threads, shared bytes a block, warps a 16-row tile of
    O (splitting the depth), and whether the weights sit in shared
    memory."""
    out = (ctypes.c_int * 5)()
    err = _lib().fdc_plan_of(s, b, n, d, o, k, s * k + 1,
                             ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"fdc_plan_of: CUDA error {err}")
    keys = ("blocks", "threads", "smem_bytes", "ksplit", "weights_in_smem")
    return dict(zip(keys, list(out)))


def fused_diffusion_conv_plain(supports, x, w_mdo, bias,
                               max_diffusion_step: int):
    """Plain version of :func:`fused_diffusion_conv_fwd` (same arguments and
    result): ``ops/diffusion.diffusion_conv`` on the restored weight."""
    return diffusion_conv(supports, x, restore_weight(w_mdo), bias,
                          max_diffusion_step)


def fused_diffusion_conv_fwd(supports, x, w_mdo, bias,
                             max_diffusion_step: int, staged=None):
    """One diffusion conv through the CUDA kernel.

    Args:
        supports: (S, B, N, N) per-clip supports, float32.
        x: (B, N, D) node features, float32, D a multiple of 4.
        w_mdo: (M, D, O) weight from :func:`rearrange_weight`, M = S*K + 1.
        bias: (O,).
        max_diffusion_step: K.
        staged: (support fragments, weight fragments) of these supports
            and this weight (:func:`stage_fdc_operands`), or None to stage
            them here.

    Returns:
        (B, N, O) float32, equal to ``ops.diffusion.diffusion_conv`` on the
        restored weight: the products in 3xTF32 (~float32).
    """
    if x.device.type == "cpu":
        return fused_diffusion_conv_plain(supports, x, w_mdo, bias,
                                          max_diffusion_step)
    name = "fused_diffusion_conv_fwd"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: tensors on {x.device} are neither on the "
                         "CPU nor on a CUDA device")
    if supports.ndim != 4 or x.ndim != 3 or w_mdo.ndim != 3 or bias.ndim != 1:
        raise ValueError(
            f"{name}: takes supports (S, B, N, N), x (B, N, D), w (M, D, O) "
            f"and bias (O,), got {tuple(supports.shape)}, {tuple(x.shape)}, "
            f"{tuple(w_mdo.shape)}, {tuple(bias.shape)}")
    s, b, n, _ = supports.shape
    m, d, o = w_mdo.shape
    k = int(max_diffusion_step)
    if tuple(supports.shape) != (s, x.shape[0], x.shape[1], x.shape[1]) \
            or x.shape[2] != d or m != s * k + 1 or bias.shape[0] != o:
        raise ValueError(
            f"{name}: shapes disagree: supports {tuple(supports.shape)}, x "
            f"{tuple(x.shape)}, w {tuple(w_mdo.shape)} (M = S*K + 1 = "
            f"{s * k + 1}), bias {tuple(bias.shape)}")
    if n > _MAX_NODES:
        raise ValueError(f"{name}: {n} nodes > the kernel's {_MAX_NODES}")
    if d % 4:
        raise ValueError(f"{name}: D={d} is not a multiple of 4")
    for t in (supports, x, w_mdo, bias):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: takes float32 tensors, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    out = torch.empty((b, n, o), dtype=torch.float32, device=x.device)
    if b == 0:
        return out
    with torch.cuda.device(x.device):
        if staged is None:
            sup_f, (w_f,) = stage_fdc_operands(supports, w_mdo)
        else:
            sup_f, w_f = staged
        rt, kt = -(-n // 16), -(-n // 8)
        want = ((b, s, rt, kt, 2, 32, 4), (-(-o // 16), -(-(m * d) // 8),
                                           32, 4))
        for t, shape in zip((sup_f, w_f), want):
            if tuple(t.shape) != shape or t.dtype != torch.float32 \
                    or t.device != x.device or not t.is_contiguous():
                raise ValueError(
                    f"{name}: staged operands {t.dtype} {tuple(t.shape)} "
                    f"are not contiguous float32 {shape} on {x.device}")
        err = _lib().fused_diffusion_conv_fwd(
            sup_f.data_ptr(), x.data_ptr(), w_f.data_ptr(),
            bias.data_ptr(), out.data_ptr(), s, b, n, d, o, k, m,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = _lib().fdc_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    fused_diffusion_conv_fwd.launches += 1
    return out


fused_diffusion_conv_fwd.launches = 0


class _FusedDiffusionConv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, supports, x, w_mdo, bias, max_diffusion_step, staged):
        out = fused_diffusion_conv_fwd(supports, x, w_mdo, bias,
                                       max_diffusion_step, staged)
        ctx.save_for_backward(supports, x, w_mdo, bias)
        ctx.k = max_diffusion_step
        return out

    @staticmethod
    def backward(ctx, g):
        supports, x, w_mdo, bias = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (x, w_mdo, bias)]
            out = fused_diffusion_conv_plain(supports, *leaves, ctx.k)
            dx, dw, db = torch.autograd.grad(out, leaves, g)
        return None, dx, dw, db, None, None


def fused_diffusion_conv(supports, x, w_mdo, bias, max_diffusion_step: int,
                         staged=None):
    """Differentiable :func:`fused_diffusion_conv_fwd` (same arguments).

    The forward is the kernel. The backward is the VJP of the plain
    ``ops/diffusion.diffusion_conv`` on the restored weight, as the JAX
    package's ``_fused_bwd`` (``pallas_kernels.py:122-135``) takes XLA's:
    the JAX package has no backward kernel for this convolution, so the
    port has none either. It returns dx, dW in the (M, D, O) layout and
    dbias, and no gradient for the supports or the staged operands.
    """
    return _FusedDiffusionConv.apply(supports, x, w_mdo, bias,
                                     max_diffusion_step, staged)
