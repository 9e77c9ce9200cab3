"""Whole-sequence DCGRU layer recurrence: CUDA kernels, their wrappers,
their plain PyTorch versions, and the autograd Functions built on them.

They replace the JAX package's Pallas kernels
(``eeg_gnn_tpu/ops/pallas_recurrent.py``):

- :func:`dcgru_recurrence_fwd` <- ``_fwd_kernel``
  (``csrc/dcgru_recurrence.cu``): the recurrence fed a precomputed fused
  ``x_proj = [gate | cand]`` (T, B, N, 3H) stream (``--no_input_fusion``);
- :func:`dcgru_recurrence_bwd` <- ``_bwd_kernel``: its BPTT, as three
  kernels: the state loop :func:`dcgru_xin_bwd_loop`
  (``csrc/dcgru_recurrence_bwd.cu``), the bulk :func:`dcgru_xin_dw` at
  D = 0 (the layer has no x; one f32 partial slab per fixed split of the
  (t, b) pairs) and :func:`dcgru_dw_reduce`, which sums the partials in a
  fixed order (the TPU kernels summed into one resident block across
  their sequential grid); dx_proj is the loop's dpre in the stream dtype;
- :func:`dcgru_recurrence_xin_fwd` <- ``_fwd_kernel_xin``: the default
  ``input_fusion`` path, fed the raw (T, B, N, D) layer input. Two
  kernels: the bulk input projection :func:`dcgru_xin_proj`
  (``csrc/dcgru_xin_gemm.cu``) over all T steps at once, then
  :func:`dcgru_xin_fwd_loop`, the loop of :func:`dcgru_recurrence_fwd`
  fed that f32 projection, which it adds unrounded as the TPU kernel adds
  ``xg`` (``:766-767``);
- :func:`dcgru_recurrence_xin_bwd` <- ``_bwd_kernel_xin``: its BPTT.
  :func:`dcgru_xin_bwd_loop` carries only the state cotangent and writes
  ``dpre = [dru_pre | dc_pre]`` in f32; then the bulk kernels
  :func:`dcgru_xin_dw` (``dWx = sum (A x)^T dpre``, ``dWg = sum (A
  h_prev)^T dru_pre``, ``dWc = sum (A (r h_prev))^T dc_pre``, ``db = sum
  dpre``, the features recomputed from the streams as the TPU kernel does,
  ``:820-838``; one f32 partial slab per fixed split of the (t, b) pairs,
  summed by :func:`dcgru_dw_reduce`) and, when dx is asked for,
  :func:`dcgru_xin_dx` (``dx = sum_m A_m^T (dpre Wx_m^T)``), over all T
  steps at once. No dW is accumulated in the serial loop.

The two state loops (:func:`dcgru_xin_fwd_loop` / :func:`dcgru_recurrence_fwd`
and :func:`dcgru_xin_bwd_loop`) run each step's hidden products on tensor
cores, with the weights staged once per launch in shared memory:
:func:`stage_chain_weights` lays them out as the kernels' A fragments, in
bfloat16 for bf16 streams (the reference's one bf16 pass) and float32 for
f32 streams (split into 3xTF32 in the kernel).

Each wrapper computes the kernel's function with its plain version when
its input lies on the CPU, launches the kernel when it lies on a CUDA
device, and raises otherwise or on what the kernel does not take. Each
counts its launches in ``<wrapper>.launches``. The two xin wrappers and
:func:`dcgru_recurrence_bwd` launch no kernel of their own and have no
counter: their kernels count.

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
_LIB_XIN = "dcgru_xin_gemm"

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind_fwd(_build.load(_LIB))


def bind_fwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a ``csrc/dcgru_recurrence.cu`` library."""
    lib.dcgru_recurrence_fwd.argtypes = (
        [_P, _P, _I] + [_P] * 4 + [_P, _P, _P] + [_I] * 8 + [_P])
    lib.dcgru_recurrence_fwd.restype = _I
    lib.dcgru_error_string.argtypes = [_I]
    lib.dcgru_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib_bwd() -> ctypes.CDLL:
    return bind_bwd(_build.load(_LIB_BWD))


def bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a ``csrc/dcgru_recurrence_bwd.cu``
    library."""
    lib.dcgru_xin_bwd_loop.argtypes = (
        [_P, _I, _P] + [_P] * 4 + [_P] * 2 + [_I] * 7 + [_P])
    lib.dcgru_xin_bwd_loop.restype = _I
    lib.dcgru_dw_reduce.argtypes = [_P, _P, _I, _I, _P]
    lib.dcgru_dw_reduce.restype = _I
    lib.dcgru_error_string.argtypes = [_I]
    lib.dcgru_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib_xin() -> ctypes.CDLL:
    return bind_xin(_build.load(_LIB_XIN))


def bind_xin(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a ``csrc/dcgru_xin_gemm.cu`` library."""
    for fn in (lib.dcgru_xin_proj, lib.dcgru_xin_dx):
        fn.argtypes = [_P, _P, _I, _P, _P] + [_I] * 7 + [_P]
        fn.restype = _I
    lib.dcgru_xin_bulk_plan.argtypes = [_I] * 9 + [_P]
    lib.dcgru_xin_bulk_plan.restype = _I
    lib.dcgru_xin_dw.argtypes = [_P] * 5 + [_I, _P, _I] + [_I] * 7 + [_P]
    lib.dcgru_xin_dw.restype = _I
    lib.dcgru_error_string.argtypes = [_I]
    lib.dcgru_error_string.restype = ctypes.c_char_p
    return lib


DW_WAVE_BLOCKS = 132  # blocks of a wave: the H100's SMs, csrc kDwWaveBlocks
DW_SPLIT_PAIRS = 192  # (t, b) pairs of a dW split, at most: csrc kDwSplitPairs
DW_TILES = 11         # 16-feature tiles of a dW block: csrc kDwTiles


def dw_blocks(m: int, d: int, h_units: int) -> int:
    """The blocks of one split of :func:`dcgru_xin_dw`: one per m, per
    64-column tile of the 2H gate and the H candidate columns, per group of
    DW_TILES 16-feature tiles of [x | h_prev]."""
    tiles = -(-d // 16) + -(-h_units // 16)
    cols = -(-2 * h_units // 64) + -(-h_units // 64)
    return m * cols * -(-tiles // DW_TILES)


def dw_splits(pairs: int, m: int, d: int, h_units: int) -> int:
    """The splits of ``pairs`` = T*B (t, b) pairs into
    :func:`dcgru_xin_dw`'s partials, on every device: whole waves of
    DW_WAVE_BLOCKS blocks (:func:`dw_blocks` a split), the fewest whose
    splits hold at most DW_SPLIT_PAIRS pairs each, none empty. Split s sums
    the pairs [s*per, (s+1)*per), per = ceil(pairs / splits). The count
    follows from the shape alone, so dW and db are summed in the same
    order on any card (and by the plain version)."""
    per_split = dw_blocks(m, d, h_units)
    waves = 1
    while True:
        splits = max(1, waves * DW_WAVE_BLOCKS // per_split)
        if -(-pairs // splits) <= DW_SPLIT_PAIRS or splits >= pairs:
            return -(-pairs // -(-pairs // splits))
        waves += 1


def _tile_layout(a, bf16: bool):
    """The elements of one (R, K) A operand (or a stack of them, (..., R,
    K)) in the order of the kernels' tensor-core A fragments
    (``csrc/dcgru_common.cuh``, ``ChainOps``), in ``a``'s dtype:
    zero-padded to 16-row tiles by 16-deep (bf16, m16n8k16) or 8-deep
    (f32, m16n8k8) tiles, each tile 32 lanes x 16 bytes of the operand
    type, lane ``4g + t`` holding rows g and g+8 and the columns of its
    fragment: (..., RT, KT, 32, 8) for bf16, (..., RT, KT, 32, 4) for
    f32."""
    *lead, r, k = a.shape
    depth = 16 if bf16 else 8
    rt, kt = -(-r // 16), -(-k // depth)
    pad = a.new_zeros((*lead, rt * 16, kt * depth))
    pad[..., :r, :k] = a
    keep = tuple(range(len(lead)))
    at = lambda *dims: keep + tuple(len(lead) + d for d in dims)
    if bf16:
        # row 16 rt + 8 hr + g, column 16 kt + 8 hc + 2 t + e -> lane 4g + t,
        # element 2 (hr + 2 hc) + e
        tiles = pad.view(*lead, rt, 2, 8, kt, 2, 4, 2).permute(
            at(0, 3, 2, 5, 4, 1, 6))
        return tiles.reshape(*lead, rt, kt, 32, 8)
    # row 16 rt + 8 hr + g, column 8 kt + 4 hc + t -> lane 4g + t, word
    # hr + 2 hc
    tiles = pad.view(*lead, rt, 2, 8, kt, 2, 4).permute(at(0, 3, 2, 5, 4, 1))
    return tiles.reshape(*lead, rt, kt, 32, 4)


def round_tf32(v):
    """float32 ``v`` rounded to TF32's 10 mantissa bits, ties away from
    zero: the bits of ``round_tf32`` in ``csrc/dcgru_common.cuh``."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def dw_op_frags(a_ops, bf16: bool, transpose: bool = True,
                batch_major: bool = False):
    """The operators A_1..A_{M-1} of every clip, transposed (the bulk dW
    and dx kernels') or as they are (the bulk projection's), as the
    kernels' tensor-core A fragments (:func:`_tile_layout` of each A_m^T
    or A_m): bfloat16, rounded to nearest (bf16 streams: one bf16 pass,
    m16n8k16 tiles), or float32 split into TF32 hi and lo (f32 streams:
    3xTF32, m16n8k8 tiles). (M-1, a_batch, RT, KT, 32, 8) bf16 or (M-1,
    a_batch, RT, KT, 2, 32, 4) f32 [hi | lo]; with ``batch_major`` the
    first two axes swap (the projection's and dx's: a chunk's clips'
    operators in one span)."""
    ops = a_ops[1:]
    if batch_major:
        ops = ops.transpose(0, 1)
    tiles = _tile_layout(ops.transpose(-1, -2) if transpose else ops, bf16)
    if bf16:
        return tiles.to(torch.bfloat16).contiguous()
    hi = round_tf32(tiles)
    return torch.stack([hi, tiles - hi], dim=-3).contiguous()


def xin_op_rows(a_ops, transpose: bool):
    """The operators A_1..A_{M-1} of every clip as the f32 bulk projection
    (Op_m = A_m) or dx (``transpose``: Op_m = A_m^T) diffuses with them,
    in f32 FMAs: Op_m^T, row j holding Op_m[n, j] for the nodes n, the
    nodes zero-padded to whole blocks of 4; clip major. (a_batch, M-1, N,
    4 ceil(N/4)) float32."""
    ops = a_ops[1:].transpose(0, 1)
    n = ops.shape[-1]
    rows = a_ops.new_zeros((*ops.shape[:2], n, 4 * -(-n // 4)))
    rows[..., :n] = ops if transpose else ops.transpose(-1, -2)
    return rows


def xin_weight_frags(wx_parts, m: int, transpose: bool, bf16: bool):
    """The x-in layer's input weights as the bulk projection's (Wx_m, D x
    3H) or dx's (``transpose``: Wx_m^T, 3H x D) tensor-core B operands,
    staged once a launch from the (M*D, w) column blocks ``wx_parts`` of
    [Wxg | Wxc] (m-major rows) without joining them first. Each V_m is
    zero-padded to KT k tiles by NT = ceil(C/8) 8-column groups.

    bf16 (``xin_bulk_kernel``'s mma.m16n8k16 B fragments): 16-deep k
    tiles, each n8 tile 32 lanes x 8 bytes, lane 4g + t holding rows 2t,
    2t+1, 2t+8, 2t+9 of column g, rounded to nearest; (M, KT, NT, 32, 4)
    bfloat16.

    float32 (``xin_bulk_tf32_wgmma_kernel``'s wgmma B operand, K-major,
    no swizzle): 8-deep k steps, each split into a TF32 hi plane and a lo
    plane (V_m - hi), each plane NT groups of two 8 x 4 core matrices
    (columns 8j..8j+7 by k rows 4h..4h+3, a column's 4 k values
    contiguous); (M, KT, 2 [hi | lo], NT, 2, 8, 4) float32."""
    d = wx_parts[0].shape[0] // m
    h3 = sum(w.shape[1] for w in wx_parts)
    k, c = (h3, d) if transpose else (d, h3)
    depth = 16 if bf16 else 8
    kt, nt = -(-k // depth), -(-c // 8)
    v = wx_parts[0].new_zeros((m, kt * depth, nt * 8))
    col = 0
    for part in wx_parts:
        w = part.reshape(m, d, -1)
        width = w.shape[-1]
        if transpose:
            v[:, col:col + width, :d] = w.transpose(1, 2)
        else:
            v[:, :d, col:col + width] = w
        col += width
    if bf16:
        # row 16 kt + 8 hk + 2 t + e, column 8 n + g -> lane 4 g + t,
        # element 2 hk + e
        tiles = v.view(m, kt, 2, 4, 2, nt, 8).permute(0, 1, 5, 6, 3, 2, 4)
        return tiles.reshape(m, kt, nt, 32, 4).to(torch.bfloat16).contiguous()
    # row 8 kt + 4 h + c, column 8 j + r -> [kt, j, h, r, c]
    tiles = v.view(m, kt, 2, 4, nt, 8).permute(0, 1, 4, 2, 5, 3)
    hi = round_tf32(tiles)
    return torch.stack([hi, tiles - hi], dim=2).contiguous()


def xin_bulk_plan(proj: bool, t: int, b: int, n: int, d: int, h_units: int,
                  m: int, a_batch: int, bf16: bool) -> dict:
    """The launch plan :func:`dcgru_xin_proj` (``proj``) or
    :func:`dcgru_xin_dx` takes at a shape, on the current CUDA device: the
    chunk, the column tile, threads, shared bytes, blocks and row strides;
    for f32 streams also the consumer warpgroups and the weight ring's
    slots (0 for bf16)."""
    out = (ctypes.c_int * 13)()
    err = _lib_xin().dcgru_xin_bulk_plan(int(proj), t, b, n, d, h_units, m,
                                         a_batch, int(bf16),
                                         ctypes.addressof(out))
    _raise_on(err, "dcgru_xin_bulk_plan", _lib_xin)
    keys = ("pairs_per_chunk", "rows_per_chunk", "cols_per_block",
            "col_tiles", "threads", "smem_bytes", "blocks_per_col_tile",
            "blocks_per_sm", "in_tensor_map", "ld_in", "ld_f",
            "warpgroups", "weight_slots")
    return dict(zip(keys, list(out)))


def _chain_tiles(a, bf16: bool):
    """One (R, K) float32 A operand as the kernels' tensor-core A fragments
    (:func:`_tile_layout`): bfloat16 for bf16 operands (rounded to
    nearest), float32 for 3xTF32."""
    tiles = _tile_layout(a, bf16)
    return tiles.to(torch.bfloat16) if bf16 else tiles


def stage_chain_weights(mats, bf16: bool):
    """The A operands of a state loop's per-step products, staged once per
    launch: each (R, K) float32 matrix as :func:`_chain_tiles`, flat and
    concatenated in order, bfloat16 (the bf16 streams' operands, rounded
    to nearest) or float32 (split into 3xTF32 by the kernel)."""
    return torch.cat([_chain_tiles(a, bf16).reshape(-1) for a in mats])


def fwd_loop_weights(wg_r, wc_r, bf16: bool):
    """The forward loop's staged weights [Wg^T (2H, M*H) | Wc^T (H, M*H)]."""
    m, h_units, _ = wc_r.shape
    return stage_chain_weights((wg_r.reshape(m * h_units, -1).t(),
                                wc_r.reshape(m * h_units, -1).t()), bf16)


def bwd_loop_weights(wg_r, wc_r, bf16: bool):
    """The backward loop's staged weights [Wc (M*H, H) | Wg (M*H, 2H)]."""
    m, h_units, _ = wc_r.shape
    return stage_chain_weights((wc_r.reshape(m * h_units, -1),
                                wg_r.reshape(m * h_units, -1)), bf16)


def _outputs(like, t, b, n, h_units, dtype, residuals):
    mk = lambda w: torch.empty((t, b, n, w), dtype=dtype, device=like.device)
    if residuals:
        return mk(h_units), mk(2 * h_units), mk(h_units)
    return mk(h_units), None, None


def dw_size(m: int, d: int, h_units: int) -> int:
    """Floats of one dW partial slab: [dWxg (M*D, 2H) | dWxc (M*D, H) |
    dWg (M*H, 2H) | dWc (M*H, H) | dbg (2H) | dbc (H)]; d=0 for the
    hoisted layer's, which have no dWx."""
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
    return dcgru_xin_fwd_loop_plain(x_proj, a_ops, wg_r, wc_r, gate_b,
                                    cand_b, h0, activation, residuals,
                                    x_proj.dtype)


def dcgru_xin_fwd_loop_plain(xp, a_ops, wg_r, wc_r, gate_b, cand_b, h0,
                             activation="tanh", residuals=False,
                             stream_dtype=torch.float32):
    """Plain version of :func:`dcgru_xin_fwd_loop`: results in
    ``stream_dtype``."""
    h_units = h0.shape[-1]
    xp = xp.float()
    _, h_seq, ru_seq, c_seq = _scan_forward(
        a_ops, xp[..., :2 * h_units], xp[..., 2 * h_units:], wg_r, wc_r,
        gate_b, cand_b, h0, activation, stream_dtype)
    h_seq = h_seq.to(stream_dtype)
    return (h_seq, ru_seq, c_seq) if residuals else (h_seq, None, None)


def dcgru_recurrence_bwd_plain(a_ops, wg_r, wc_r, h_prev, ru_seq, c_seq,
                               d_seq, activation="tanh"):
    """Plain version of :func:`dcgru_recurrence_bwd`: the reverse loop of
    ``ops/recurrent.py``; dxp = [dru_pre | dc_pre] in the stream dtype."""
    dgx, dcx, dwg, dwc, dbg, dbc, dh0 = _scan_backward(
        a_ops, wg_r, wc_r, h_prev, ru_seq, c_seq, d_seq, activation)
    dxp = torch.cat([dgx, dcx], dim=-1).to(h_prev.dtype)
    return dxp, dwg, dwc, dbg, dbc, dh0


def dcgru_xin_bwd_loop_plain(a_ops, wg_r, wc_r, h_prev, ru_seq, c_seq,
                             d_seq, activation="tanh"):
    """Plain version of :func:`dcgru_xin_bwd_loop`: the reverse loop of
    ``ops/recurrent.py``; (dpre (T, B, N, 3H) float32, dh0)."""
    dgx, dcx, _, _, _, _, dh0 = _scan_backward(
        a_ops, wg_r, wc_r, h_prev, ru_seq, c_seq, d_seq, activation)
    return torch.cat([dgx, dcx], dim=-1), dh0


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


def dcgru_xin_proj_plain(x, a_ops, wx):
    """Plain version of :func:`dcgru_xin_proj`."""
    m = a_ops.shape[0]
    feats = _apply_ops(a_ops, x.float())  # (M, T, B, N, D)
    return torch.tensordot(feats, wx.reshape(m, x.shape[-1], -1),
                           dims=([0, 4], [0, 1]))


def dcgru_xin_dx_plain(a_ops, wx, dpre, dtype):
    """Plain version of :func:`dcgru_xin_dx`."""
    m = a_ops.shape[0]
    wx_r = wx.reshape(m, wx.shape[0] // m, -1)
    dy = torch.movedim(torch.tensordot(dpre, wx_r, dims=([3], [2])), 3, 0)
    return _apply_ops_t(a_ops, dy).to(dtype)


def dcgru_xin_dw_plain(a_ops, h_prev, ru_seq, x, dpre, splits=None):
    """Plain version of :func:`dcgru_xin_dw`: the same split partials
    (``splits`` of them; by default :func:`dw_splits`, the kernel's
    count); a zero-width x (D = 0, the hoisted layer's) adds no dWx."""
    t, b, n, _ = x.shape
    h_units = h_prev.shape[-1]
    pairs = t * b
    if splits is None:
        splits = dw_splits(pairs, a_ops.shape[0], x.shape[-1], h_units)
    per = max(1, -(-pairs // splits))
    flat = lambda s: s.reshape(pairs, n, s.shape[-1]).float()
    xs, hs, gs = flat(x), flat(h_prev), flat(dpre)
    rhs = flat(ru_seq)[..., :h_units] * hs
    out = []
    for s in range(splits):
        sl = slice(min(pairs, s * per), min(pairs, (s + 1) * per))
        a = a_ops
        if a_ops.shape[1] != 1:  # pair p is clip p % B
            a = a_ops[:, torch.arange(sl.start, sl.stop,
                                      device=a_ops.device) % b]
        g = gs[sl]
        dw = lambda src, cols: torch.einsum(
            "mpnk,pnj->mkj", _apply_ops(a, src[sl]), g[..., cols])
        dwx = dw(xs, slice(None))
        dwx = dwx.reshape(-1, dwx.shape[-1])
        out.append(torch.cat([
            dwx[:, :2 * h_units].reshape(-1), dwx[:, 2 * h_units:].reshape(-1),
            dw(hs, slice(0, 2 * h_units)).reshape(-1),
            dw(rhs, slice(2 * h_units, None)).reshape(-1),
            g.sum(dim=(0, 1))]))
    return torch.stack(out)


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


def _check_aligned(name, t):
    """The bulk kernels copy their input's rows by TMA from a 16-byte
    aligned start (a fresh allocation's)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes a 16-byte aligned "
                         "input (a view at an offset is not)")


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
    """One DCGRU layer over all T steps, fed its raw input.

    On a CUDA device: the bulk input projection (:func:`dcgru_xin_proj`,
    float32) over all T steps, then the state loop
    (:func:`dcgru_xin_fwd_loop`).

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
    if b == 0 or t == 0:
        return _outputs(x, t, b, n, h_units, x.dtype, residuals)
    xp = dcgru_xin_proj(x, a_ops, (wxg_f, wxc_f))
    return dcgru_xin_fwd_loop(xp, a_ops, wg_r, wc_r, gate_b, cand_b, h0,
                              activation, residuals, x.dtype)


def _fwd_loop(wrapper, x_proj, a_ops, wg_r, wc_r, gate_b, cand_b, h0,
              activation, residuals, stream_dtype):
    """Launch the state loop of ``csrc/dcgru_recurrence.cu`` for
    ``wrapper`` (its name in errors, its launch count): x_proj in the
    stream dtype, or float32."""
    name = wrapper.__name__
    t, b, n, w3 = x_proj.shape
    m = a_ops.shape[0]
    h_units = h0.shape[-1]
    weights = (wg_r, wc_r, gate_b, cand_b)
    _check(name, (x_proj,), a_ops, (*weights, h0), activation, b, n,
           h_units)
    if stream_dtype not in _STREAM_DTYPES:
        raise TypeError(f"{name}: stream dtype {stream_dtype} is not "
                        "float32 or bfloat16")
    if w3 != 3 * h_units:
        raise ValueError(f"{name}: x_proj width {w3} != 3H = {3 * h_units}")
    _check_shapes(name, "h0", (h0,), ((b, n, h_units),))
    _check_shapes(name, "weight", weights, (
        (m, h_units, 2 * h_units), (m, h_units, h_units), (2 * h_units,),
        (h_units,)))
    h_seq, ru_seq, c_seq = _outputs(x_proj, t, b, n, h_units, stream_dtype,
                                    residuals)
    if b == 0 or t == 0:
        return h_seq, ru_seq, c_seq
    bf16 = stream_dtype == torch.bfloat16
    with torch.cuda.device(x_proj.device):
        w = fwd_loop_weights(wg_r, wc_r, bf16)
        err = _lib().dcgru_recurrence_fwd(
            x_proj.data_ptr(), a_ops.data_ptr(), a_ops.shape[1],
            w.data_ptr(), gate_b.data_ptr(), cand_b.data_ptr(),
            h0.data_ptr(), h_seq.data_ptr(), _ptr(ru_seq), _ptr(c_seq),
            t, b, n, h_units, m, _ACT_CODES[activation], int(bf16),
            int(x_proj.dtype != stream_dtype), _stream(x_proj))
    _raise_on(err, name)
    wrapper.launches += 1
    return h_seq, ru_seq, c_seq


def dcgru_recurrence_fwd(x_proj, a_ops, wg_r, wc_r, gate_b, cand_b, h0,
                         activation="tanh", residuals=False):
    """One DCGRU layer over all T steps fed a precomputed fused input
    projection ``x_proj`` (T, B, N, 3H) = [gate (2H) | cand (H)], without
    biases, in the stream dtype. Other arguments and results as
    :func:`dcgru_recurrence_xin_fwd`."""
    if x_proj.device.type == "cpu":
        return dcgru_recurrence_fwd_plain(x_proj, a_ops, wg_r, wc_r, gate_b,
                                          cand_b, h0, activation, residuals)
    return _fwd_loop(dcgru_recurrence_fwd, x_proj, a_ops, wg_r, wc_r, gate_b,
                     cand_b, h0, activation, residuals, x_proj.dtype)


dcgru_recurrence_fwd.launches = 0


def dcgru_xin_fwd_loop(xp, a_ops, wg_r, wc_r, gate_b, cand_b, h0,
                       activation="tanh", residuals=False,
                       stream_dtype=torch.float32):
    """The state loop of :func:`dcgru_recurrence_xin_fwd`: the kernel of
    :func:`dcgru_recurrence_fwd` fed ``xp`` (T, B, N, 3H) float32 (the
    bulk projection, added unrounded), with h_seq / ru_seq / c_seq in
    ``stream_dtype``."""
    if xp.device.type == "cpu":
        return dcgru_xin_fwd_loop_plain(xp, a_ops, wg_r, wc_r, gate_b,
                                        cand_b, h0, activation, residuals,
                                        stream_dtype)
    if xp.dtype != torch.float32:
        raise TypeError(f"dcgru_xin_fwd_loop: xp must be float32, got "
                        f"{xp.dtype}")
    return _fwd_loop(dcgru_xin_fwd_loop, xp, a_ops, wg_r, wc_r, gate_b,
                     cand_b, h0, activation, residuals, stream_dtype)


dcgru_xin_fwd_loop.launches = 0


def dcgru_dw_reduce(partials):
    """Sum (S, W) dW partial slabs (per clip, or per split of the clip
    steps) over S -> (W,) float32, in a fixed order (deterministic, no
    atomics)."""
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


def _bwd_loop_checks(name, a_ops, wg_r, wc_r, streams, activation):
    """The checks of the backward loops' arguments (``streams`` = h_prev,
    ru_seq, c_seq, d_seq)."""
    t, b, n, h_units = streams[0].shape
    m = a_ops.shape[0]
    _check(name, streams, a_ops, (wg_r, wc_r), activation, b, n, h_units)
    _check_shapes(name, "stream", streams, (
        (t, b, n, h_units), (t, b, n, 2 * h_units), (t, b, n, h_units),
        (t, b, n, h_units)))
    _check_shapes(name, "weight", (wg_r, wc_r), (
        (m, h_units, 2 * h_units), (m, h_units, h_units)))


def dcgru_recurrence_xin_bwd(a_ops, wxg_f, wxc_f, wg_r, wc_r, h_prev,
                             ru_seq, c_seq, x, d_seq, activation="tanh",
                             need_dx=True):
    """BPTT of :func:`dcgru_recurrence_xin_fwd` over all T steps.

    On a CUDA device: the state loop (:func:`dcgru_xin_bwd_loop`, dpre in
    float32), then the bulk dW kernel (:func:`dcgru_xin_dw`) and
    :func:`dcgru_dw_reduce` over its split partials, and with ``need_dx``
    the bulk dx kernel (:func:`dcgru_xin_dx`).

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
    dpre, dh0 = dcgru_xin_bwd_loop(a_ops, wg_r, wc_r, h_prev, ru_seq, c_seq,
                                   d_seq, activation)
    part = dcgru_xin_dw(a_ops, h_prev, ru_seq, x, dpre)
    dx = (dcgru_xin_dx(a_ops, (wxg_f, wxc_f), dpre, x.dtype) if need_dx
          else None)
    return (dx, *_split_dw(dcgru_dw_reduce(part), m, d, h_units), dh0)


def dcgru_xin_bwd_loop(a_ops, wg_r, wc_r, h_prev, ru_seq, c_seq, d_seq,
                       activation="tanh"):
    """The state loop of :func:`dcgru_recurrence_xin_bwd` and of
    :func:`dcgru_recurrence_bwd`: the reverse loop without any dW.
    Arguments as the latter's;
    returns (dpre (T, B, N, 3H) = [dru_pre | dc_pre] float32, dh0
    (B, N, H) float32)."""
    if h_prev.device.type == "cpu":
        return dcgru_xin_bwd_loop_plain(a_ops, wg_r, wc_r, h_prev, ru_seq,
                                        c_seq, d_seq, activation)
    name = "dcgru_xin_bwd_loop"
    streams = (h_prev, ru_seq, c_seq, d_seq)
    _bwd_loop_checks(name, a_ops, wg_r, wc_r, streams, activation)
    t, b, n, h_units = h_prev.shape
    m = a_ops.shape[0]
    dev = h_prev.device
    bf16 = h_prev.dtype == torch.bfloat16
    dpre = torch.empty((t, b, n, 3 * h_units), dtype=torch.float32,
                       device=dev)
    dh0 = torch.empty((b, n, h_units), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        w = bwd_loop_weights(wg_r, wc_r, bf16)
        err = _lib_bwd().dcgru_xin_bwd_loop(
            a_ops.data_ptr(), a_ops.shape[1], w.data_ptr(),
            *(s.data_ptr() for s in streams), dpre.data_ptr(),
            dh0.data_ptr(), t, b, n, h_units, m, _ACT_CODES[activation],
            int(bf16), _stream(h_prev))
    _raise_on(err, name, _lib_bwd)
    dcgru_xin_bwd_loop.launches += 1
    return dpre, dh0


dcgru_xin_bwd_loop.launches = 0


def dcgru_recurrence_bwd(a_ops, wg_r, wc_r, h_prev, ru_seq, c_seq, d_seq,
                         activation="tanh"):
    """BPTT of :func:`dcgru_recurrence_fwd` over all T steps.

    On a CUDA device: the state loop (:func:`dcgru_xin_bwd_loop`, dpre in
    float32), the bulk dW kernel at D = 0 (:func:`dcgru_xin_dw`: the layer
    has no input x) and :func:`dcgru_dw_reduce` over its split partials;
    dxp is dpre cast to the stream dtype, as the TPU kernel writes
    dx_proj. dW is taken from the float32 dpre.

    Arguments as :func:`dcgru_recurrence_xin_bwd` without the input and
    its weights. Returns (dxp, dwg_r, dwc_r, dbg, dbc, dh0): dxp
    (T, B, N, 3H) = [dru_pre | dc_pre] in the stream dtype, the rest
    float32.
    """
    if h_prev.device.type == "cpu":
        return dcgru_recurrence_bwd_plain(a_ops, wg_r, wc_r, h_prev, ru_seq,
                                          c_seq, d_seq, activation)
    streams = (h_prev, ru_seq, c_seq, d_seq)
    _bwd_loop_checks("dcgru_recurrence_bwd", a_ops, wg_r, wc_r, streams,
                     activation)
    t, b, n, h_units = h_prev.shape
    dpre, dh0 = dcgru_xin_bwd_loop(a_ops, wg_r, wc_r, *streams, activation)
    part = dcgru_xin_dw(a_ops, h_prev, ru_seq, h_prev.new_empty((t, b, n, 0)),
                        dpre)
    _, _, dwg, dwc, dbg, dbc = _split_dw(dcgru_dw_reduce(part),
                                         a_ops.shape[0], 0, h_units)
    return dpre.to(h_prev.dtype), dwg, dwc, dbg, dbc, dh0


def _wx_parts(name, wx, m, h3=None):
    """``wx`` as its column blocks: the (M*D, 3H) tensor, or a tuple of
    its (M*D, w) blocks ([Wxg | Wxc] unjoined); checked as weights."""
    parts = tuple(wx) if isinstance(wx, (tuple, list)) else (wx,)
    rows = parts[0].shape[0]
    width = sum(w.shape[-1] for w in parts)
    for w in parts:
        if w.ndim != 2 or w.shape[0] != rows:
            shapes = [tuple(v.shape) for v in parts]
            raise ValueError(f"{name}: weight blocks {shapes} are not "
                             "(M*D, w) of one M*D")
    if rows % max(m, 1) or (h3 is not None and width != h3):
        raise ValueError(f"{name}: weight ({rows}, {width}) is not "
                         f"(M*D, 3H) for M={m}")
    return parts


def dcgru_xin_proj(x, a_ops, wx):
    """The x-in layer's input projection for all T steps at once:
    ``XP = sum_m (A_m x) Wx_m``.

    Args:
        x: (T, B, N, D) layer input, float32 or bfloat16.
        a_ops: (M, B or 1, N, N) operator stack, float32.
        wx: (M*D, 3H) = [Wxg | Wxc], m-major rows, float32; or the tuple
            (Wxg (M*D, 2H), Wxc (M*D, H)), staged without joining them.

    Returns:
        XP (T, B, N, 3H) float32. bf16 streams: A_m x in one bf16 pass of
        bf16 A_m and x, rounded to bf16, times bf16 Wx_m, f32 sums (the
        reference's one MXU pass a product); f32 streams: A_m x in f32
        FMAs, times Wx_m in 3xTF32 (the wgmma kernel).

    On a CUDA device the wrapper stages the operators (bf16:
    :func:`dw_op_frags`, untransposed; f32: :func:`xin_op_rows`) and the
    weights (:func:`xin_weight_frags`) as the kernel's operands, once a
    launch.
    """
    if x.device.type == "cpu":
        parts = _wx_parts("dcgru_xin_proj", wx, a_ops.shape[0])
        return dcgru_xin_proj_plain(x, a_ops, torch.cat(parts, dim=1))
    name = "dcgru_xin_proj"
    t, b, n, d = x.shape
    m = a_ops.shape[0]
    parts = _wx_parts(name, wx, m)
    h3 = sum(w.shape[-1] for w in parts)
    _check(name, (x,), a_ops, parts, None, b, n, h3 // 3)
    if d % 4:
        raise ValueError(f"{name}: D={d} is not a multiple of 4")
    if parts[0].shape[0] != m * d or h3 % 3:
        raise ValueError(f"{name}: weight ({parts[0].shape[0]}, {h3}) != "
                         f"({m * d}, 3H)")
    _check_aligned(name, x)
    xp = torch.empty((t, b, n, h3), dtype=torch.float32, device=x.device)
    if t * b == 0:
        return xp
    bf16 = x.dtype == torch.bfloat16
    with torch.cuda.device(x.device):
        ops = None
        if m > 1:
            ops = (dw_op_frags(a_ops, True, transpose=False, batch_major=True)
                   if bf16 else xin_op_rows(a_ops, False))
        w = xin_weight_frags(parts, m, False, bf16)
        err = _lib_xin().dcgru_xin_proj(
            x.data_ptr(), _ptr(ops), a_ops.shape[1], w.data_ptr(),
            xp.data_ptr(), t, b, n, d, h3 // 3, m, int(bf16), _stream(x))
    _raise_on(err, name, _lib_xin)
    dcgru_xin_proj.launches += 1
    return xp


dcgru_xin_proj.launches = 0


def dcgru_xin_dw(a_ops, h_prev, ru_seq, x, dpre):
    """The x-in layer's weight and bias gradients from the state loop's
    dpre, over all T steps at once.

    Args:
        a_ops: (M, B or 1, N, N) float32.
        h_prev (T,B,N,H), ru_seq (T,B,N,2H), x (T,B,N,D): the streams, in
            one dtype; D = 0 (the hoisted layer's) gives slabs without
            dWx.
        dpre: (T, B, N, 3H) [dru_pre | dc_pre] float32.

    Returns:
        (dw_splits(T*B, M, D, H), dw_size(M, D, H)) float32 partial slabs
        [dWxg | dWxc | dWg | dWc | dbg | dbc], one per split of the (t, b)
        pairs; their sum over axis 0 (:func:`dcgru_dw_reduce`) is the
        gradient.

    The kernel computes ``dW_m = sum [x | h_prev | r h_prev]^T G_m`` with
    ``G_m = A_m^T dpre`` per clip (the diffusion moved to dpre's side): in
    bf16, G_m is one bf16 pass of bf16 A_m^T and dpre, rounded to bf16,
    and r h_prev is rounded to bf16; in f32, 3xTF32 throughout.
    """
    if dpre.device.type == "cpu":
        return dcgru_xin_dw_plain(a_ops, h_prev, ru_seq, x, dpre)
    name = "dcgru_xin_dw"
    t, b, n, d = x.shape
    m, h_units = a_ops.shape[0], h_prev.shape[-1]
    _check(name, (h_prev, ru_seq, x), a_ops, (dpre,), None, b, n, h_units)
    if d % 4:
        raise ValueError(f"{name}: D={d} is not a multiple of 4")
    _check_shapes(name, "stream", (h_prev, ru_seq, dpre), (
        (t, b, n, h_units), (t, b, n, 2 * h_units), (t, b, n, 3 * h_units)))
    if t * b == 0:
        return torch.zeros((1, dw_size(m, d, h_units)), dtype=torch.float32,
                           device=dpre.device)
    splits = dw_splits(t * b, m, d, h_units)
    part = torch.empty((splits, dw_size(m, d, h_units)), dtype=torch.float32,
                       device=dpre.device)
    bf16 = x.dtype == torch.bfloat16
    with torch.cuda.device(dpre.device):
        frags = dw_op_frags(a_ops, bf16) if m > 1 else None
        err = _lib_xin().dcgru_xin_dw(
            x.data_ptr(), h_prev.data_ptr(), ru_seq.data_ptr(),
            dpre.data_ptr(), _ptr(frags), a_ops.shape[1],
            part.data_ptr(), splits, t, b, n, d, h_units, m, int(bf16),
            _stream(dpre))
    _raise_on(err, name, _lib_xin)
    dcgru_xin_dw.launches += 1
    return part


dcgru_xin_dw.launches = 0


def dcgru_xin_dx(a_ops, wx, dpre, dtype):
    """The x-in layer input's cotangent from the state loop's dpre, over
    all T steps at once: ``dx = sum_m A_m^T (dpre Wx_m^T)``.

    Args:
        a_ops: (M, B or 1, N, N) float32; wx: (M*D, 3H) float32, or the
            tuple (Wxg, Wxc) as :func:`dcgru_xin_proj` takes it.
        dpre: (T, B, N, 3H) float32.
        dtype: the stream dtype of dx (float32 or bfloat16).

    Returns:
        dx (T, B, N, D) in ``dtype``. bf16: the kernel computes
        ``sum_m (A_m^T dpre) Wx_m^T``, G_m = A_m^T dpre in one bf16 pass
        of bf16 A_m^T and dpre, rounded to bf16, times bf16 Wx_m^T, f32
        sums. f32: where every m's D columns fit one block (M D padded
        to 8 at most 192: the kernel's plan) ``sum_m A_m^T (dpre
        Wx_m^T)``, the products in 3xTF32 and the A_m^T applies in f32
        FMAs; else ``sum_m (A_m^T dpre) Wx_m^T`` alike, each m's product
        summed in f32.
    """
    if dpre.device.type == "cpu":
        parts = _wx_parts("dcgru_xin_dx", wx, a_ops.shape[0])
        return dcgru_xin_dx_plain(a_ops, torch.cat(parts, dim=1), dpre,
                                  dtype)
    name = "dcgru_xin_dx"
    t, b, n, h3 = dpre.shape
    m = a_ops.shape[0]
    parts = _wx_parts(name, wx, m, h3)
    d = parts[0].shape[0] // max(m, 1)
    _check(name, (dpre,), a_ops, parts, None, b, n, h3 // 3)
    if dtype not in _STREAM_DTYPES:
        raise TypeError(f"{name}: stream dtype {dtype} is not float32 or "
                        "bfloat16")
    if d % 4:
        raise ValueError(f"{name}: D={d} is not a multiple of 4")
    _check_shapes(name, "dpre", (dpre,), ((t, b, n, 3 * (h3 // 3)),))
    _check_aligned(name, dpre)
    dx = torch.empty((t, b, n, d), dtype=dtype, device=dpre.device)
    if t * b == 0:
        return dx
    bf16 = dtype == torch.bfloat16
    with torch.cuda.device(dpre.device):
        ops = None
        if m > 1:
            ops = (dw_op_frags(a_ops, True, batch_major=True) if bf16
                   else xin_op_rows(a_ops, True))
        w = xin_weight_frags(parts, m, True, bf16)
        err = _lib_xin().dcgru_xin_dx(
            dpre.data_ptr(), _ptr(ops), a_ops.shape[1], w.data_ptr(),
            dx.data_ptr(), t, b, n, d, h3 // 3, m, int(bf16), _stream(dpre))
    _raise_on(err, name, _lib_xin)
    dcgru_xin_dx.launches += 1
    return dx


dcgru_xin_dx.launches = 0


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
