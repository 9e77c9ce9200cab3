"""The encoder's state loops on tensor cores (``csrc/dcgru_recurrence.cu``,
``csrc/dcgru_recurrence_bwd.cu``), checked on the CPU before any card:

- (a) the wrapper's weight staging (``stage_chain_weights``: the hidden
  weights as tensor-core A fragments, zero-padded tiles) against the PTX
  fragment layout of ``mma.sync`` m16n8k16 (bf16) and m16n8k8 (TF32),
  rebuilt here lane by lane: bit-exact in float32, the bf16 rounding of
  the weights in bfloat16; and the kernels' 3xTF32 split of the staged
  f32 weights (``split_tf32``: hi rounded to TF32, lo = v - hi read as
  TF32, cut toward zero) reconstructs every weight within 2^-21 relative;
- (b) the kernels' operand rounding, emulated (``tests/chain_emulation.py``):
  bf16 operands with f32 sums in every hidden product of the forward and
  the backward chain (the diffusions, gates, state and cotangent f32),
  run through the plain loops and the plain bulk products, against the
  JAX package's float32 layer (``_forward_xin``, and ``jax.grad`` through
  ``dcgru_layer_recurrence_pallas_xin`` in interpret mode) at the bf16
  bar of 2e-2, normalized inf-norm error (``chip_smoke.py``'s); with f32
  and with bf16 streams;
- (c) ``chip_smoke.py``'s restated bounds of the serial chains at the
  flagship shape (T=60, B=128, N=19, H=64, K=2, D=100), against figures
  computed by hand below.

Sizes: T=6, B=3, N=19, H=8 and 16, D=12; M=3 and 5, per-clip and shared
graphs.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke as cs
from chain_emulation import chain_bwd, chain_fwd
from eeg_gnn_tpu.ops.pallas_recurrent import (
    _forward_xin,
    dcgru_layer_recurrence_pallas_xin,
)
from eeg_gnn_tpu.ops.recurrent import chebyshev_operators as jax_ops
from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr
from eeg_gnn_tpu_torch.ops.recurrent import chebyshev_operators, shift_h_prev

T, B, N, D, K = 6, 3, 19, 12, 2
BF16_TOL = 2e-2
GRADS = ("x", "wxg", "wxc", "wg", "wc", "bg", "bc", "h0")
GRAPHS = [(1, False), (2, False), (1, True), (2, True)]  # (S, shared)


def _err(ours, ref):
    ours = np.asarray(ours.detach().float().numpy() if isinstance(
        ours, torch.Tensor) else ours, np.float32)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12))


# ---------------------------------------------------------------------------
# (a) staging
# ---------------------------------------------------------------------------


def _fragment_coords(bf16):
    """(lane, element) -> (row, column) inside one A tile, from the PTX
    ISA's fragment layouts: lane = 4g + t; m16n8k16 bf16 a0..a7 at (g,
    2t..2t+1), (g+8, 2t..2t+1), (g, 2t+8..2t+9), (g+8, 2t+8..2t+9);
    m16n8k8 tf32 a0..a3 at (g, t), (g+8, t), (g, t+4), (g+8, t+4)."""
    coords = {}
    for lane in range(32):
        g, t = lane // 4, lane % 4
        if bf16:
            for q, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 8), (8, 8)]):
                for e in range(2):
                    coords[lane, 2 * q + e] = (g + dr, 2 * t + dc + e)
        else:
            for q, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 4), (8, 4)]):
                coords[lane, q] = (g + dr, t + dc)
    return coords


def _unstage(tiles, r, k, bf16):
    """The (r, k) matrix the staged tiles hold, rebuilt lane by lane; the
    padding must be zero."""
    depth = 16 if bf16 else 8
    rt, kt = tiles.shape[:2]
    full = np.zeros((rt * 16, kt * depth), np.float32)
    vals = tiles.float().numpy()
    for (lane, e), (row, col) in _fragment_coords(bf16).items():
        for i in range(rt):
            for j in range(kt):
                full[16 * i + row, depth * j + col] = vals[i, j, lane, e]
    assert not full[r:].any() and not full[:, k:].any(), "padding not zero"
    return full[:r, :k]


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("r,k", [(16, 24), (40, 72), (8, 40), (20, 12)])
def test_staged_tiles_round_trip_the_weights(r, k, bf16):
    rng = np.random.RandomState(r * k)
    a = torch.from_numpy(rng.randn(r, k).astype(np.float32))
    tiles = cr._chain_tiles(a, bf16)
    depth = 16 if bf16 else 8
    assert tiles.shape == (-(-r // 16), -(-k // depth), 32, 8 if bf16 else 4)
    assert tiles.dtype == (torch.bfloat16 if bf16 else torch.float32)
    want = a.to(torch.bfloat16).float() if bf16 else a
    np.testing.assert_array_equal(_unstage(tiles, r, k, bf16), want.numpy())


def _kernel_wbytes(r, k, bf16):
    """chain_wbytes of csrc/dcgru_common.cuh: 512 bytes a tile."""
    depth = 16 if bf16 else 8
    return -(-r // 16) * -(-k // depth) * 512


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("h,m", [(8, 3), (16, 5), (12, 1), (64, 3)])
def test_loop_weights_are_where_the_kernels_read_them(h, m, bf16):
    """fwd_loop_weights = [Wg^T | Wc^T], bwd_loop_weights = [Wc | Wg], each
    part at the byte offset the kernel computes."""
    rng = np.random.RandomState(h + m)
    wg = torch.from_numpy(rng.randn(m, h, 2 * h).astype(np.float32))
    wc = torch.from_numpy(rng.randn(m, h, h).astype(np.float32))
    rnd = (lambda w: w.to(torch.bfloat16).float()) if bf16 else (lambda w: w)
    size = 2 if bf16 else 4
    mh = m * h
    cases = [(cr.fwd_loop_weights, [(wg.reshape(mh, -1).t(), 2 * h, mh),
                                    (wc.reshape(mh, -1).t(), h, mh)]),
             (cr.bwd_loop_weights, [(wc.reshape(mh, -1), mh, h),
                                    (wg.reshape(mh, -1), mh, 2 * h)])]
    for stage, parts in cases:
        flat = stage(wg, wc, bf16)
        at = 0
        for mat, r, k in parts:
            n = _kernel_wbytes(r, k, bf16) // size
            depth = 16 if bf16 else 8
            tiles = flat[at:at + n].view(-(-r // 16), -(-k // depth), 32, -1)
            np.testing.assert_array_equal(_unstage(tiles, r, k, bf16),
                                          rnd(mat).numpy())
            at += n
        assert at == flat.numel()


def _split_tf32(v):
    """split_tf32 of csrc/dcgru_common.cuh on float32 v: hi rounded to
    TF32 by integer add, lo = v - hi; the tensor cores read lo's TF32 bits
    (cut toward zero). Returns (hi, lo as read)."""
    bits = v.view(np.uint32)
    hi = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    lo = (v - hi).view(np.uint32) & np.uint32(0xFFFFE000)
    return hi, lo.view(np.float32)


@pytest.mark.parametrize("h,m", [(8, 3), (64, 5)])
def test_3xtf32_split_of_staged_weights_reconstructs_f32(h, m):
    rng = np.random.RandomState(7 * h + m)
    wg = torch.from_numpy(rng.randn(m, h, 2 * h).astype(np.float32))
    wc = torch.from_numpy(
        (rng.randn(m, h, h) * 10.0 ** rng.uniform(-6, 3, (m, h, h)))
        .astype(np.float32))
    for stage in (cr.fwd_loop_weights, cr.bwd_loop_weights):
        w = stage(wg, wc, False).numpy()
        hi, lo = _split_tf32(w)
        assert (hi.view(np.uint32) & 0x1FFF == 0).all()
        err = np.abs((hi.astype(np.float64) + lo) - w)
        assert (err <= 2.0 ** -21 * np.abs(w)).all()


# ---------------------------------------------------------------------------
# (b) the kernels' operand rounding against the JAX float32 layer
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _layer(num_supports, shared, h):
    """Numpy inputs of one layer and JAX's float32 h_seq and gradients of
    sum(h_seq * wl) through the Pallas kernel's custom VJP (interpret)."""
    rng = np.random.RandomState(10 * num_supports + 2 * shared + h)
    m = num_supports * K + 1
    f = lambda *s, scale=0.1: (rng.randn(*s) * scale).astype(np.float32)
    L = dict(
        m=m, h=h, sup=(np.abs(rng.randn(num_supports, 1 if shared else B, N,
                                        N)) / N).astype(np.float32),
        x=f(T, B, N, D, scale=1.0), wxg=f(m * D, 2 * h), wxc=f(m * D, h),
        wg=f(m, h, 2 * h, scale=0.3), wc=f(m, h, h, scale=0.3), bg=f(2 * h),
        bc=f(h), h0=f(B, N, h), wl=f(T, B, N, h, scale=1.0))
    a_j = jax_ops(jnp.asarray(L["sup"]), K)
    op = tuple(jnp.asarray(L[k]) for k in GRADS)
    h_seq, _ = _forward_xin(a_j, *op, "tanh", 2, True, jnp.float32)

    def loss(op):
        _, hs = dcgru_layer_recurrence_pallas_xin(a_j, *op, "tanh", 2, True,
                                                  "float32")
        return jnp.sum(hs * L["wl"])

    grads = jax.grad(loss)(op)
    return L, np.asarray(h_seq), dict(zip(GRADS, map(np.asarray, grads)))


@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h", [8, 16])
@pytest.mark.parametrize("num_supports,shared", GRAPHS)
def test_bf16_chain_operands_stay_within_the_bf16_bar(num_supports, shared,
                                                      h, stream):
    L, h_ref, jg = _layer(num_supports, shared, h)
    a = chebyshev_operators(torch.from_numpy(L["sup"]), K)
    p = {k: torch.from_numpy(L[k]) for k in GRADS}
    x = p["x"].to(stream)
    wx = torch.cat([p["wxg"], p["wxc"]], dim=1)
    xp = cr.dcgru_xin_proj_plain(x, a, wx)
    h_seq, ru, c = chain_fwd(xp, a, p["wg"], p["wc"], p["bg"], p["bc"],
                             p["h0"], stream)
    assert _err(h_seq, h_ref) <= BF16_TOL
    h_prev = shift_h_prev(p["h0"], h_seq)
    dpre, dh0 = chain_bwd(a, p["wg"], p["wc"], h_prev, ru, c,
                          torch.from_numpy(L["wl"]).to(stream))
    part = cr.dcgru_xin_dw_plain(a, h_prev, ru, x, dpre, 1)
    got = dict(zip(GRADS[1:7], cr._split_dw(part.sum(0), L["m"], D, h)))
    got["x"] = cr.dcgru_xin_dx_plain(a, wx, dpre, torch.float32)
    got["h0"] = dh0
    for k in GRADS:
        assert _err(got[k], jg[k]) <= BF16_TOL, k


# ---------------------------------------------------------------------------
# (c) the restated bounds
# ---------------------------------------------------------------------------

# flagship shape: T=60, B=128, N=19, H=64, M=3 (K=2, one support), per-clip
# operators; a clip-step's chain: the hidden products 2*19*192*192 =
# 1,400,832 and the diffusions of h and r*h 2 * 2*2*361*64 = 184,832 FLOP,
# 1,585,664 in all, x 7,680 clip-steps = 12,177,899,520 FLOP on tensor
# cores: 12.313347 us at 989 TFLOP/s (bf16), 73.805452 us at 495/3 (f32).
_FWD_TC = 12_177_899_520
# bytes of the loop fed f32 x_proj, bf16 h_seq: hidden weights and biases
# (192*192 + 192)*4 = 148,224; x_proj 7680*19*192*4 = 112,066,560; a_ops
# 3*128*361*4 = 554,496; h0 128*19*64*4 = 622,592; h_seq 7680*19*64*2 =
# 18,677,760: 132,069,632 bytes, 39.423771 us at 3.35 TB/s.
_FWD_BYTES = 132_069_632
# the backward loop: dpre W^T 2*19*192*192 = 1,400,832 and two A^T applies
# 4*2*361*64 = 184,832 per clip-step, the same 12,177,899,520 FLOP;
# bytes: weights 192*192*4 = 147,456, the four streams (bf16) 7680*19*320*2
# = 93,388,800, dpre (f32) 7680*19*192*4 = 112,066,560, a_ops 554,496, dh0
# 622,592: 206,779,904 bytes, 61.725344 us.
_BWD_BYTES = 206_779_904


def test_restated_chain_bounds_at_the_flagship_shape():
    common = dict(m=3, b=128, a_batch=128)
    fwd = cs.layer_work(xin=False, d=100, stream_bytes=2, xp_bytes=4,
                        **common)
    assert fwd == (0.0, float(_FWD_BYTES), float(_FWD_TC), cs.PEAK_BF16_TC)
    ms, by = cs.bound_ms([fwd])
    assert by == "bytes" and ms == pytest.approx(0.039423771, rel=1e-7)
    f32 = cs.layer_work(xin=False, d=100, stream_bytes=4, **common)
    assert f32[2:] == (float(_FWD_TC), cs.PEAK_TF32_TC / 3)
    ms, by = cs.bound_ms([f32])
    assert by == "operations" and ms == pytest.approx(0.073805452, rel=1e-7)
    bwd = cs.bwd_loop_work(stream_bytes=2, **common)
    assert bwd == (0.0, float(_BWD_BYTES), float(_FWD_TC), cs.PEAK_BF16_TC)
    ms, by = cs.bound_ms([bwd])
    assert by == "bytes" and ms == pytest.approx(0.061725344, rel=1e-7)
