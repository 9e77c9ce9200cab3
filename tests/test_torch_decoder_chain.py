"""The seq2seq decoder's state loops on tensor cores
(``csrc/dcgru_decoder.cu``: ``dcgru_decoder_fwd``, ``dcgru_dec_bwd_loop``),
checked on the CPU before any card:

- (a) the wrappers' weight staging (``decoder_fwd_weights``,
  ``decoder_bwd_weights``: per cell, the tied one first, the products' A
  operands as tensor-core fragments, zero-padded tiles; layer 0's K =
  M(H+D) padded to the tile depth) against the PTX fragment layouts of
  ``mma.sync`` m16n8k16 (bf16) and m16n8k8 (TF32), rebuilt lane by lane
  at the byte offsets the kernels compute: bit-exact in float32, the bf16
  rounding of the weights in bfloat16; and the kernels' 3xTF32 split of
  the staged f32 weights reconstructs every weight within 2^-21
  relative;
- (b) the kernels' operand rounding, emulated (``tests/chain_emulation.py``:
  bf16 operands with f32 sums in every product of the forward loop and of
  the backward loop; diffusions, A^T applies, gates, state and cotangents
  f32), composed with the plain bulk dW and dWp products as the backward
  composes them, against the JAX package's float32 decoder
  (``_decoder_pallas`` in interpret mode and ``jax.grad`` through it): its
  output and all 16 gradients at the bf16 bar of 2e-2, normalized
  inf-norm error, with f32 and with bf16 streams;
- (c) ``chip_smoke.py``'s bounds of the two loops at the SSL model's
  shape, against figures computed by hand below.

Sizes: T_out=4, B=3, N=19, H=8, D=12 (staging also H=12, 16 and 64,
D=8, 20 and 100); L = 1, 2, 3; M = 3 and 5.
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke as cs
from chain_emulation import dec_chain_bwd, dec_chain_fwd
from test_torch_chain_tc import _kernel_wbytes, _split_tf32, _unstage
from test_torch_decoder_split import H, K, WEIGHTS, _case, _err, _split_grads
from eeg_gnn_tpu_torch.models import dcgru as tdcgru
from eeg_gnn_tpu_torch.ops import cuda_decoder as cd
from eeg_gnn_tpu_torch.ops.recurrent import chebyshev_operators

BF16_TOL = 2e-2


def _weights(h, d, m, num_layers, seed, spread=False):
    """Random m-major decoder weights: layer 0 and (L > 1) the shared cell
    as (wxg, wxc, wg, wc), and wp (H, D); ``spread`` scales them over nine
    decades."""
    rng = np.random.RandomState(seed)

    def f(*s):
        v = rng.randn(*s)
        if spread:
            v *= 10.0 ** rng.uniform(-6, 3, s)
        return torch.from_numpy(v.astype(np.float32))

    def cell(d_in):
        return (f(m * d_in, 2 * h), f(m * d_in, h), f(m * h, 2 * h),
                f(m * h, h))
    return cell(d), cell(h) if num_layers > 1 else (), f(h, d)


def _operands(fwd, layer0, shared, wp):
    """The kernel's A operands in its order, each (matrix, R, K)."""
    def cell(wxg, wxc, wg, wc):
        if fwd:
            return [(torch.cat([wg, wxg]).t(), wg.shape[1], wg.shape[0]
                     + wxg.shape[0]),
                    (torch.cat([wc, wxc]).t(), wc.shape[1], wc.shape[0]
                     + wxc.shape[0])]
        h_units = wc.shape[1]
        return [(wg, wg.shape[0], 2 * h_units),
                (torch.cat([wxg, wxc], dim=1), wxg.shape[0], 3 * h_units),
                (wc, wc.shape[0], h_units)]
    mats = (cell(*shared) if shared else []) + cell(*layer0)
    return mats + [(wp.t(), wp.shape[1], wp.shape[0]) if fwd
                   else (wp, wp.shape[0], wp.shape[1])]


SHAPES = [(8, 12, 3), (12, 20, 5), (16, 8, 3), (64, 100, 3)]  # (H, D, M)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("num_layers", [1, 3])
@pytest.mark.parametrize("h,d,m", SHAPES)
def test_decoder_staged_operands_round_trip(h, d, m, num_layers, fwd, bf16):
    """Each operand at the byte offset the kernel computes (DecOps):
    forward [tied gate^T | tied cand^T |] l0 gate^T | l0 cand^T | Wp^T,
    backward [tied Wg | tied Wx | tied Wc |] l0 Wg | l0 Wx | l0 Wc | Wp."""
    layer0, shared, wp = _weights(h, d, m, num_layers, seed=h + d + m)
    stage = cd.decoder_fwd_weights if fwd else cd.decoder_bwd_weights
    flat = stage(layer0, shared, wp, bf16)
    assert flat.dtype == (torch.bfloat16 if bf16 else torch.float32)
    rnd = (lambda w: w.to(torch.bfloat16).float()) if bf16 else (lambda w: w)
    size, depth = (2, 16) if bf16 else (4, 8)
    at = 0
    for mat, r, k in _operands(fwd, layer0, shared, wp):
        assert mat.shape == (r, k)
        n = _kernel_wbytes(r, k, bf16) // size
        tiles = flat[at:at + n].view(-(-r // 16), -(-k // depth), 32, -1)
        np.testing.assert_array_equal(_unstage(tiles, r, k, bf16),
                                      rnd(mat).numpy())
        at += n
    assert at == flat.numel()


@pytest.mark.parametrize("fwd", [True, False])
@pytest.mark.parametrize("h,d,m", [(8, 12, 3), (64, 100, 5)])
def test_3xtf32_split_of_decoder_weights_reconstructs_f32(h, d, m, fwd):
    layer0, shared, wp = _weights(h, d, m, 2, seed=7 * h + m, spread=True)
    stage = cd.decoder_fwd_weights if fwd else cd.decoder_bwd_weights
    w = stage(layer0, shared, wp, False).numpy()
    hi, lo = _split_tf32(w)
    assert (hi.view(np.uint32) & 0x1FFF == 0).all()
    err = np.abs((hi.astype(np.float64) + lo) - w)
    assert (err <= 2.0 ** -21 * np.abs(w)).all()


@functools.lru_cache(maxsize=None)
def _emulated(num_layers, num_supports, stream):
    """The emulated loops on _case's inputs, composed with the plain bulk
    dW and dWp as the backward composes them: (proj, every gradient)."""
    inputs, _ = _case(num_layers, num_supports, False, "mixed")
    a_ops = chebyshev_operators(torch.from_numpy(inputs["sup"]), K)
    a_ops = a_ops.contiguous()
    w = tdcgru.decoder_kernel_weights(inputs["cfg0"], inputs["params"],
                                      num_layers)
    force = torch.from_numpy(inputs["force"])
    h0 = torch.from_numpy(inputs["h0"])
    x = torch.from_numpy(inputs["dec"]).to(stream)
    proj, in0, h_seq, ru, c = dec_chain_fwd(a_ops, x, force, *w, h0,
                                            num_layers)
    h_prev = cd.decoder_h_prev(h0, h_seq)
    d_seq = torch.from_numpy(inputs["wl"]).to(stream)
    loop = dec_chain_bwd(a_ops, *w[0:4], *w[6:10], w[12], h_prev, ru, c,
                         d_seq, force, num_layers)
    p = dict(loop=loop, a_ops=a_ops, h_top=h_seq[num_layers - 1],
             dw_cells=functools.partial(cd.decoder_dw_cells, a_ops, h_prev,
                                        h_seq, ru, in0))
    return proj, _split_grads(p, num_layers, splits=(1, 1, 1))


@pytest.mark.parametrize("stream", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_supports", [1, 2])
@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_bf16_decoder_chain_stays_within_the_bf16_bar(num_layers,
                                                      num_supports, stream):
    inputs, want = _case(num_layers, num_supports, False, "mixed")
    proj, got = _emulated(num_layers, num_supports, stream)
    assert proj.dtype == stream
    assert _err(proj, inputs["proj"]) <= BF16_TOL
    names = ("dx", "dh0") + WEIGHTS
    assert set(got) == {k for k in names if want[k] is not None}
    for k in got:
        assert _err(got[k], want[k]) <= BF16_TOL, (k, _err(got[k], want[k]))


# SSL shape: T_out=12, B=128, N=19, H=64, D=100, L=3, M=3 (K=2, one
# support), per-clip operators. A clip-step of the forward: layer 0's
# diffusions of [h | in] and r*h 2*2*361*(128+100) = 329,232 and products
# 2*19*(300+192)*192 = 3,589,632; each tied layer's 2*2*361*192 = 277,248
# and 2*19*384*192 = 2,801,664; the projection 2*19*64*100 = 243,200:
# 10,319,888 FLOP, x 1,536 clip-steps = 15,851,347,968 on tensor cores.
# The backward loop's clip-step is the same count: dpre W^T 2*19*192*3*164
# and 2*19*192*3*128 (twice), two A^T applies of dh's width and one of
# the input's 2*2*361*(128+100) and 2*2*361*192 (twice), dproj Wp^T.
_DEC_TC = 15_851_347_968
# bytes of the forward, bf16 streams: weights and biases (94,656 + 73,920
# + 6,500 floats) and the force vector 700,352; a_ops 3*128*361*4 =
# 554,496; h0 3*128*19*64*4 = 1,867,776; x in, proj, in0 and L x (h, ru,
# c) out 29,184*(300 + 768)*2 = 62,337,024: 65,459,648 bytes.
_DEC_FWD_BYTES = 65_459_648
# the backward loop: weights without biases 174,592 floats and the force
# vector 698,416; a_ops 554,496; dh0 1,867,776; h_prev, ru, c of L layers
# and d_seq in, dx out 29,184*(768 + 200)*2 = 56,500,224; dpre and dproj
# (f32) 29,184*(576 + 100)*4 = 78,913,536: 138,534,448 bytes.
_DEC_BWD_BYTES = 138_534_448


def test_restated_decoder_loop_bounds_at_the_ssl_shape():
    kw = dict(d=100, m=3, layers=3, b=128, a_batch=128)
    fwd = cs.dec_work(stream_bytes=2, **kw)
    assert fwd == (0.0, float(_DEC_FWD_BYTES), float(_DEC_TC),
                   cs.PEAK_BF16_TC)
    ms, by = cs.bound_ms([fwd])
    assert by == "bytes" and ms == pytest.approx(0.019540193, rel=1e-7)
    bwd = cs.dec_loop_work(stream_bytes=2, **kw)
    assert bwd == (0.0, float(_DEC_BWD_BYTES), float(_DEC_TC),
                   cs.PEAK_BF16_TC)
    ms, by = cs.bound_ms([bwd])
    assert by == "bytes" and ms == pytest.approx(0.041353567, rel=1e-7)
    # f32 streams: 3xTF32, a third of the TF32 rate
    for work in (cs.dec_work, cs.dec_loop_work):
        f32 = work(stream_bytes=4, **kw)
        assert f32[2:] == (float(_DEC_TC), cs.PEAK_TF32_TC / 3)
        ms, by = cs.bound_ms([f32])
        assert by == "operations"
        assert ms == pytest.approx(0.096068775, rel=1e-7)
