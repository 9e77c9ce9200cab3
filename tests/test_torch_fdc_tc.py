"""The fused diffusion conv on tensor cores (``csrc/fused_diffusion_conv.cu``,
kernel #7 of the ``use_pallas`` loop), checked on the CPU before any card:

- (a) the wrapper's staging (``stage_fdc_operands``): each weight's W^T
  (O x M*D) as float32 ``mma.sync`` m16n8k8 A fragments, and the per-clip
  supports as A fragments split into TF32 hi and lo, against the PTX
  fragment layout rebuilt lane by lane (bit-exact; zero padding; hi + lo
  the support exactly), at the offsets the kernel reads;
- (b) the kernel's arithmetic, emulated in numpy: every product (the
  support applies and the weight product) as 3xTF32 (hi*hi + hi*lo +
  lo*hi, hi rounded to TF32 as ``round_tf32``, lo read cut toward zero),
  the supports' hi and lo taken from the staged fragments; against the
  JAX package's ``fused_diffusion_conv`` run by the Mosaic interpreter,
  normalized inf-norm error <= 1e-5 (the reference's f32 arithmetic,
  summed in another order); S = 1 and 2, K = 1, 2, 3 (the cross-support
  carry-over), O = 2H and H, N = 7 and 19;
- (c) the ``use_pallas`` loop stages each layer's operands once a
  forward, before its T steps, and hands the same staged tensors to all
  2 T of that layer's launches (serving and training).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eeg_gnn_tpu.ops import pallas_kernels as jpk
from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.models import dcgru as tdcgru
from eeg_gnn_tpu_torch.models.registry import build_model
from eeg_gnn_tpu_torch.ops import cuda_kernels as ck
from eeg_gnn_tpu_torch.serve import Predictor
from eeg_gnn_tpu_torch.train import TrainStep

H, B = 16, 3
TOL = 1e-5


def _fragment_coords():
    """(lane, word) -> (row, column) inside one m16n8k8 TF32 A tile (PTX
    ISA): lane = 4g + t holds a0..a3 at (g, t), (g+8, t), (g, t+4),
    (g+8, t+4)."""
    coords = {}
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for q, (dr, dc) in enumerate([(0, 0), (8, 0), (0, 4), (8, 4)]):
            coords[lane, q] = (g + dr, t + dc)
    return coords


def _unstage(tiles, r, k):
    """The (r, k) matrix that (RT, KT, 32, 4) tiles hold; padding zero."""
    rt, kt = tiles.shape[:2]
    full = np.zeros((rt * 16, kt * 8), np.float32)
    vals = np.asarray(tiles)
    for (lane, q), (row, col) in _fragment_coords().items():
        for i in range(rt):
            for j in range(kt):
                full[16 * i + row, 8 * j + col] = vals[i, j, lane, q]
    assert not full[r:].any() and not full[:, k:].any(), "padding not zero"
    return full[:r, :k]


def _round_tf32(v):
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _cut_tf32(v):
    bits = np.asarray(v, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _inputs(seed, s, k, n, d, o, b=B):
    rng = np.random.RandomState(seed)
    m = s * k + 1
    sup = (np.abs(rng.randn(s, b, n, n)) / n).astype(np.float32)
    x = np.tanh(rng.randn(b, n, d)).astype(np.float32)
    w = (rng.randn(m, d, o) * 0.2).astype(np.float32)
    bias = (rng.randn(o) * 0.1).astype(np.float32)
    return sup, x, w, bias


# ---------------------------------------------------------------------------
# (a) staging
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,d,o", [(3, 16, 32), (5, 64, 128), (3, 64, 64),
                                   (1, 4, 20), (4, 12, 8)])
def test_weight_fragments_hold_w_transposed(m, d, o):
    """fdc_weight_frags: W^T (O x M*D, row o, column m*D + d) as
    (ORT, WKT, 32, 4) float32 tiles, the kernel's tile (rt, k) at 16-byte
    word (rt*WKT + k)*32 + lane."""
    w = np.random.RandomState(m * d + o).randn(m, d, o).astype(np.float32)
    tiles = ck.fdc_weight_frags(torch.from_numpy(w))
    assert tiles.dtype == torch.float32 and tiles.is_contiguous()
    assert tiles.shape == (-(-o // 16), -(-(m * d) // 8), 32, 4)
    want = w.reshape(m * d, o).T
    np.testing.assert_array_equal(_unstage(tiles.numpy(), o, m * d), want)
    words = tiles.numpy().reshape(-1, 4)
    wkt = tiles.shape[1]
    for rt, kt, lane in ((0, 0, 5), (tiles.shape[0] - 1, wkt - 1, 31)):
        np.testing.assert_array_equal(words[(rt * wkt + kt) * 32 + lane],
                                      tiles.numpy()[rt, kt, lane])


@pytest.mark.parametrize("s,n", [(1, 7), (2, 19), (2, 32), (1, 19)])
def test_support_fragments_split_the_supports(s, n):
    """fdc_support_frags: per clip b and support s the (N x N) support as
    (RT, KT) tiles, [hi | lo]: hi rounded to TF32 (its 13 low bits zero),
    hi + lo the support exactly; clip-major, so a clip's S supports are
    one span of S*RT*KT*64 16-byte words, tile (s, rt, kt) at word
    ((s*RT + rt)*KT + kt)*64 (+32 for lo) + lane of it."""
    sup, _, _, _ = _inputs(n + s, s, 2, n, 4, 4)
    frags = ck.fdc_support_frags(torch.from_numpy(sup)).numpy()
    rt, kt = -(-n // 16), -(-n // 8)
    assert frags.shape == (B, s, rt, kt, 2, 32, 4)
    words = frags.reshape(B, -1, 4)
    assert words.shape[1] == s * rt * kt * 64
    for b in range(B):
        for si in range(s):
            hi = _unstage(frags[b, si, :, :, 0], n, n)
            lo = _unstage(frags[b, si, :, :, 1], n, n)
            assert (hi.view(np.uint32) & 0x1FFF == 0).all()
            np.testing.assert_array_equal(hi, _round_tf32(sup[si, b]))
            np.testing.assert_array_equal(hi + lo, sup[si, b])
            i, j, lane = rt - 1, kt - 1, 17
            at = ((si * rt + i) * kt + j) * 64
            np.testing.assert_array_equal(words[b, at + lane],
                                          frags[b, si, i, j, 0, lane])
            np.testing.assert_array_equal(words[b, at + 32 + lane],
                                          frags[b, si, i, j, 1, lane])


def test_staged_operands_take_no_gradient():
    sup, _, w, _ = _inputs(3, 1, 2, 19, 16, 32)
    w_t = torch.from_numpy(w).requires_grad_()
    sup_f, (w_f,) = ck.stage_fdc_operands(torch.from_numpy(sup), w_t)
    assert not sup_f.requires_grad and not w_f.requires_grad


# ---------------------------------------------------------------------------
# (b) the kernel's 3xTF32 arithmetic against the JAX kernel
# ---------------------------------------------------------------------------


def _mm3(a_hi, a_lo, b):
    """a @ b in 3xTF32 as the kernel's mma: a given split (hi, lo as
    stored), b split as read; the tensor cores read lo cut to TF32; sums
    in float64, the result float32."""
    b_hi = _round_tf32(b)
    b_lo = _cut_tf32(b - b_hi)
    a_lo = _cut_tf32(a_lo)
    f = lambda v: np.asarray(v, np.float64)
    return (f(a_lo) @ f(b_hi) + f(a_hi) @ f(b_lo)
            + f(a_hi) @ f(b_hi)).astype(np.float32)


def _kernel_emulation(sup, x, w, bias, k):
    """One clip at a time: the terms T_0 = x, T = A_s T_i0, then
    T = 2 A_s T_i1 - T_i0 (i0, i1 carried across supports), each apply
    with the staged support fragments' hi and lo; then out^T = W^T F^T in
    3xTF32 (W^T split as read), plus the bias."""
    s, b, n, _ = sup.shape
    m, d, o = w.shape
    frags = ck.fdc_support_frags(torch.from_numpy(sup)).numpy()
    wt = w.reshape(m * d, o).T
    out = np.empty((b, n, o), np.float32)
    for c in range(b):
        terms, i0 = [x[c]], 0
        for si in range(s if k > 0 else 0):
            hi = _unstage(frags[c, si, :, :, 0], n, n)
            lo = _unstage(frags[c, si, :, :, 1], n, n)
            terms.append(_mm3(hi, lo, terms[i0]))
            i1 = len(terms) - 1
            for _ in range(2, k + 1):
                terms.append(np.float32(2.0) * _mm3(hi, lo, terms[i1])
                             - terms[i0])
                i0, i1 = i1, len(terms) - 1
        f = np.concatenate(terms, axis=-1)  # (N, M*D), m-major
        w_hi = _round_tf32(wt)
        out[c] = _mm3(w_hi, wt - w_hi, f.T).T + bias
    return out


@pytest.mark.parametrize("s,k,n,o", [
    (1, 1, 7, 2 * H), (1, 2, 19, 2 * H), (1, 2, 19, H), (1, 3, 7, H),
    (2, 1, 19, H), (2, 2, 19, 2 * H), (2, 2, 7, H), (2, 3, 19, 2 * H),
])
def test_kernel_arithmetic_matches_jax_kernel(s, k, n, o):
    sup, x, w, bias = _inputs(100 * s + 10 * k + n + o, s, k, n, H, o)
    want = np.asarray(jpk.fused_diffusion_conv(
        jnp.asarray(sup), jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
        k, batch_tile=2, interpret=True))
    got = _kernel_emulation(sup, x, w, bias, k)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, err
    # the plain version, which the card's kernel is held to, agrees too
    plain = ck.fused_diffusion_conv_plain(*map(torch.from_numpy, (
        sup, x, w, bias)), k).numpy()
    assert np.abs(plain - want).max() / np.abs(want).max() <= TOL


# ---------------------------------------------------------------------------
# (c) staging once a layer a forward
# ---------------------------------------------------------------------------


T, N, L = 5, 19, 2


def _spy(monkeypatch):
    """Counts stage_fdc_operands calls and records the staged tuple each
    conv call is handed (as _step_scan calls them)."""
    stages, staged = [], []
    real_stage = tdcgru.stage_fdc_operands

    def stage(*args):
        out = real_stage(*args)
        stages.append(out)
        return out
    monkeypatch.setattr(tdcgru, "stage_fdc_operands", stage)
    for name in ("fused_diffusion_conv", "fused_diffusion_conv_fwd"):
        real = getattr(ck, name)

        def conv(*args, real=real):
            staged.append(args[5])
            return real(*args)
        monkeypatch.setattr(tdcgru, name, conv)
    return stages, staged


def _batch(rng, b=4):
    adj = np.abs(rng.randn(b, N, N)).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    return {"x": rng.randn(b, T, N, 12).astype(np.float32),
            "y": rng.randint(0, 2, size=b).astype(np.float32),
            "seq_lengths": np.full((b,), T, np.int64), "adjacency": adj}


@pytest.mark.parametrize("graph_type", ["combined", "individual"])
def test_step_scan_stages_once_a_layer_a_forward(monkeypatch, graph_type):
    stages, staged = _spy(monkeypatch)
    cfg = ExperimentConfig(graph_type=graph_type, max_seq_len=T,
                           num_rnn_layers=L, rnn_units=H, input_dim=12,
                           use_pallas=True).finalize()
    b = _batch(np.random.RandomState(0))
    pred = Predictor(cfg, build_model(
        cfg, torch.Generator().manual_seed(0)).state_dict(), device="cpu")
    pred.predict_proba(b["x"], b["seq_lengths"], adjacency=b["adjacency"])
    step = TrainStep(cfg, build_model(cfg, torch.Generator().manual_seed(0)),
                     2, device="cpu")
    assert np.isfinite(float(step(b)))
    # two forwards (serving, one train step): L stagings each, every
    # layer's 2 T launches handed that layer's staged supports and its
    # gate / candidate weights
    assert len(stages) == 2 * L
    assert len(staged) == 2 * L * 2 * T
    for i, (sup_f, (w_gate_f, w_cand_f)) in enumerate(stages):
        mine = staged[i * 2 * T:(i + 1) * 2 * T]
        assert all(st[0] is sup_f for st in mine)
        assert all(st[1] is w_gate_f for st in mine[0::2])
        assert all(st[1] is w_cand_f for st in mine[1::2])
