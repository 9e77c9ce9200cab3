"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
card. Every test here carries the ``cuda`` marker and skips where there is
no card. The file imports neither JAX nor the JAX package, so on the
card's machine it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: normalized inf-norm error max|k - p| / max|p| <= 1e-4 in float32
(the same f32 arithmetic summed in another order, TF32 off) and <= 2e-2 in
bfloat16 (the bf16 bound of benchmarks/tpu_kernel_parity.json), for every
output of the encoder's forward and backward kernels, of the seq2seq
decoder's, of the fused diffusion conv and of the block-sparse SDDMM; and
the detection and SSL train steps' gradients against the stacked steps'
at 1e-4.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr
from eeg_gnn_tpu_torch.ops.recurrent import chebyshev_operators, shift_h_prev

pytestmark = pytest.mark.cuda

N, K = 19, 2
# the 3xTF32 SDDMM's bar (normalized): above its f32 reading, below one
# TF32 pass's (chip_smoke.py reads both at D=6000; PERF.md)
SDDMM_TOL = 1e-5


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, *, t, b, d, h, num_supports, shared, stream, seed=0):
    rng = np.random.RandomState(seed)
    m = num_supports * K + 1
    f = lambda *s, scale=0.1: torch.from_numpy(
        (rng.randn(*s) * scale).astype(np.float32)).to(dev)
    sup = torch.from_numpy((np.abs(rng.randn(
        num_supports, 1 if shared else b, N, N)) / N).astype(np.float32))
    a_ops = chebyshev_operators(sup, K).contiguous().to(dev)
    hidden = (f(m, h, 2 * h), f(m, h, h), f(2 * h), f(h), f(b, N, h))
    xin = (f(t, b, N, d, scale=1.0).to(stream), a_ops, f(m * d, 2 * h),
           f(m * d, h), *hidden)
    hoisted = (f(t, b, N, 3 * h, scale=0.5).to(stream), a_ops, *hidden)
    return xin, hoisted


def _err(got, want):
    """Normalized inf-norm error; an all-zero ``want`` (dx with no step
    forced) asks for exact zeros."""
    got, want = got.float(), want.float()
    return ((got - want).abs().max()
            / want.abs().max().clamp_min(1e-12)).item()


@pytest.mark.parametrize("t,b,d,h", [(5, 4, 12, 16), (60, 37, 100, 64)])
@pytest.mark.parametrize("num_supports,shared", [(1, False), (1, True),
                                                 (2, False)])
@pytest.mark.parametrize("bf16", [False, True])
def test_kernels_match_plain(dev, t, b, d, h, num_supports, shared, bf16):
    stream = torch.bfloat16 if bf16 else torch.float32
    xin, hoisted = _inputs(dev, t=t, b=b, d=d, h=h,
                           num_supports=num_supports, shared=shared,
                           stream=stream)
    tol = 2e-2 if bf16 else 1e-4
    # the x-in wrapper launches no kernel of its own: its two kernels count
    for kern, plain, args, counters in (
            (cr.dcgru_recurrence_xin_fwd, cr.dcgru_recurrence_xin_fwd_plain,
             xin, (cr.dcgru_xin_proj, cr.dcgru_xin_fwd_loop)),
            (cr.dcgru_recurrence_fwd, cr.dcgru_recurrence_fwd_plain,
             hoisted, (cr.dcgru_recurrence_fwd,))):
        before = [k.launches for k in counters]
        got = kern(*args, residuals=True)
        torch.cuda.synchronize()
        assert [k.launches - b_ for k, b_ in zip(counters, before)] == \
            [1] * len(counters)
        for g, w in zip(got, plain(*args, residuals=True)):
            assert g.dtype == stream and g.shape == w.shape
            assert _err(g, w) <= tol


@pytest.mark.parametrize("activation", ["relu", "linear"])
def test_kernel_activations(dev, activation):
    xin, hoisted = _inputs(dev, t=5, b=3, d=12, h=16, num_supports=2,
                           shared=False, stream=torch.float32)
    for kern, plain, args in (
            (cr.dcgru_recurrence_xin_fwd, cr.dcgru_recurrence_xin_fwd_plain,
             xin),
            (cr.dcgru_recurrence_fwd, cr.dcgru_recurrence_fwd_plain,
             hoisted)):
        assert _err(kern(*args, activation)[0],
                    plain(*args, activation)[0]) <= 1e-4


def test_wrappers_raise_on_what_the_kernel_does_not_take(dev):
    xin, hoisted = _inputs(dev, t=5, b=3, d=12, h=16, num_supports=1,
                           shared=False, stream=torch.float32)
    x = xin[0]
    with pytest.raises(ValueError, match="contiguous"):
        cr.dcgru_recurrence_xin_fwd(x.transpose(0, 1).contiguous()
                                    .transpose(0, 1), *xin[1:])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cr.dcgru_recurrence_xin_fwd(x.half(), *xin[1:])
    with pytest.raises(TypeError, match="must be float32"):
        cr.dcgru_recurrence_fwd(hoisted[0], hoisted[1].double(),
                                *hoisted[2:])
    with pytest.raises(ValueError, match="multiple of 4"):
        cr.dcgru_recurrence_xin_fwd(x[..., :10].contiguous(), xin[1],
                                    xin[2][:30].contiguous(),
                                    xin[3][:30].contiguous(), *xin[4:])


# the kernels dcgru_recurrence_bwd launches, once each: the state loop, the
# bulk dW at D = 0 and the reduction
HOISTED_BWD_KERNELS = (cr.dcgru_xin_bwd_loop, cr.dcgru_xin_dw,
                       cr.dcgru_dw_reduce)


def _bwd_inputs(dev, *, t, b, d, h, num_supports, shared, stream,
                activation="tanh", seed=0):
    """Backward-kernel arguments from a forward run (realistic residuals)
    and a random seeded h_seq cotangent."""
    xin, hoisted = _inputs(dev, t=t, b=b, d=d, h=h,
                           num_supports=num_supports, shared=shared,
                           stream=stream, seed=seed)
    x, a_ops, wxg_f, wxc_f, wg_r, wc_r, _, _, h0 = xin
    h_seq, ru, c = cr.dcgru_recurrence_xin_fwd_plain(*xin, activation,
                                                     residuals=True)
    rng = np.random.RandomState(seed + 1)
    d_seq = torch.from_numpy(rng.randn(t, b, N, h).astype(np.float32)).to(
        dev, stream)
    streams = (shift_h_prev(h0, h_seq), ru, c)
    xin_bwd = (a_ops, wxg_f, wxc_f, wg_r, wc_r, *streams, x, d_seq)
    hoisted_bwd = (a_ops, wg_r, wc_r, *streams, d_seq)
    return xin_bwd, hoisted_bwd


@pytest.mark.parametrize("t,b,d,h", [(5, 4, 12, 16), (60, 37, 100, 64)])
@pytest.mark.parametrize("num_supports,shared", [(1, False), (1, True),
                                                 (2, False)])
@pytest.mark.parametrize("bf16", [False, True])
def test_bwd_kernels_match_plain(dev, t, b, d, h, num_supports, shared,
                                 bf16):
    stream = torch.bfloat16 if bf16 else torch.float32
    xin, hoisted = _bwd_inputs(dev, t=t, b=b, d=d, h=h,
                               num_supports=num_supports, shared=shared,
                               stream=stream)
    tol = 2e-2 if bf16 else 1e-4
    # the two wrappers launch no kernel of their own: their kernels count
    for kern, plain, args, counters in (
            (cr.dcgru_recurrence_xin_bwd, cr.dcgru_recurrence_xin_bwd_plain,
             xin, (cr.dcgru_xin_bwd_loop, cr.dcgru_xin_dw, cr.dcgru_xin_dx,
                   cr.dcgru_dw_reduce)),
            (cr.dcgru_recurrence_bwd, cr.dcgru_recurrence_bwd_plain,
             hoisted, HOISTED_BWD_KERNELS)):
        before = [k.launches for k in counters]
        got = kern(*args)
        torch.cuda.synchronize()
        assert [k.launches - b_ for k, b_ in zip(counters, before)] == \
            [1] * len(counters)
        want = plain(*args)
        assert len(got) == len(want)
        assert got[0].dtype == stream  # dx / dx_proj in the stream dtype
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, (kern.__name__, i)
            if i:
                assert g.dtype == torch.float32
            assert _err(g, w) <= tol, (kern.__name__, i, _err(g, w))


@pytest.mark.parametrize("t,b,d,h", [(5, 4, 12, 16), (60, 37, 100, 64)])
@pytest.mark.parametrize("bf16", [False, True])
def test_xin_bwd_kernel_without_dx(dev, t, b, d, h, bf16):
    """need_dx=False (the first layer, fed data): no dx, and every other
    output as the plain version's."""
    stream = torch.bfloat16 if bf16 else torch.float32
    xin, _ = _bwd_inputs(dev, t=t, b=b, d=d, h=h, num_supports=2,
                         shared=False, stream=stream)
    got = cr.dcgru_recurrence_xin_bwd(*xin, need_dx=False)
    want = cr.dcgru_recurrence_xin_bwd_plain(*xin)
    assert got[0] is None
    for i, (g, w) in enumerate(zip(got[1:], want[1:])):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _err(g, w) <= (2e-2 if bf16 else 1e-4), (i, _err(g, w))


@pytest.mark.parametrize("activation", ["relu", "linear"])
def test_bwd_kernel_activations(dev, activation):
    xin, hoisted = _bwd_inputs(dev, t=5, b=3, d=12, h=16, num_supports=2,
                               shared=False, stream=torch.float32,
                               activation=activation)
    for kern, plain, args in (
            (cr.dcgru_recurrence_xin_bwd, cr.dcgru_recurrence_xin_bwd_plain,
             xin),
            (cr.dcgru_recurrence_bwd, cr.dcgru_recurrence_bwd_plain,
             hoisted)):
        for g, w in zip(kern(*args, activation), plain(*args, activation)):
            assert _err(g, w) <= 1e-4


def test_dw_reduce_matches_plain(dev):
    part = torch.randn(37, 94_656, device=dev)
    assert _err(cr.dcgru_dw_reduce(part), cr.dcgru_dw_reduce_plain(part)) \
        <= 1e-5


def test_bwd_wrappers_raise_on_what_the_kernel_does_not_take(dev):
    xin, hoisted = _bwd_inputs(dev, t=5, b=3, d=12, h=16, num_supports=1,
                               shared=False, stream=torch.float32)
    d_seq = xin[-1]
    with pytest.raises(ValueError, match="contiguous"):
        cr.dcgru_recurrence_xin_bwd(
            *xin[:-1], d_seq.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(TypeError, match="streams mix"):
        cr.dcgru_recurrence_bwd(*hoisted[:-1], d_seq.bfloat16())
    with pytest.raises(TypeError, match="must be float32"):
        cr.dcgru_recurrence_bwd(hoisted[0], hoisted[1].double(),
                                *hoisted[2:])
    with pytest.raises(ValueError, match="stream"):
        cr.dcgru_recurrence_bwd(*hoisted[:-1], d_seq[:4].contiguous())


@pytest.mark.parametrize("t,b,d,h", [(5, 4, 12, 16), (60, 37, 100, 64),
                                     (60, 128, 64, 64)])
@pytest.mark.parametrize("num_supports,shared", [(1, False), (1, True),
                                                 (2, False)])
@pytest.mark.parametrize("bf16", [False, True])
def test_xin_pieces_match_plain(dev, t, b, d, h, num_supports, shared,
                                bf16):
    """The x-in layer's five kernels against their plain versions on the
    same inputs: the bulk projection, the state loops (forward, and
    backward without dW), the bulk dW split partials and the bulk dx."""
    stream = torch.bfloat16 if bf16 else torch.float32
    tol = 2e-2 if bf16 else 1e-4
    xin, _ = _bwd_inputs(dev, t=t, b=b, d=d, h=h, num_supports=num_supports,
                         shared=shared, stream=stream)
    a_ops, wxg_f, wxc_f, wg_r, wc_r, h_prev, ru, c, x, d_seq = xin
    fwd, _ = _inputs(dev, t=t, b=b, d=d, h=h, num_supports=num_supports,
                     shared=shared, stream=stream)
    wx = torch.cat([wxg_f, wxc_f], dim=1)
    xp = cr.dcgru_xin_proj_plain(x, a_ops, wx)
    dpre, _ = cr.dcgru_xin_bwd_loop_plain(a_ops, wg_r, wc_r, h_prev, ru, c,
                                          d_seq)
    cases = [
        (cr.dcgru_xin_proj, cr.dcgru_xin_proj_plain, (x, a_ops, wx), {}),
        (cr.dcgru_xin_fwd_loop, cr.dcgru_xin_fwd_loop_plain,
         (xp, a_ops, *fwd[4:]), dict(residuals=True, stream_dtype=stream)),
        (cr.dcgru_xin_bwd_loop, cr.dcgru_xin_bwd_loop_plain,
         (a_ops, wg_r, wc_r, h_prev, ru, c, d_seq), {}),
        (cr.dcgru_xin_dw, cr.dcgru_xin_dw_plain, (a_ops, h_prev, ru, x, dpre),
         {}),
        (cr.dcgru_xin_dx, cr.dcgru_xin_dx_plain, (a_ops, wx, dpre, stream),
         {}),
    ]
    for kern, plain, args, kw in cases:
        before = kern.launches
        got = kern(*args, **kw)
        torch.cuda.synchronize()
        assert kern.launches == before + 1, kern.__name__
        want = plain(*args, **kw)
        if isinstance(want, torch.Tensor):
            got, want = (got,), (want,)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype and g.shape == w.shape, \
                (kern.__name__, i)
            assert _err(g, w) <= tol, (kern.__name__, i, _err(g, w))
    # the split partials sum to the plain backward's dW and db
    total = cr.dcgru_dw_reduce(cr.dcgru_xin_dw(a_ops, h_prev, ru, x, dpre))
    want = cr.dcgru_recurrence_xin_bwd_plain(*xin)
    m = a_ops.shape[0]
    for g, w in zip(cr._split_dw(total, m, d, h), want[1:7]):
        assert _err(g, w) <= tol


def test_xin_bwd_dw_is_bitwise_deterministic(dev):
    """Two runs of the xin backward on the same inputs give bitwise-equal
    dW and db (fixed splits summed in order, no atomics)."""
    for stream in (torch.float32, torch.bfloat16):
        xin, _ = _bwd_inputs(dev, t=60, b=128, d=100, h=64, num_supports=1,
                             shared=False, stream=stream)
        runs = [cr.dcgru_recurrence_xin_bwd(*xin, need_dx=False)
                for _ in range(2)]
        for g, w in zip(runs[0][1:], runs[1][1:]):
            assert torch.equal(g, w)


def _dw_inputs(dev, *, t, b, n, d, h, num_supports, shared, stream,
               seed=0):
    """The bulk dW kernel's arguments (a_ops, h_prev, ru, x, dpre) at n
    nodes: streams in the stream dtype, ru in (0, 1), dpre float32."""
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (rng.randn(*s) * scale).astype(np.float32)).to(dev)
    sup = torch.from_numpy((np.abs(rng.randn(
        num_supports, 1 if shared else b, n, n)) / n).astype(np.float32))
    a_ops = chebyshev_operators(sup, K).contiguous().to(dev)
    return (a_ops, f(t, b, n, h, scale=0.5).to(stream),
            torch.sigmoid(f(t, b, n, 2 * h)).to(stream),
            f(t, b, n, d).to(stream), f(t, b, n, 3 * h, scale=0.1))


# (N, D, H, T, B) of the bulk dW cases: ragged nodes and widths (7, 12);
# the detector's layers at N=19 (T*B = 2,220 and 91: chunks of 5 pairs
# end short, splits start off 16-byte alignment); N=32; H=12 (a
# candidate tile of 12 columns)
DW_SHAPES = [(7, 12, 16, 5, 37), (19, 64, 64, 7, 13), (19, 100, 64, 60, 37),
             (32, 100, 64, 3, 9), (32, 12, 12, 4, 5)]


@pytest.mark.parametrize("n,d,h,t,b", DW_SHAPES)
@pytest.mark.parametrize("num_supports,shared", [(1, False), (1, True),
                                                 (2, False), (2, True)])
@pytest.mark.parametrize("bf16", [False, True])
def test_dw_kernel_matches_plain(dev, n, d, h, t, b, num_supports, shared,
                                 bf16):
    """The bulk dW kernel's split partials, and their sum, against the
    plain version: N=7, 19 and 32, D=12, 64 and 100, T*B not a multiple
    of a chunk, a_batch 1 and B, M=3 and 5."""
    stream = torch.bfloat16 if bf16 else torch.float32
    tol = 2e-2 if bf16 else 1e-4
    args = _dw_inputs(dev, t=t, b=b, n=n, d=d, h=h,
                      num_supports=num_supports, shared=shared,
                      stream=stream, seed=n + d + t)
    before = cr.dcgru_xin_dw.launches
    got = cr.dcgru_xin_dw(*args)
    torch.cuda.synchronize()
    assert cr.dcgru_xin_dw.launches == before + 1
    want = cr.dcgru_xin_dw_plain(*args)
    m = num_supports * K + 1
    assert got.shape == want.shape == (cr.dw_splits(t * b, m, d, h),
                                       cr.dw_size(m, d, h))
    assert torch.isfinite(got).all()
    assert _err(got, want) <= tol, _err(got, want)
    assert _err(cr.dcgru_dw_reduce(got), want.sum(0)) <= tol


@pytest.mark.parametrize("t,d", [(12, 100), (24, 64)])
@pytest.mark.parametrize("bf16", [False, True])
def test_dw_kernel_at_the_decoder_launch_shapes(dev, t, d, bf16):
    """The SSL decoder's two dW launches (B=128, M=3): layer 0 at D=100
    over T_out=12 steps, the tied cell at D=64 over (L-1) T_out = 24
    stacked steps, each reduced, against the plain version."""
    stream = torch.bfloat16 if bf16 else torch.float32
    args = _dw_inputs(dev, t=t, b=128, n=N, d=d, h=64, num_supports=1,
                      shared=False, stream=stream, seed=t)
    got = cr.dcgru_dw_reduce(cr.dcgru_xin_dw(*args))
    want = cr.dcgru_xin_dw_plain(*args).sum(0)
    assert _err(got, want) <= (2e-2 if bf16 else 1e-4), _err(got, want)


def test_dw_kernel_is_bitwise_deterministic(dev):
    """Two launches on the same inputs give the same bits (fixed splits
    and chunks, fixed sums, no atomics), per-clip and shared graphs."""
    for stream in (torch.float32, torch.bfloat16):
        for shared in (False, True):
            args = _dw_inputs(dev, t=60, b=128, n=N, d=100, h=64,
                              num_supports=1, shared=shared, stream=stream)
            assert torch.equal(cr.dcgru_xin_dw(*args),
                               cr.dcgru_xin_dw(*args))


@pytest.mark.parametrize("where", ["dpre", "x", "h_prev", "r", "u"])
@pytest.mark.parametrize("bf16", [False, True])
def test_dw_kernel_keeps_a_device_nan(dev, where, bf16):
    """A NaN that a device op made, in one entry of dpre, x, h_prev or the
    r or u half of ru, reaches exactly the partials' entries it reaches
    in the plain version (u: none)."""
    stream = torch.bfloat16 if bf16 else torch.float32
    args = list(_dw_inputs(dev, t=5, b=37, n=N, d=100, h=64,
                           num_supports=1, shared=False, stream=stream))
    i, col = {"dpre": (4, 70), "x": (3, 33), "h_prev": (1, 5),
              "r": (2, 9), "u": (2, 64 + 9)}[where]
    nan = (torch.zeros(1, device=dev) / 0)[0]
    v = args[i].clone()
    v[4, 30, 11, col] = nan
    args[i] = v
    got = cr.dcgru_xin_dw(*args)
    want = cr.dcgru_xin_dw_plain(*args)
    assert not want.isnan().all()
    assert want.isnan().any() == (where != "u")
    assert torch.equal(got.isnan(), want.isnan())


# (N, H, T, B) of the bulk dW at D = 0 (the hoisted layer's: no x)
DW0_SHAPES = [(7, 16, 5, 37), (19, 64, 60, 37), (19, 64, 60, 128),
              (32, 12, 4, 5)]


@pytest.mark.parametrize("n,h,t,b", DW0_SHAPES)
@pytest.mark.parametrize("num_supports,shared", [(1, False), (1, True),
                                                 (2, False), (0, False)])
@pytest.mark.parametrize("bf16", [False, True])
def test_dw_kernel_at_d0_matches_plain(dev, n, h, t, b, num_supports, shared,
                                       bf16):
    """The bulk dW kernel fed a zero-width x (D = 0): slabs [dWg | dWc |
    dbg | dbc] only, each split against the plain version, and their
    sum; M=1, 3 and 5."""
    stream = torch.bfloat16 if bf16 else torch.float32
    s_ = max(num_supports, 1)
    a_ops, h_prev, ru, _, dpre = _dw_inputs(
        dev, t=t, b=b, n=n, d=4, h=h, num_supports=s_, shared=shared,
        stream=stream, seed=n + t + h)
    if num_supports == 0:
        a_ops = a_ops[:1].contiguous()  # M = 1: the identity alone
    x0 = h_prev.new_empty((t, b, n, 0))
    m = a_ops.shape[0]
    got = cr.dcgru_xin_dw(a_ops, h_prev, ru, x0, dpre)
    want = cr.dcgru_xin_dw_plain(a_ops, h_prev, ru, x0, dpre)
    assert got.shape == want.shape == (cr.dw_splits(t * b, m, 0, h),
                                       cr.dw_size(m, 0, h))
    assert torch.isfinite(got).all()
    tol = 2e-2 if bf16 else 1e-4
    assert _err(got, want) <= tol, _err(got, want)
    assert _err(cr.dcgru_dw_reduce(got), want.sum(0)) <= tol


@pytest.mark.parametrize("bf16", [False, True])
def test_hoisted_bwd_is_bitwise_deterministic(dev, bf16):
    """Two runs of the hoisted layer's BPTT (loop, dW at D = 0, reduction)
    on the same inputs give the same bits, every output."""
    stream = torch.bfloat16 if bf16 else torch.float32
    _, hoisted = _bwd_inputs(dev, t=60, b=128, d=100, h=64, num_supports=1,
                             shared=False, stream=stream)
    runs = [cr.dcgru_recurrence_bwd(*hoisted) for _ in range(2)]
    for g, w in zip(*runs):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bf16", [False, True])
def test_hoisted_bwd_keeps_a_device_nan(dev, bf16):
    """A NaN that a device op made, in one entry of h_prev[0] of otherwise
    finite residuals, reaches exactly the entries of dx_proj, dW, db and
    dh0 that it reaches in the plain version."""
    stream = torch.bfloat16 if bf16 else torch.float32
    _, hoisted = _bwd_inputs(dev, t=5, b=4, d=12, h=16, num_supports=1,
                             shared=False, stream=stream)
    args = list(hoisted)
    h_prev = args[3].clone()
    h_prev[0, 2, 4, 5] = (torch.zeros(1, device=dev) / 0)[0]
    args[3] = h_prev
    got = cr.dcgru_recurrence_bwd(*args)
    want = cr.dcgru_recurrence_bwd_plain(*args)
    assert any(w.isnan().any() for w in want)
    for g, w in zip(got, want):
        assert torch.equal(g.isnan(), w.isnan())


# the bf16 dW kernel against its emulated rounding (chain_emulation.dw_chain)
DW_ROUNDING_TOL = 1e-3


@pytest.mark.parametrize("num_supports", [1, 2])
def test_bf16_dw_kernel_computes_its_operand_rounding(dev, num_supports,
                                                      record_property):
    """The bf16 kernel computes the stated rounding (G_m = A_m^T dpre in
    one bf16 pass, rounded to bf16; r h_prev rounded to bf16; f32 sums),
    emulated on the card: the reduced dW and db within the bar of the
    emulation; the plain version (f32 features) is recorded beside."""
    from chain_emulation import dw_chain

    args = _dw_inputs(dev, t=7, b=13, n=N, d=100, h=64,
                      num_supports=num_supports, shared=False,
                      stream=torch.bfloat16)
    want = dw_chain(*args, bf16=True)
    got = cr.dcgru_dw_reduce(cr.dcgru_xin_dw(*args))
    plain = cr.dcgru_xin_dw_plain(*args).sum(0)
    errs = {"kernel": _err(got, want), "plain": _err(plain, want)}
    record_property("kernel_and_plain_vs_emulation", errs)
    assert errs["kernel"] <= DW_ROUNDING_TOL, errs


def _bulk_inputs(dev, *, t, b, n, d, h, num_supports, shared, stream,
                 seed=0):
    """The bulk projection's and dx's arguments at n nodes: (a_ops, x in
    the stream dtype, Wxg, Wxc, dpre f32)."""
    rng = np.random.RandomState(seed)
    f = lambda *s, scale=1.0: torch.from_numpy(
        (rng.randn(*s) * scale).astype(np.float32)).to(dev)
    sup = torch.from_numpy((np.abs(rng.randn(
        num_supports, 1 if shared else b, n, n)) / n).astype(np.float32))
    a_ops = chebyshev_operators(sup, K).contiguous().to(dev)
    m = a_ops.shape[0]
    return (a_ops, f(t, b, n, d).to(stream), f(m * d, 2 * h, scale=0.1),
            f(m * d, h, scale=0.1), f(t, b, n, 3 * h, scale=0.1))


# (N, D, H, T, B) of the bulk projection and dx cases: ragged nodes and
# widths (7, 12); the detector's layers at N=19 (T*B = 2,220 and 91: the
# last chunk ends short, T*B is no multiple of a wave); N=32; H=12; 3H=288
# (bf16 dx's rows by 1-D copies: wider than a tensor copy's box; f32's
# projection in two column tiles); the benchmark cells' two layers (T=60,
# B=256)
BULK_SHAPES = [(7, 12, 16, 5, 37), (19, 64, 64, 7, 13), (19, 100, 64, 60, 37),
               (32, 100, 64, 3, 9), (32, 12, 12, 4, 5), (19, 12, 96, 3, 5),
               (19, 100, 64, 60, 256), (19, 64, 64, 60, 256)]
# the bf16 kernels against their emulated rounding: the projection's f32
# sums, dx's one bf16 rounding of the output (2^-8 of the largest entry)
PROJ_ROUNDING_TOL, DX_ROUNDING_TOL = 1.5e-3, 4e-3


@pytest.mark.parametrize("n,d,h,t,b", BULK_SHAPES)
@pytest.mark.parametrize("num_supports,shared", [(1, False), (1, True),
                                                 (2, False), (2, True)])
@pytest.mark.parametrize("bf16", [False, True])
def test_bulk_proj_dx_match_plain_and_emulation(dev, n, d, h, t, b,
                                                num_supports, shared, bf16,
                                                record_property):
    """The tensor-core projection and dx against their plain versions
    (2e-2 bf16, 1e-4 f32) and against the emulation of their rounding
    (chain_emulation.proj_chain / dx_chain): N=7, 19 and 32, D=12, 64 and
    100, M=3 and 5, a_batch 1 and B, weights joined and as (Wxg, Wxc)."""
    from chain_emulation import dx_chain, proj_chain

    stream = torch.bfloat16 if bf16 else torch.float32
    tol = 2e-2 if bf16 else 1e-4
    a_ops, x, wxg, wxc, dpre = _bulk_inputs(
        dev, t=t, b=b, n=n, d=d, h=h, num_supports=num_supports,
        shared=shared, stream=stream, seed=n + d + t)
    wx = torch.cat([wxg, wxc], dim=1)
    errs = {}
    for kern, plain, emu, args, rtol in (
            (cr.dcgru_xin_proj, cr.dcgru_xin_proj_plain,
             lambda: proj_chain(a_ops, x, wx, bf16), (x, a_ops),
             PROJ_ROUNDING_TOL),
            (cr.dcgru_xin_dx, cr.dcgru_xin_dx_plain,
             lambda: dx_chain(a_ops, wx, dpre, torch.float32, bf16),
             (a_ops,), DX_ROUNDING_TOL)):
        name = kern.__name__
        tail = (dpre, stream) if name == "dcgru_xin_dx" else ()
        before = kern.launches
        got = kern(*args, (wxg, wxc), *tail)
        joined = kern(*args, wx, *tail)
        torch.cuda.synchronize()
        assert kern.launches == before + 2
        assert torch.equal(got, joined), name
        want = plain(*args, wx, *tail)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.isfinite(got).all(), name
        errs[name] = {"plain": _err(got, want), "emulation": _err(got, emu())}
        assert errs[name]["plain"] <= tol, errs
        assert errs[name]["emulation"] <= (rtol if bf16 else 1e-5), errs
    record_property("kernel_vs_plain_and_emulation", errs)


@pytest.mark.parametrize("bf16", [False, True])
def test_bulk_proj_dx_take_one_operator(dev, bf16):
    """M=1 (no diffusion step: the identity alone, no operator fragments)
    against the plain versions."""
    stream = torch.bfloat16 if bf16 else torch.float32
    _, x, wxg, wxc, dpre = _bulk_inputs(dev, t=7, b=13, n=N, d=64, h=64,
                                        num_supports=1, shared=True,
                                        stream=stream)
    a_ops = torch.eye(N, device=dev)[None, None].contiguous()
    wxg, wxc = wxg[:64].contiguous(), wxc[:64].contiguous()
    wx = torch.cat([wxg, wxc], dim=1)
    tol = 2e-2 if bf16 else 1e-4
    got = cr.dcgru_xin_proj(x, a_ops, (wxg, wxc))
    assert _err(got, cr.dcgru_xin_proj_plain(x, a_ops, wx)) <= tol
    got = cr.dcgru_xin_dx(a_ops, (wxg, wxc), dpre, stream)
    assert _err(got, cr.dcgru_xin_dx_plain(a_ops, wx, dpre, stream)) <= tol


@pytest.mark.parametrize("bf16", [False, True])
def test_bulk_proj_dx_are_bitwise_deterministic(dev, bf16):
    """Two launches on the same inputs give the same bits (every output
    element from one block's registers, no sums across blocks), per-clip
    and shared graphs, at the detector's layer 0."""
    stream = torch.bfloat16 if bf16 else torch.float32
    for shared in (False, True):
        a_ops, x, wxg, wxc, dpre = _bulk_inputs(
            dev, t=60, b=128, n=N, d=100, h=64, num_supports=1,
            shared=shared, stream=stream)
        assert torch.equal(cr.dcgru_xin_proj(x, a_ops, (wxg, wxc)),
                           cr.dcgru_xin_proj(x, a_ops, (wxg, wxc)))
        assert torch.equal(cr.dcgru_xin_dx(a_ops, (wxg, wxc), dpre, stream),
                           cr.dcgru_xin_dx(a_ops, (wxg, wxc), dpre, stream))


@pytest.mark.parametrize("where", ["in", "operator", "wxg", "wxc"])
@pytest.mark.parametrize("bf16", [False, True])
def test_bulk_proj_dx_keep_a_device_nan(dev, where, bf16):
    """A NaN that a device op made, in one entry of the input (x for the
    projection, dpre for dx), of an operator A_m or of Wx, reaches exactly
    the output entries it reaches in the plain version."""
    stream = torch.bfloat16 if bf16 else torch.float32
    nan = (torch.zeros(1, device=dev) / 0)[0]
    a_ops, x, wxg, wxc, dpre = _bulk_inputs(
        dev, t=5, b=37, n=N, d=100, h=64, num_supports=2, shared=False,
        stream=stream)
    if where == "operator":
        a_ops = a_ops.clone()
        a_ops[3, 11, 7, 2] = nan
    elif where in ("wxg", "wxc"):
        w = (wxg if where == "wxg" else wxc).clone()
        w[2 * 100 + 17, 9] = nan
        wxg, wxc = (w, wxc) if where == "wxg" else (wxg, w)
    wx = torch.cat([wxg, wxc], dim=1)
    for kind in ("proj", "dx"):
        xs, dp = x, dpre
        if where == "in":
            if kind == "proj":
                xs = x.clone()
                xs[3, 11, 5, 33] = nan
            else:
                dp = dpre.clone()
                dp[3, 11, 5, 70] = nan
        if kind == "proj":
            got = cr.dcgru_xin_proj(xs, a_ops, (wxg, wxc))
            want = cr.dcgru_xin_proj_plain(xs, a_ops, wx)
        else:
            got = cr.dcgru_xin_dx(a_ops, (wxg, wxc), dp, stream)
            want = cr.dcgru_xin_dx_plain(a_ops, wx, dp, stream)
        assert want.isnan().any() and not want.isnan().all(), (kind, where)
        assert torch.equal(got.isnan(), want.isnan()), (kind, where)


def test_bulk_plans_take_every_branch(dev, record_property):
    """The plans the detector's launches take (two bf16 blocks an SM for
    the projection, 11 warps for dx; f32: three warpgroups and every
    column in one tile for the projection, the weights through a ring;
    dx's diffusion on the output side at D=64, on the input side at
    D=100), a bf16 dx whose rows come by 1-D copies and an f32 projection
    of two column tiles (3H = 288); every plan fits the card."""
    plans = {}
    for proj in (True, False):
        for bf16 in (True, False):
            for d in (100, 64):
                key = (("proj" if proj else "dx"), d,
                       "bf16" if bf16 else "f32")
                plans[key] = cr.xin_bulk_plan(proj, 60, 128, N, d, 64, 3,
                                              128, bf16)
    plans[("dx", 12, "bf16", "H=96")] = cr.xin_bulk_plan(False, 3, 5, N, 12,
                                                         96, 3, 5, True)
    plans[("proj", 12, "f32", "H=96")] = cr.xin_bulk_plan(True, 3, 5, N, 12,
                                                          96, 3, 5, False)
    record_property("plans", {str(k): v for k, v in plans.items()})
    for key, v in plans.items():
        assert v["blocks_per_sm"] >= 1, key
        assert v["smem_bytes"] <= 232448, key
    assert plans[("proj", 100, "bf16")]["blocks_per_sm"] == 2
    assert plans[("dx", 64, "bf16")]["threads"] >= 32 * 9
    assert plans[("dx", 12, "bf16", "H=96")]["in_tensor_map"] == 0
    for d in (100, 64):
        f32 = plans[("proj", d, "f32")]
        assert f32["warpgroups"] == 3 and f32["col_tiles"] == 1, f32
        assert f32["cols_per_block"] == 192 and f32["weight_slots"] >= 2
    # dx at D=64 on the output side: Y_0..Y_2 (3 x 64 columns) in one
    # block, a slot more than its three wgmma groups in flight (per-clip
    # operators leave room for one warpgroup, one shared graph for two); at
    # D=100 (3 x 104 columns) on the input side, 64 columns a block beside
    # their register sum
    dx64, dx100 = plans[("dx", 64, "f32")], plans[("dx", 100, "f32")]
    assert dx64["col_tiles"] == 1 and dx64["cols_per_block"] == 192, dx64
    assert dx64["weight_slots"] >= 4, dx64
    shared = cr.xin_bulk_plan(False, 60, 128, N, 64, 64, 3, 1, False)
    record_property("dx64_f32_shared_graph", shared)
    assert shared["warpgroups"] == 2 and shared["weight_slots"] >= 4, shared
    assert dx100["col_tiles"] == 2 and dx100["cols_per_block"] == 64, dx100
    assert plans[("proj", 12, "f32", "H=96")]["col_tiles"] == 2


def _loop_inputs(dev, *, t, b, n, h, num_supports, shared, stream,
                 activation="tanh", seed=0, w_scale=0.1):
    """The state loops' arguments at n nodes: (forward loop fed an f32
    projection, the hoisted forward fed x_proj in the stream dtype, the
    backward loop on the plain forward's residuals and a seeded h_seq
    cotangent); hidden weights of std ``w_scale``."""
    rng = np.random.RandomState(seed)
    m = num_supports * K + 1
    f = lambda *s, scale=0.1: torch.from_numpy(
        (rng.randn(*s) * scale).astype(np.float32)).to(dev)
    sup = torch.from_numpy((np.abs(rng.randn(
        num_supports, 1 if shared else b, n, n)) / n).astype(np.float32))
    a_ops = chebyshev_operators(sup, K).contiguous().to(dev)
    hidden = (f(m, h, 2 * h, scale=w_scale), f(m, h, h, scale=w_scale),
              f(2 * h), f(h), f(b, n, h))
    xp = f(t, b, n, 3 * h, scale=0.5)
    fwd = (xp, a_ops, *hidden)
    h_seq, ru, c = cr.dcgru_xin_fwd_loop_plain(*fwd, activation, True,
                                               stream)
    d_seq = f(t, b, n, h, scale=1.0).to(stream)
    bwd = (a_ops, hidden[0], hidden[1], shift_h_prev(hidden[4], h_seq), ru,
           c, d_seq)
    return fwd, (xp.to(stream), *fwd[1:]), bwd


@pytest.mark.parametrize("t,n,h", [(1, 19, 16), (7, 19, 64), (5, 32, 16),
                                   (3, 32, 64), (4, 7, 12)])
@pytest.mark.parametrize("num_supports,shared", [(2, False), (2, True),
                                                 (0, False)])
@pytest.mark.parametrize("activation", ["tanh", "relu", "linear"])
@pytest.mark.parametrize("bf16", [False, True])
def test_tensor_core_loops_match_plain(dev, t, n, h, num_supports, shared,
                                       activation, bf16):
    """The encoder's state loops (the forward fed an f32 projection or
    x_proj in the stream dtype, the backward without dW) and #4's BPTT
    beside them, against their plain versions: M=5 (and M=1), per-clip
    and shared graphs, N=19 and 32 (and a ragged 7), H=16 and 64 (and
    12: ragged tiles), T=1 upwards, every activation."""
    stream = torch.bfloat16 if bf16 else torch.float32
    tol = 2e-2 if bf16 else 1e-4
    fwd, hoisted, bwd = _loop_inputs(
        dev, t=t, b=3, n=n, h=h, num_supports=num_supports, shared=shared,
        stream=stream, activation=activation, seed=t * n + h)
    kw = dict(residuals=True)
    cases = [
        (cr.dcgru_xin_fwd_loop, cr.dcgru_xin_fwd_loop_plain, fwd,
         dict(kw, activation=activation, stream_dtype=stream), None),
        (cr.dcgru_recurrence_fwd, cr.dcgru_recurrence_fwd_plain, hoisted,
         dict(kw, activation=activation), None),
        (cr.dcgru_xin_bwd_loop, cr.dcgru_xin_bwd_loop_plain, bwd,
         dict(activation=activation), None),
        # a composite: its kernels count
        (cr.dcgru_recurrence_bwd, cr.dcgru_recurrence_bwd_plain, bwd,
         dict(activation=activation), HOISTED_BWD_KERNELS),
    ]
    for kern, plain, args, kw, counters in cases:
        counters = counters or (kern,)
        before = [k.launches for k in counters]
        got = kern(*args, **kw)
        torch.cuda.synchronize()
        assert [k.launches - b_ for k, b_ in zip(counters, before)] == \
            [1] * len(counters), kern.__name__
        want = plain(*args, **kw)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.dtype == w.dtype and g.shape == w.shape, \
                (kern.__name__, i)
            assert torch.isfinite(g.float()).all(), (kern.__name__, i)
            assert _err(g, w) <= tol, (kern.__name__, i, _err(g, w))


def _past_rounding(got, want):
    """Each element's error left after ``got``'s own rounding to its
    dtype, normalized: max(|got - want| - ulp(got) / 2, 0) / max|want| for
    a float32 ``want``. A bf16 ``got`` that is ``want`` rounded to nearest
    reads 0; a float32 ``got`` reads |got - want| / max|want|."""
    got32, want = got.float(), want.float()
    half_ulp = torch.zeros_like(got32)
    if got.dtype == torch.bfloat16:
        half_ulp = torch.exp2(torch.floor(torch.log2(
            got32.abs().clamp_min(1e-30))) - 8)
    past = ((got32 - want).abs() - half_ulp).clamp_min(0)
    return past / want.abs().max().clamp_min(1e-12)


def _err_past_rounding(got, want):
    """The largest of :func:`_past_rounding`: a float32 ``got`` reads as
    :func:`_err`."""
    return _past_rounding(got, want).max().item()


# bar of the bf16 loops against their emulated operand rounding at T=2:
# above what the kernels read, below what plain f32 products read against
# the same emulation on their farthest output (PERF.md, section 6)
ROUNDING_TOL = 1.2e-3


@pytest.mark.parametrize("activation", ["tanh", "relu", "linear"])
@pytest.mark.parametrize("shared", [False, True])
def test_bf16_loops_compute_their_operand_rounding(dev, activation, shared,
                                                   record_property):
    """The bf16 loops compute the stated rounding: bf16 product operands
    and f32 sums, emulated on the card (tests/chain_emulation.py), with
    hidden weights of std 0.3 so that the operand rounding shows. The
    forward's bf16 outputs are held to the emulation's f32 values past
    their own rounding, the backward's f32 outputs as they are. The
    plain loops (f32 products) must read above the bar on some output,
    so a kernel with f32 products fails. Two steps: a bf16 operand that
    the kernel's diffusions (summed in another f32 order) round the
    other way moves a step's output by ~1e-3 here, and over more steps
    such flips compound until no bar tells the two roundings apart."""
    from chain_emulation import chain_bwd, chain_fwd

    stream, tol = torch.bfloat16, ROUNDING_TOL
    fwd, _, bwd = _loop_inputs(dev, t=2, b=3, n=N, h=64, num_supports=2,
                               shared=shared, stream=stream,
                               activation=activation, seed=197, w_scale=0.3)
    got = cr.dcgru_xin_fwd_loop(*fwd, activation, True, stream)
    want = chain_fwd(*fwd, torch.float32, activation)
    plain = cr.dcgru_xin_fwd_loop_plain(*fwd, activation, True, stream)
    errs = {}
    for i, (g, w, p) in enumerate(zip(got, want, plain)):
        errs[f"fwd{i}"] = (_err_past_rounding(g, w),
                           _err_past_rounding(p, w))
    got = cr.dcgru_xin_bwd_loop(*bwd, activation)
    want = chain_bwd(*bwd, activation)
    plain = cr.dcgru_xin_bwd_loop_plain(*bwd, activation)
    for i, (g, w, p) in enumerate(zip(got, want, plain)):
        errs[f"bwd{i}"] = (_err(g, w), _err(p, w))
    # (kernel, plain) against the emulation, read from the junit XML
    record_property("kernel_and_plain_vs_emulation", errs)
    for k, (kern, _) in errs.items():
        assert kern <= tol, (k, errs)
    # and the bar tells the stated rounding from f32 products
    assert max(p for _, p in errs.values()) > tol, errs


def test_tensor_core_loops_are_bitwise_deterministic(dev):
    """Two runs of each state loop on the same inputs give the same bits
    (fixed tiles summed in a fixed order)."""
    for stream in (torch.float32, torch.bfloat16):
        fwd, hoisted, bwd = _loop_inputs(dev, t=60, b=128, n=N, h=64,
                                         num_supports=2, shared=False,
                                         stream=stream)
        for kern, args, kw in (
                (cr.dcgru_xin_fwd_loop, fwd,
                 dict(residuals=True, stream_dtype=stream)),
                (cr.dcgru_recurrence_fwd, hoisted, dict(residuals=True)),
                (cr.dcgru_xin_bwd_loop, bwd, {})):
            runs = [kern(*args, **kw) for _ in range(2)]
            for g, w in zip(*runs):
                assert torch.equal(g, w), kern.__name__


@pytest.mark.parametrize("bf16", [False, True])
def test_tensor_core_loops_keep_a_device_nan(dev, bf16):
    """A NaN that a device op made, in one entry of h0: the forward loop
    carries it into h_seq (the whole clip, through the diffusions) and the
    backward loop, fed it as h_prev[0] of otherwise finite residuals, into
    dpre (that node's gate entries) and dh0, where the plain loops do."""
    stream = torch.bfloat16 if bf16 else torch.float32
    fwd, _, bwd = _loop_inputs(dev, t=5, b=4, n=N, h=16, num_supports=1,
                               shared=False, stream=stream)
    nan = torch.zeros(1, device=dev) / 0
    h0 = fwd[-1].clone()
    h0[2, 4, 5] = nan[0]
    args = (*fwd[:-1], h0)
    got = cr.dcgru_xin_fwd_loop(*args, stream_dtype=stream)[0]
    want = cr.dcgru_xin_fwd_loop_plain(*args, stream_dtype=stream)[0]
    assert want.isnan().any() and not want.isnan().all()
    assert torch.equal(got.isnan(), want.isnan())
    h_prev = bwd[3].clone()
    h_prev[0, 2, 4, 5] = nan[0]
    args = (*bwd[:3], h_prev, *bwd[4:])
    got = cr.dcgru_xin_bwd_loop(*args)
    want = cr.dcgru_xin_bwd_loop_plain(*args)
    for g, w in zip(got, want):
        assert w.isnan().any() and not w.isnan().all()
        assert torch.equal(g.isnan(), w.isnan())


def test_xin_piece_wrappers_raise(dev):
    xin, _ = _bwd_inputs(dev, t=5, b=3, d=12, h=16, num_supports=1,
                         shared=False, stream=torch.float32)
    a_ops, wxg_f, wxc_f, wg_r, wc_r, h_prev, ru, c, x, d_seq = xin
    wx = torch.cat([wxg_f, wxc_f], dim=1)
    dpre = torch.zeros(5, 3, N, 48, device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cr.dcgru_xin_proj(x.half(), a_ops, wx)
    with pytest.raises(ValueError, match="contiguous"):
        cr.dcgru_xin_dx(a_ops, wx.t().contiguous().t(), dpre, torch.float32)
    with pytest.raises(TypeError, match="must be float32"):
        cr.dcgru_xin_dw(a_ops, h_prev, ru, x, dpre.bfloat16())
    with pytest.raises(TypeError, match="xp must be float32"):
        cr.dcgru_xin_fwd_loop(dpre.bfloat16(), a_ops, wg_r, wc_r,
                              torch.zeros(32, device=dev),
                              torch.zeros(16, device=dev),
                              torch.zeros(3, N, 16, device=dev))


def test_flagship_train_step_matches_stacked(dev):
    """One flagship detection step (B=128, T=60, 2x64, D=100, combined
    graph, f32): the kernels' gradients against the stacked step's."""
    from eeg_gnn_tpu_torch.config import ExperimentConfig
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.train import TrainStep

    rng = np.random.RandomState(0)
    adj = np.abs(rng.rand(128, N, N)).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    batch = {"x": rng.randn(128, 60, N, 100).astype(np.float32),
             "y": rng.randint(0, 2, size=128).astype(np.float32),
             "adjacency": adj}
    cfg = ExperimentConfig(graph_type="combined").finalize()
    grads = {}
    for rec in ("pallas", "stacked"):
        c = dataclasses.replace(cfg, recurrence=rec)
        step = TrainStep(c, build_model(c, torch.Generator().manual_seed(0)),
                         100, device=dev)
        counters = (cr.dcgru_xin_proj, cr.dcgru_xin_fwd_loop,
                    cr.dcgru_xin_bwd_loop, cr.dcgru_xin_dw, cr.dcgru_xin_dx,
                    cr.dcgru_dw_reduce)
        before = [k.launches for k in counters]
        loss = step.loss_and_grads(batch)
        rose = [k.launches - b_ for k, b_ in zip(counters, before)]
        # the first layer, fed data, asks for no dx
        assert rose == ([2, 2, 2, 2, 1, 2] if rec == "pallas" else [0] * 6)
        assert torch.isfinite(loss)
        grads[rec] = {n: p.grad.clone()
                      for n, p in step.model.named_parameters()}
    for name, g in grads["pallas"].items():
        assert _err(g, grads["stacked"][name]) <= 1e-4, name


# ---------------------------------------------------------------------------
# the seq2seq decoder kernels (csrc/dcgru_decoder.cu)
# ---------------------------------------------------------------------------

_FORCES = {"none": lambda t: [0.0] * t, "all": lambda t: [1.0] * t,
           "mixed": lambda t: [float(i % 2) for i in range(t)]}


def _dec_inputs(dev, *, t, b, d, h, num_layers, num_supports, shared,
                stream, force, seed=0):
    """Decoder-kernel forward arguments: xavier-scaled weights, a seeded
    teacher-forcing stream and a force pattern."""
    rng = np.random.RandomState(seed)
    m = num_supports * K + 1
    f = lambda *s, scale: torch.from_numpy(
        (rng.randn(*s) * scale).astype(np.float32)).to(dev)
    sup = torch.from_numpy((np.abs(rng.randn(
        num_supports, 1 if shared else b, N, N)) / N).astype(np.float32))
    a_ops = chebyshev_operators(sup, K).contiguous().to(dev)

    def cell(d_in):
        sx, sh = (2.0 / (m * (d_in + h))) ** 0.5, (2.0 / (m * 2 * h)) ** 0.5
        return [f(m * d_in, 2 * h, scale=sx), f(m * d_in, h, scale=sx),
                f(m * h, 2 * h, scale=sh), f(m * h, h, scale=sh),
                f(2 * h, scale=0.1), f(h, scale=0.1)]

    shared_w = cell(h) if num_layers > 1 else [None] * 6
    return (a_ops, f(t, b, N, d, scale=1.0).to(stream),
            torch.tensor(_FORCES[force](t), device=dev), *cell(d),
            *shared_w, f(h, d, scale=h ** -0.5), f(d, scale=0.1),
            f(num_layers, b, N, h, scale=0.1))


def _dec_bwd_args(args, num_layers, seed=1):
    """Backward-kernel arguments on the plain forward's residuals and a
    seeded proj cotangent."""
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd

    _, in0, h_seq, ru, c = cd.dcgru_decoder_fwd_plain(*args, num_layers,
                                                      residuals=True)
    a_ops, x, force, *w = args
    rng = np.random.RandomState(seed)
    d_seq = torch.from_numpy(rng.randn(*x.shape).astype(np.float32)).to(
        x.device, x.dtype)
    return (a_ops, *w[0:4], *w[6:10], w[12], cd.decoder_h_prev(w[14], h_seq),
            h_seq, ru, c, in0, d_seq, force)


@pytest.mark.parametrize("t,b,d,h", [(4, 3, 12, 16), (12, 37, 100, 64)])
@pytest.mark.parametrize("num_layers", [1, 2, 3])
@pytest.mark.parametrize("num_supports,shared,force", [
    (1, False, "mixed"), (1, True, "none"), (2, False, "all")])
@pytest.mark.parametrize("bf16", [False, True])
def test_decoder_kernels_match_plain(dev, t, b, d, h, num_layers,
                                     num_supports, shared, force, bf16):
    """Kernels #5 and #6 against their plain versions: proj and every
    residual; dx, dh0 and every weight and bias gradient."""
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd

    stream = torch.bfloat16 if bf16 else torch.float32
    tol = 2e-2 if bf16 else 1e-4
    args = _dec_inputs(dev, t=t, b=b, d=d, h=h, num_layers=num_layers,
                       num_supports=num_supports, shared=shared,
                       stream=stream, force=force)
    before = cd.dcgru_decoder_fwd.launches
    got = cd.dcgru_decoder_fwd(*args, num_layers, residuals=True)
    torch.cuda.synchronize()
    assert cd.dcgru_decoder_fwd.launches == before + 1
    for g, w in zip(got, cd.dcgru_decoder_fwd_plain(*args, num_layers,
                                                    residuals=True)):
        assert g.dtype == stream and g.shape == w.shape
        assert _err(g, w) <= tol
    bwd = _dec_bwd_args(args, num_layers)
    counters = (cd.dcgru_dec_bwd_loop, cr.dcgru_xin_dw, cd.dcgru_dec_dwp,
                cr.dcgru_dw_reduce)
    before = [k.launches for k in counters]
    got = cd.dcgru_decoder_bwd(*bwd, num_layers)
    torch.cuda.synchronize()
    # the loop, one dW product per cell, dWp, and a reduction of each
    cells = 2 if num_layers > 1 else 1
    assert [k.launches - b_ for k, b_ in zip(counters, before)] == \
        [1, cells, 1, cells + 1]
    want = cd.dcgru_decoder_bwd_plain(*bwd, num_layers)
    assert got[0].dtype == stream and len(got) == len(want) == 16
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None and num_layers == 1
            continue
        assert g.shape == w.shape, i
        if i:
            assert g.dtype == torch.float32
        assert _err(g, w) <= tol, (i, _err(g, w))


@pytest.mark.parametrize("t,b,d,h", [(4, 3, 12, 16), (12, 128, 100, 64)])
@pytest.mark.parametrize("num_layers", [1, 2, 3])
@pytest.mark.parametrize("bf16", [False, True])
def test_decoder_bwd_pieces_match_plain(dev, t, b, d, h, num_layers, bf16):
    """The decoder backward's kernels against their plain versions on the
    same inputs: the state loop (dx, dh0, dpre, dproj), the two bulk dW
    products (layer 0, the tied cell over the stacked layers) summed, and
    dWp; and the composite twice on the same inputs, bitwise equal."""
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd

    stream = torch.bfloat16 if bf16 else torch.float32
    tol = 2e-2 if bf16 else 1e-4
    args = _dec_inputs(dev, t=t, b=b, d=d, h=h, num_layers=num_layers,
                       num_supports=1, shared=False, stream=stream,
                       force="mixed")
    bwd = _dec_bwd_args(args, num_layers)
    loop_args, dw_cells, h_top = cd.decoder_bwd_pieces(*bwd, num_layers)
    before = cd.dcgru_dec_bwd_loop.launches
    got = cd.dcgru_dec_bwd_loop(*loop_args)
    torch.cuda.synchronize()
    assert cd.dcgru_dec_bwd_loop.launches == before + 1
    want = cd.dcgru_dec_bwd_loop_plain(*loop_args)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert _err(g, w) <= tol, (i, _err(g, w))
    _, _, dpre, dproj = want
    cells = dw_cells(dpre)
    assert len(cells) == min(num_layers, 2)
    for cell in cells:
        part = cr.dcgru_xin_dw(*cell)
        torch.cuda.synchronize()
        want = cr.dcgru_xin_dw_plain(*cell)
        assert _err(cr.dcgru_dw_reduce(part), want.sum(0)) <= tol
    before = cd.dcgru_dec_dwp.launches
    part = cd.dcgru_dec_dwp(h_top, dproj)
    torch.cuda.synchronize()
    assert cd.dcgru_dec_dwp.launches == before + 1
    want = cd.dcgru_dec_dwp_plain(h_top, dproj)
    assert part.shape == want.shape == (cd.dwp_splits(t * b * N),
                                        h * d + d)
    assert _err(part, want) <= 1e-4  # f32 FMA on f32 dproj in either dtype
    runs = [cd.dcgru_decoder_bwd(*bwd, num_layers) for _ in range(2)]
    for g, w in zip(*runs):
        assert (g is None and w is None) or torch.equal(g, w)


def test_decoder_wrappers_raise_on_what_the_kernel_does_not_take(dev):
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd

    args = list(_dec_inputs(dev, t=4, b=3, d=12, h=16, num_layers=2,
                            num_supports=1, shared=False,
                            stream=torch.float32, force="mixed"))
    bad = lambda i, v: [v if j == i else a for j, a in enumerate(args)]
    with pytest.raises(ValueError, match="contiguous"):
        cd.dcgru_decoder_fwd(*bad(1, args[1].transpose(0, 1).contiguous()
                                  .transpose(0, 1)), 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        cd.dcgru_decoder_fwd(*bad(1, args[1].half()), 2)
    with pytest.raises(TypeError, match="must be float32"):
        cd.dcgru_decoder_fwd(*bad(15, args[15].double()), 2)
    with pytest.raises(ValueError, match="force"):
        cd.dcgru_decoder_fwd(*bad(2, args[2][:3].contiguous()), 2)
    with pytest.raises(ValueError, match="shared weight"):
        cd.dcgru_decoder_fwd(*bad(9, args[3]), 2)
    bwd = list(_dec_bwd_args(args, 2))
    with pytest.raises(TypeError, match="streams mix"):
        cd.dcgru_decoder_bwd(*bwd[:15], bwd[15].bfloat16(), bwd[16], 2)


def _dec_loop_inputs(dev, *, t, b, n, d, h, num_layers, num_supports,
                     stream, activation="tanh", seed=0, w_scale=None):
    """The decoder loops' arguments at n nodes, per-clip graphs, force
    alternating from 1: the forward's, and the backward loop's on the
    plain forward's residuals and a seeded proj cotangent. Cell weights of
    std ``w_scale`` (default xavier-scaled)."""
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd

    rng = np.random.RandomState(seed)
    m = num_supports * K + 1
    f = lambda *s, scale: torch.from_numpy(
        (rng.randn(*s) * scale).astype(np.float32)).to(dev)
    sup = torch.from_numpy((np.abs(rng.randn(num_supports, b, n, n)) / n)
                           .astype(np.float32))
    a_ops = chebyshev_operators(sup, K).contiguous().to(dev)

    def cell(d_in):
        sx = w_scale or (2.0 / (m * (d_in + h))) ** 0.5
        sh = w_scale or (2.0 / (m * 2 * h)) ** 0.5
        return [f(m * d_in, 2 * h, scale=sx), f(m * d_in, h, scale=sx),
                f(m * h, 2 * h, scale=sh), f(m * h, h, scale=sh),
                f(2 * h, scale=0.1), f(h, scale=0.1)]

    w = cell(d) + (cell(h) if num_layers > 1 else [None] * 6)
    w += [f(h, d, scale=h ** -0.5), f(d, scale=0.1)]
    h0 = f(num_layers, b, n, h, scale=0.1)
    force = torch.tensor([float((i + 1) % 2) for i in range(t)], device=dev)
    fwd = (a_ops, f(t, b, n, d, scale=1.0).to(stream), force, *w, h0,
           num_layers, activation)
    _, _, h_seq, ru, c = cd.dcgru_decoder_fwd_plain(*fwd, residuals=True)
    loop = (a_ops, *w[0:4], *w[6:10], w[12], cd.decoder_h_prev(h0, h_seq),
            ru, c, f(t, b, n, d, scale=1.0).to(stream), force, num_layers,
            activation)
    return fwd, loop


def _wbytes(r, k, bf16):
    """chain_wbytes of csrc/dcgru_common.cuh: 512 bytes a tile."""
    return -(-r // 16) * -(-k // (16 if bf16 else 8)) * 512


def _dec_plan_branch(fwd, n, d, h, m, num_layers, bf16):
    """Which of its plans a decoder loop takes here: the whole tied cell
    in shared memory ("tied"), a part of it ("part"), or every weight
    from L2 ("L2")."""
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd

    plan = cd.decoder_plan(fwd, n, d, h, m, num_layers, bf16)
    mh = m * h
    tied = (_wbytes(2 * h, 2 * mh, bf16) + _wbytes(h, 2 * mh, bf16) if fwd
            else _wbytes(mh, 2 * h, bf16) + _wbytes(mh, 3 * h, bf16)
            + _wbytes(mh, h, bf16))
    if plan["in_smem"] == 0:
        return "L2"
    return "tied" if plan["in_smem"] == tied else "part"


# (N, H, D) of the decoder loops' cases: ragged nodes, H and D (7, 12, 8);
# the SSL model's widths at N=19 and 32; narrow at N=32
DEC_LOOP_SHAPES = [(7, 12, 8), (19, 64, 100), (32, 64, 100), (32, 16, 20)]


@pytest.mark.parametrize("n,h,d", DEC_LOOP_SHAPES)
@pytest.mark.parametrize("num_layers", [1, 2, 3])
@pytest.mark.parametrize("num_supports", [1, 2])
@pytest.mark.parametrize("bf16", [False, True])
def test_decoder_tensor_core_loops_match_plain(dev, n, h, d, num_layers,
                                               num_supports, bf16,
                                               record_property):
    """The decoder's two state loops (#5 dcgru_decoder_fwd with every
    residual, 6.l dcgru_dec_bwd_loop) against their plain versions: N=7,
    19 and 32, L=1..3, M=3 and 5, each activation; the launch plan each
    case takes is recorded."""
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd

    stream = torch.bfloat16 if bf16 else torch.float32
    tol = 2e-2 if bf16 else 1e-4
    activation = ("tanh", "relu", "linear")[(n + num_layers) % 3]
    m = num_supports * K + 1
    fwd, loop = _dec_loop_inputs(
        dev, t=3, b=3, n=n, d=d, h=h, num_layers=num_layers,
        num_supports=num_supports, stream=stream, activation=activation,
        seed=n * h + num_layers)
    record_property("plans", [_dec_plan_branch(f, n, d, h, m, num_layers,
                                               bf16) for f in (True, False)])
    for kern, plain, args, kw in (
            (cd.dcgru_decoder_fwd, cd.dcgru_decoder_fwd_plain, fwd,
             dict(residuals=True)),
            (cd.dcgru_dec_bwd_loop, cd.dcgru_dec_bwd_loop_plain, loop, {})):
        before = kern.launches
        got = kern(*args, **kw)
        torch.cuda.synchronize()
        assert kern.launches == before + 1, kern.__name__
        for i, (g, w) in enumerate(zip(got, plain(*args, **kw))):
            assert g.dtype == w.dtype and g.shape == w.shape, \
                (kern.__name__, i)
            assert torch.isfinite(g.float()).all(), (kern.__name__, i)
            assert _err(g, w) <= tol, (kern.__name__, i, _err(g, w))


@pytest.mark.parametrize("num_layers", [1, 3])
def test_decoder_tensor_core_loops_are_bitwise_deterministic(dev,
                                                             num_layers):
    """Two runs of each decoder loop on the same inputs give the same bits
    (fixed tiles summed in a fixed order), bf16 and f32, at the SSL
    model's widths."""
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd

    for stream in (torch.float32, torch.bfloat16):
        fwd, loop = _dec_loop_inputs(dev, t=12, b=37, n=N, d=100, h=64,
                                     num_layers=num_layers, num_supports=1,
                                     stream=stream)
        for kern, args, kw in ((cd.dcgru_decoder_fwd, fwd,
                                dict(residuals=True)),
                               (cd.dcgru_dec_bwd_loop, loop, {})):
            runs = [kern(*args, **kw) for _ in range(2)]
            for g, w in zip(*runs):
                assert torch.equal(g, w), kern.__name__


@pytest.mark.parametrize("num_layers", [1, 3])
@pytest.mark.parametrize("bf16", [False, True])
def test_decoder_tensor_core_loops_keep_a_device_nan(dev, num_layers, bf16):
    """A NaN that a device op made reaches the entries it reaches in the
    plain loops: in one entry of h0 (the top layer's) and in one entry of
    the force-fed input (x_seq at a forced step), through the forward's
    proj and every residual; and in the backward loop, fed finite
    residuals, in that h0 entry as h_prev at step 0 and in one entry of
    the proj cotangent at a forced step, through dx, dh0, dpre and
    dproj."""
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd

    stream = torch.bfloat16 if bf16 else torch.float32
    fwd, loop = _dec_loop_inputs(dev, t=4, b=3, n=N, d=100, h=64,
                                 num_layers=num_layers, num_supports=1,
                                 stream=stream)
    nan = (torch.zeros(1, device=dev) / 0)[0]
    force = fwd[2]
    step = int(torch.nonzero(force)[0])  # a forced step
    h0 = fwd[17].clone()
    h0[num_layers - 1, 1, 4, 5] = nan
    x = fwd[1].clone()
    x[step, 2, 7, 30] = nan
    for args in ((*fwd[:17], h0, *fwd[18:]),
                 (fwd[0], x, *fwd[2:])):
        got = cd.dcgru_decoder_fwd(*args, residuals=True)
        want = cd.dcgru_decoder_fwd_plain(*args, residuals=True)
        assert any(w.isnan().any() for w in want)
        for g, w in zip(got, want):
            assert torch.equal(g.isnan(), w.isnan())
    h_prev = loop[10].clone()
    h_prev[num_layers - 1, 0, 1, 4, 5] = nan
    d_seq = loop[13].clone()
    d_seq[step, 2, 7, 30] = nan
    for args in ((*loop[:10], h_prev, *loop[11:]),
                 (*loop[:13], d_seq, *loop[14:])):
        got = cd.dcgru_dec_bwd_loop(*args)
        want = cd.dcgru_dec_bwd_loop_plain(*args)
        assert any(w.isnan().any() for w in want)
        for g, w in zip(got, want):
            assert torch.equal(g.isnan(), w.isnan())


def test_decoder_loop_plans_take_every_branch(dev, record_property):
    """Over the cases above, each loop takes each of its plans: the whole
    tied cell in shared memory, a part of it, every weight from L2."""
    seen = {True: {}, False: {}}
    for n, h, d in DEC_LOOP_SHAPES:
        for num_layers in (1, 2, 3):
            for m in (3, 5):
                for bf16 in (False, True):
                    for fwd in (True, False):
                        branch = _dec_plan_branch(fwd, n, d, h, m,
                                                  num_layers, bf16)
                        seen[fwd].setdefault(branch, (n, h, d, m,
                                                      num_layers, bf16))
    record_property("first_case_of_each_plan", {
        ("fwd" if k else "bwd"): v for k, v in seen.items()})
    for fwd in (True, False):
        assert set(seen[fwd]) == {"tied", "part", "L2"}, seen


# the decoder loops against their emulated rounding: the 99th percentile
# of the elements' errors past rounding, over two layer-steps. A bf16
# operand that the kernel's diffusions (summed in another f32 order) round
# the other way moves a few outputs by up to ~2e-3, an error the largest
# reads and the percentile mostly leaves alone, while f32 products move
# every element. The bar sits between the two: the kernels read up to
# 2.3e-4 (a flip in layer 0 that the tied layer's diffusion spreads
# before the projection), the plain loops at least 1.7e-3 on their
# farthest output (PERF.md, section 6). Over more layer-steps the flips
# spread further: at L=3, T_out=2 the kernels read up to 6.1e-4 and the
# plain loops 1.2e-3-8.3e-3, and no bar tells the two apart everywhere
DEC_ROUNDING_Q, DEC_ROUNDING_TOL = 0.99, 5e-4


@pytest.mark.parametrize("activation", ["tanh", "relu", "linear"])
@pytest.mark.parametrize("num_layers,t", [(1, 2), (2, 1)])
def test_bf16_decoder_loops_compute_their_operand_rounding(
        dev, activation, num_layers, t, record_property):
    """The bf16 decoder loops compute the stated rounding (bf16 product
    operands, f32 sums; tests/chain_emulation.py) over two layer-steps:
    layer 0 over T_out=2, and layer 0 and the tied cell over one step; at
    the SSL model's widths, M=5, cell weights of std 0.2 so that the
    operand rounding shows. The forward's bf16 outputs are held to the
    emulation's f32 values past their own rounding, the backward loop's
    f32 outputs (and its bf16 dx past its rounding) as they are, by the
    99th percentile of the elements' errors; the plain loops (f32
    products) must read above the bar on some output. The largest errors
    are recorded beside."""
    from chain_emulation import dec_chain_bwd, dec_chain_fwd
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd

    fwd, loop = _dec_loop_inputs(
        dev, t=t, b=3, n=N, d=100, h=64, num_layers=num_layers,
        num_supports=2, stream=torch.bfloat16, activation=activation,
        seed=197, w_scale=0.2)
    pairs = {}
    want = dec_chain_fwd(*fwd, torch.float32)
    for i, (g, w, p) in enumerate(zip(
            cd.dcgru_decoder_fwd(*fwd, residuals=True), want,
            cd.dcgru_decoder_fwd_plain(*fwd, residuals=True))):
        pairs[f"fwd{i}"] = (g, p, w)
    want = dec_chain_bwd(*loop, torch.float32)
    for i, (g, w, p) in enumerate(zip(cd.dcgru_dec_bwd_loop(*loop), want,
                                      cd.dcgru_dec_bwd_loop_plain(*loop))):
        pairs[f"bwd{i}"] = (g, p, w)
    quant = lambda e: torch.quantile(e.flatten(), DEC_ROUNDING_Q).item()
    errs = {k: tuple(f(_past_rounding(v, w)) for v in (g, p)
                     for f in (quant, lambda e: e.max().item()))
            for k, (g, p, w) in pairs.items()}
    # (kernel q99, kernel max, plain q99, plain max) against the emulation
    record_property("kernel_and_plain_vs_emulation", errs)
    for k, (kern, _, _, _) in errs.items():
        assert kern <= DEC_ROUNDING_TOL, (k, errs)
    assert max(p for _, _, p, _ in errs.values()) > DEC_ROUNDING_TOL, errs


def test_ssl_train_step_matches_stacked(dev):
    """One SSL pre-training step at the slice's width (3 layers x 64,
    D=100, T_in=60, T_out=12, combined graph, f32, B=32, curriculum on at
    a ratio near 0.5): launches per step, and the kernels' gradients
    against the stacked step's from the same weights and force draws."""
    from eeg_gnn_tpu_torch.config import ExperimentConfig
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd
    from eeg_gnn_tpu_torch.train import TrainStep

    rng = np.random.RandomState(0)
    adj = np.abs(rng.rand(32, N, N)).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    batch = {"x": rng.randn(32, 60, N, 100).astype(np.float32),
             "y": rng.randn(32, 12, N, 100).astype(np.float32),
             "adjacency": adj}
    cfg = ExperimentConfig(task="SS pre-training", graph_type="combined",
                           num_rnn_layers=3, use_curriculum_learning=True,
                           lr_init=5e-4).finalize()
    counters = (cr.dcgru_xin_proj, cr.dcgru_xin_fwd_loop,
                cr.dcgru_xin_bwd_loop, cr.dcgru_xin_dw, cr.dcgru_xin_dx,
                cd.dcgru_decoder_fwd, cd.dcgru_dec_bwd_loop,
                cd.dcgru_dec_dwp, cr.dcgru_dw_reduce)
    grads = {}
    for rec in ("pallas", "stacked"):
        c = dataclasses.replace(cfg, recurrence=rec)
        step = TrainStep(c, build_model(c, torch.Generator().manual_seed(0)),
                         100, device=dev,
                         generator=torch.Generator(dev).manual_seed(7))
        before = [k.launches for k in counters]
        loss = step.loss_and_grads(batch, batches_seen=24000)
        rose = [k.launches - b_ for k, b_ in zip(counters, before)]
        # the encoder's 3 layers; the decoder's forward, its loop, two dW
        # products (layer 0, the tied cell), dWp, and 3 + 3 reductions
        assert rose == ([3, 3, 3, 5, 2, 1, 1, 1, 6] if rec == "pallas"
                        else [0] * 9)
        assert torch.isfinite(loss)
        grads[rec] = {n: p.grad.clone()
                      for n, p in step.model.named_parameters()}
    for name, g in grads["pallas"].items():
        assert _err(g, grads["stacked"][name]) <= 1e-4, name


# ---------------------------------------------------------------------------
# the fused diffusion conv (csrc/fused_diffusion_conv.cu) and the
# block-sparse SDDMM (csrc/sddmm.cu)
# ---------------------------------------------------------------------------


def _conv_args(dev, s, k, d, o, b, seed=0):
    from eeg_gnn_tpu_torch.ops import cuda_kernels as ck

    rng = np.random.RandomState(seed)
    m = s * k + 1
    f = lambda *shape, scale: torch.from_numpy(
        (rng.randn(*shape) * scale).astype(np.float32)).to(dev)
    w = ck.rearrange_weight(f(d * m, o, scale=(2.0 / (d * m)) ** 0.5), d,
                            m).contiguous()
    return (f(s, b, N, N, scale=0.3), f(b, N, d, scale=1.0), w,
            f(o, scale=0.1), k)


@pytest.mark.parametrize("s,k,d,o,b", [(1, 2, 12, 8, 3), (1, 2, 64, 128, 128),
                                       (2, 2, 64, 64, 37), (2, 3, 20, 24, 4)])
def test_fused_diffusion_conv_matches_plain(dev, s, k, d, o, b):
    """Kernel #7 against its plain version: the gate (O=128) and candidate
    (O=64) shapes of the use_pallas loop, the carry-over at M=5 and K=3."""
    from eeg_gnn_tpu_torch.ops import cuda_kernels as ck

    args = _conv_args(dev, s, k, d, o, b)
    before = ck.fused_diffusion_conv_fwd.launches
    got = ck.fused_diffusion_conv_fwd(*args)
    torch.cuda.synchronize()
    assert ck.fused_diffusion_conv_fwd.launches == before + 1
    want = ck.fused_diffusion_conv_plain(*args)
    assert got.shape == want.shape == (b, N, o)
    assert _err(got, want) <= 1e-4


def test_fused_diffusion_conv_function_gradients(dev):
    """The autograd Function's dx, dW (M, D, O) and db against autograd of
    the plain version, on the card."""
    from eeg_gnn_tpu_torch.ops import cuda_kernels as ck

    sup, x, w, bias, k = _conv_args(dev, 2, 2, 64, 128, 37)
    cot = torch.randn(37, N, 128, device=dev,
                      generator=torch.Generator(dev).manual_seed(0))
    grads = []
    for fn in (ck.fused_diffusion_conv, ck.fused_diffusion_conv_plain):
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        (fn(sup, *leaves, k) * cot).sum().backward()
        grads.append([t.grad for t in leaves])
    for g, want in zip(*grads):
        assert g.shape == want.shape and _err(g, want) <= 1e-4


def test_fused_diffusion_conv_wrapper_raises(dev):
    from eeg_gnn_tpu_torch.ops import cuda_kernels as ck

    sup, x, w, bias, k = _conv_args(dev, 1, 2, 12, 8, 3)
    with pytest.raises(TypeError, match="float32"):
        ck.fused_diffusion_conv_fwd(sup, x.double(), w, bias, k)
    with pytest.raises(ValueError, match="takes supports"):
        ck.fused_diffusion_conv_fwd(sup[0], x, w, bias, k)
    with pytest.raises(ValueError, match="M = S\\*K"):
        ck.fused_diffusion_conv_fwd(sup, x, w, bias, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ck.fused_diffusion_conv_fwd(sup, x.transpose(0, 1).contiguous()
                                    .transpose(0, 1), w, bias, k)
    with pytest.raises(ValueError, match="nodes"):
        big = torch.zeros(1, 3, 40, 40, device=dev)
        ck.fused_diffusion_conv_fwd(big, torch.zeros(3, 40, 12, device=dev),
                                    w, bias, k)


def _tc_conv_args(dev, s, k, n, o, b, seed=0, d=64):
    """Kernel #7's arguments at n nodes as the use_pallas loop hands them
    over (D = H = 64): per-clip supports, a state in (-1, 1), a weight
    re-laid (M, D, O), a bias."""
    rng = np.random.RandomState(seed)
    m = s * k + 1
    f = lambda *shape, scale: torch.from_numpy(
        (rng.randn(*shape) * scale).astype(np.float32)).to(dev)
    sup = torch.from_numpy((np.abs(rng.randn(s, b, n, n)) / n).astype(
        np.float32)).to(dev)
    return (sup, torch.tanh(f(b, n, d, scale=1.0)),
            f(m, d, o, scale=(2.0 / (d * m)) ** 0.5), f(o, scale=0.1), k)


@pytest.mark.parametrize("n", [7, 19, 32])
@pytest.mark.parametrize("s,k", [(1, 1), (1, 2), (1, 3), (2, 2), (2, 3)])
@pytest.mark.parametrize("o", [64, 128])
@pytest.mark.parametrize("b", [1, 37, 128])
def test_tensor_core_conv_matches_plain(dev, n, s, k, o, b):
    """Kernel #7 on tensor cores against its plain version, its operands
    staged once (as the loop passes them) and staged by the wrapper: N=7,
    19 and 32, S=1 and 2, K=1..3 (the carry-over), the gate's and the
    candidate's O, B=1, 37 and 128."""
    from eeg_gnn_tpu_torch.ops import cuda_kernels as ck

    args = _tc_conv_args(dev, s, k, n, o, b, seed=n * s + k + o + b)
    sup_f, (w_f,) = ck.stage_fdc_operands(args[0], args[2])
    before = ck.fused_diffusion_conv_fwd.launches
    got = ck.fused_diffusion_conv_fwd(*args, (sup_f, w_f))
    bare = ck.fused_diffusion_conv_fwd(*args)
    torch.cuda.synchronize()
    assert ck.fused_diffusion_conv_fwd.launches == before + 2
    want = ck.fused_diffusion_conv_plain(*args)
    assert got.shape == want.shape == (b, n, o)
    assert torch.isfinite(got).all()
    assert _err(got, want) <= 1e-4, _err(got, want)
    assert torch.equal(got, bare)


@pytest.mark.parametrize("where", ["x", "w", "bias", "support"])
def test_tensor_core_conv_keeps_a_device_nan(dev, where):
    """A NaN that a device op made, in one entry of x, the weight, the bias
    or a support, reaches exactly the output entries it reaches in the
    plain version."""
    from eeg_gnn_tpu_torch.ops import cuda_kernels as ck

    args = list(_tc_conv_args(dev, 2, 2, N, 128, 5))
    nan = (torch.zeros(1, device=dev) / 0)[0]
    i, at = {"x": (1, (2, 4, 7)), "w": (2, (3, 9, 70)), "bias": (3, (33,)),
             "support": (0, (1, 3, 4, 6))}[where]
    v = args[i].clone()
    v[at] = nan
    args[i] = v
    got = ck.fused_diffusion_conv_fwd(*args)
    want = ck.fused_diffusion_conv_plain(*args)
    assert want.isnan().any() and not want.isnan().all()
    assert torch.equal(got.isnan(), want.isnan())


def test_tensor_core_conv_is_bitwise_deterministic(dev):
    """Runs on the same inputs give the same bits: twenty launches on
    operands staged once, and launches that stage them anew each time
    (fixed tiles, partials added in a fixed order, no atomics)."""
    from eeg_gnn_tpu_torch.ops import cuda_kernels as ck

    for s, o in ((1, 128), (2, 64)):
        args = _tc_conv_args(dev, s, 2, N, o, 128)
        sup_f, (w_f,) = ck.stage_fdc_operands(args[0], args[2])
        runs = [ck.fused_diffusion_conv_fwd(*args, (sup_f, w_f))
                for _ in range(20)]
        runs += [ck.fused_diffusion_conv_fwd(*args) for _ in range(3)]
        for r in runs[1:]:
            assert torch.equal(r, runs[0])


def test_tensor_core_conv_rejects_mismatched_staging(dev):
    from eeg_gnn_tpu_torch.ops import cuda_kernels as ck

    args = _tc_conv_args(dev, 1, 2, N, 128, 4)
    sup_f, (w_f,) = ck.stage_fdc_operands(args[0], args[2])
    with pytest.raises(ValueError, match="staged operands"):
        ck.fused_diffusion_conv_fwd(*args, (sup_f[:2].contiguous(), w_f))
    with pytest.raises(ValueError, match="staged operands"):
        ck.fused_diffusion_conv_fwd(*args, (sup_f, w_f[:4].contiguous()))


def _banded(n, half=32):
    rows = np.repeat(np.arange(n), 2 * half)
    offs = np.concatenate([np.arange(-half, 0), np.arange(1, half + 1)])
    return rows, (rows.reshape(n, 2 * half) + offs).reshape(-1) % n


@pytest.mark.parametrize("n,d,banded", [(19, 60, False), (300, 77, False),
                                        (150, 77, False), (150, 6000, False),
                                        (1024, 6000, False),
                                        (4096, 6000, True)])
def test_sddmm_blocksparse_matches_plain(dev, n, d, banded):
    """Kernel #8 (3xTF32 tensor cores) against its plain version (full
    f32, TF32 off): every occupied block, zero rows and columns past N
    included, ragged N (19, 150, 300) and D (60, 77: not a multiple of 4,
    copied one float at a time); 4096 banded +-32 gives 96 occupied
    blocks. Twice on the same inputs, bitwise equal."""
    from eeg_gnn_tpu_torch.ops import sddmm as sd

    rng = np.random.RandomState(n)
    x = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(dev)
    if banded:
        rows, cols = _banded(n)
    else:
        rows = np.repeat(np.arange(n), 3)
        cols = rng.randint(0, n, size=3 * n)
    br, bc, _, _ = sd.edges_to_blocks(rows, cols, n)
    if banded:
        assert len(br) == 96
    before = sd.sddmm_blocksparse.launches
    got = sd.sddmm_blocksparse(x, y, br, bc)
    torch.cuda.synchronize()
    assert sd.sddmm_blocksparse.launches == before + 1
    want = sd.sddmm_blocksparse_plain(x, y, br, bc)
    assert got.shape == want.shape == (len(br), 128, 128)
    assert _err(got, want) <= SDDMM_TOL
    assert torch.equal(sd.sddmm_blocksparse(x, y, br, bc), got)
    vals = sd.sddmm_edges_blocksparse(rows, cols, x, x, n, normalize=True)
    ref = sd.sddmm_edges(rows, cols, x, x, normalize=True)
    assert _err(vals, ref) <= 1e-4


@pytest.mark.parametrize("d", [77, 600])
def test_sddmm_tile_choice_leaves_every_bit(dev, d):
    """With at least one occupied block per SM the kernel takes 128-wide
    tiles, with fewer the 64-wide quarters (and with block=64 only those):
    each output's sum runs the same instructions in the same order either
    way, so a few of the blocks, or their 64-wide quarters, give the bits
    of the whole set."""
    from eeg_gnn_tpu_torch.ops import sddmm as sd

    n, nb = 2048, 16
    rng = np.random.RandomState(d)
    x = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(dev)
    br, bc = (v.reshape(-1).astype(np.int32) for v in
              np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij"))
    assert nb * nb >= torch.cuda.get_device_properties(
        dev).multi_processor_count
    full = sd.sddmm_blocksparse(x, y, br, bc)
    assert _err(full, sd.sddmm_blocksparse_plain(x, y, br, bc)) <= SDDMM_TOL
    few = sd.sddmm_blocksparse(x, y, br[:20], bc[:20])
    assert torch.equal(few, full[:20])
    # 64-blocks (0, 2) and (3, 1) are quarters of 128-blocks (0, 1), (1, 0)
    quarters = sd.sddmm_blocksparse(x, y, [0, 3], [2, 1], block=64)
    assert torch.equal(quarters[0], full[1, :64, :64])
    assert torch.equal(quarters[1], full[nb, 64:, 64:])


def test_3xtf32_products_keep_a_device_nan(dev):
    """A NaN that a device op made (0/0 on the card: 0x7fffffff, whose
    rounding to TF32 by integer add alone would carry into the sign and
    give -0) spreads through the 3xTF32 products where it spreads through
    the plain f32 ones: in a row of the SDDMM, and in x of the f32 bulk
    input projection."""
    from eeg_gnn_tpu_torch.ops import sddmm as sd

    nan = torch.zeros(1, device=dev) / 0
    assert nan.view(torch.int32).item() == 0x7FFFFFFF
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(300, 77).astype(np.float32)).to(dev)
    x[7, 3] = nan[0]
    br, bc = [0, 1, 2, 0, 1], [0, 1, 2, 2, 0]
    got = sd.sddmm_blocksparse(x, x, br, bc)
    want = sd.sddmm_blocksparse_plain(x, x, br, bc)
    assert want.isnan().any() and not want.isnan().all()
    assert torch.equal(got.isnan(), want.isnan())
    xin, _ = _inputs(dev, t=5, b=4, d=12, h=16, num_supports=1,
                     shared=False, stream=torch.float32)
    xs, a_ops, wxg, wxc = xin[:4]
    xs = xs.clone()
    xs[2, 1, 4, 5] = nan[0]
    wx = torch.cat([wxg, wxc], dim=1)
    got = cr.dcgru_xin_proj(xs, a_ops, wx)
    want = cr.dcgru_xin_proj_plain(xs, a_ops, wx)
    assert want.isnan().any() and not want.isnan().all()
    assert torch.equal(got.isnan(), want.isnan())


def test_sddmm_wrapper_raises(dev):
    from eeg_gnn_tpu_torch.ops import sddmm as sd

    x = torch.zeros(19, 8, device=dev)
    z = np.zeros(1, np.int32)
    with pytest.raises(TypeError, match="float32"):
        sd.sddmm_blocksparse(x.double(), x.double(), z, z)
    with pytest.raises(ValueError, match="one shape"):
        sd.sddmm_blocksparse(x, x[:5], z, z)
    with pytest.raises(ValueError, match="multiple of 64"):
        sd.sddmm_blocksparse(x, x, z, z, block=96)


def test_use_pallas_predictor_launches_the_conv_kernel(dev):
    """The use_pallas detector through Predictor: 2 T L launches of kernel
    #7 per batch and none of the recurrence kernels; probabilities as the
    naive recurrence's."""
    from eeg_gnn_tpu_torch.config import ExperimentConfig
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.ops import cuda_kernels as ck
    from eeg_gnn_tpu_torch.serve import Predictor

    rng = np.random.RandomState(0)
    x = rng.randn(37, 60, N, 100).astype(np.float32)
    adj = np.abs(rng.rand(37, N, N)).astype(np.float32)
    cfg = ExperimentConfig(graph_type="individual", use_pallas=True,
                           test_batch_size=64).finalize()
    params = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    others = (cr.dcgru_xin_proj, cr.dcgru_xin_fwd_loop,
              cr.dcgru_recurrence_fwd)
    before = [ck.fused_diffusion_conv_fwd.launches] + [
        k.launches for k in others]
    probs = Predictor(cfg, params, device=dev).predict_proba(x, adjacency=adj)
    after = [ck.fused_diffusion_conv_fwd.launches] + [
        k.launches for k in others]
    assert [a - b_ for a, b_ in zip(after, before)] == [2 * 60 * 2, 0, 0, 0]
    naive = Predictor(dataclasses.replace(cfg, use_pallas=False,
                                          recurrence="naive"),
                      params, device=dev).predict_proba(x, adjacency=adj)
    assert np.abs(probs - naive).max() <= 1e-4


@pytest.mark.parametrize("task", ["detection", "SS pre-training"])
def test_run_experiment_on_the_card_matches_the_cpu(dev, tmp_path, task):
    """The training CLI's driver on a small in-memory synthetic corpus
    (4 files x 96 s, 12 s clips; 1 layer x 16 units, K=1, batches of 4 and
    8, 2 epochs, float32, TF32 off) on the card and on the CPU from the
    same weights: the train/Loss sequences and the test loss at rtol
    1e-4; the card run launches the encoder's kernels (and, for SSL, the
    decoder's)."""
    import json
    import logging

    from eeg_gnn_tpu_torch.config import ExperimentConfig
    from eeg_gnn_tpu_torch.data.datasets import (
        load_dataset_detection,
        load_dataset_ssl,
    )
    from eeg_gnn_tpu_torch.data.synthetic import make_synthetic_corpus
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd
    from eeg_gnn_tpu_torch.train.trainer import run_experiment
    from eeg_gnn_tpu_torch.utils.logging import MetricsWriter

    signals = {}
    p = make_synthetic_corpus(str(tmp_path / "corpus"), num_files=4,
                              file_seconds=96, clip_len=12, seed=0,
                              signals=signals)
    ssl = task == "SS pre-training"
    cfg = ExperimentConfig(
        task=task, graph_type="combined", max_seq_len=12, use_fft=True,
        num_rnn_layers=1, rnn_units=16, max_diffusion_step=1,
        train_batch_size=4, test_batch_size=8, num_epochs=2, do_train=True,
        metric_name="loss" if ssl else "auroc").finalize()
    common = dict(
        input_dir=p["input_dir"], raw_data_dir=p["raw_data_dir"],
        train_batch_size=4, test_batch_size=8, num_workers=1,
        adj_mat_dir=p["adj_mat_dir"], graph_type="combined",
        filter_type=cfg.filter_type, use_fft=True,
        marker_dir=p["marker_dir"], signals=signals)
    init = build_model(cfg, torch.Generator().manual_seed(3)).state_dict()
    kernels = [cr.dcgru_xin_proj, cr.dcgru_xin_fwd_loop,
               cr.dcgru_xin_bwd_loop, cr.dcgru_xin_dw]
    if ssl:
        kernels += [cd.dcgru_decoder_fwd, cd.dcgru_dec_bwd_loop]
    runs = {}
    for where in ("cpu", "cuda"):
        for k in kernels:
            k.launches = 0
        loaders, _, scaler = (
            load_dataset_ssl(input_len=12, output_len=12, **common) if ssl
            else load_dataset_detection(max_seq_len=12, **common))
        out = str(tmp_path / where)
        os.makedirs(out)
        log = logging.getLogger("test_run_experiment_on_the_card")
        res = run_experiment(cfg, loaders, scaler, out, log,
                             MetricsWriter(out), init_params=init,
                             device=where)
        with open(os.path.join(out, "metrics.jsonl")) as f:
            losses = [r["value"] for r in map(json.loads, f)
                      if r["tag"] == "train/Loss"]
        runs[where] = (res, losses, [k.launches for k in kernels])
    (res_c, loss_c, n_c), (res_g, loss_g, n_g) = runs["cpu"], runs["cuda"]
    assert n_c == [0] * len(kernels) and min(n_g) > 0, n_g
    assert len(loss_g) == len(loss_c) > 0
    np.testing.assert_allclose(loss_g, loss_c, rtol=1e-4)
    np.testing.assert_allclose(res_g["loss"], res_c["loss"], rtol=1e-4)


# ---------------------------------------------------------------------------
# the on-device input path: pipeline, caches, rotating prefetch
# ---------------------------------------------------------------------------


def _dist_pkl(tmp_path):
    import pickle

    rng = np.random.RandomState(3)
    adj = np.abs(rng.rand(N, N)).astype(np.float32)
    adj = (adj + adj.T) / 2
    np.fill_diagonal(adj, 1.0)
    path = str(tmp_path / "adj.pkl")
    with open(path, "wb") as f:
        pickle.dump([["c"] * N, {}, adj], f)
    return path


def _eeg_like(rng, b, points):
    """Raw clips with structure across channels (mixtures of six sources
    of different spectra, as chip_smoke.eeg_like): white noise leaves the
    top-3 correlation graph at near ties that rounding reorders."""
    out = np.empty((b, N, points), np.float32)
    for i in range(b):
        src = rng.randn(6, points)
        for k in range(6):
            src[k] = np.convolve(src[k], np.ones(2 ** k) / 2 ** (k / 2),
                                 "same")
        out[i] = (rng.gamma(0.5, 1.0, size=(N, 6)) @ src
                  + 0.1 * rng.randn(N, points)) * 20
    return out


@pytest.mark.parametrize("graph_type", ["individual", "combined"])
def test_device_pipeline_on_the_card_matches_the_cpu(dev, tmp_path,
                                                     graph_type):
    """featurize_clip, DevicePipeline.features and ssl_features (augment
    off and on, the same draws fed to both) and the raw call, on the card
    against the CPU: float32 <= 1e-4 normalized; bf16 storage: x <= 2e-2,
    and its supports (features and ssl_features) <= 1e-4 against the CPU's
    float32 pipeline on the same features rounded to bf16 (the graph is
    built from their float32 upcast; the combined graph's shared supports
    exactly). Features each side
    makes from raw clips are held as amplitudes exp(log|FFT|): the log of
    a tiny bin (a zero-mean window's DC) carries the float32 FFT's
    absolute error over that amplitude on both sides."""
    from eeg_gnn_tpu_torch.data.device_pipeline import make_device_pipeline
    from eeg_gnn_tpu_torch.data.scaler import StandardScaler
    from eeg_gnn_tpu_torch.ops.fft_features import featurize_clip

    rng = np.random.RandomState(0)
    b, t = 16, 30
    raw = torch.from_numpy(_eeg_like(rng, b, t * 200))
    raw_y = torch.from_numpy(_eeg_like(rng, b, 2 * 200))
    kw = dict(graph_type=graph_type, top_k=3, use_fft=True,
              time_step_size=1, adj_mat_dir=_dist_pkl(tmp_path),
              filter_type=("laplacian" if graph_type == "combined"
                           else "dual_random_walk"),
              scaler=StandardScaler(0.3, 2.0))
    draws = (torch.arange(b) % 3 == 0,
             torch.from_numpy(rng.uniform(0.8, 1.2, b).astype(np.float32)))
    card_draws = tuple(d.to(dev) for d in draws)
    assert _err(featurize_clip(raw.to(dev), 1).cpu().exp(),
                featurize_clip(raw, 1).exp()) <= 1e-4
    amp = lambda x: (x.float() * 2.0 + 0.3).exp()  # undo the scaler
    # the raw call's supports on the clips whose top-3 graphs agree: the
    # two sides' FFT roundings may reorder a near tie (at most one clip)
    keep = torch.arange(b)
    if graph_type == "individual":
        from eeg_gnn_tpu_torch.graphs.xcorr import (
            correlation_adjacency_torch,
        )

        same = [(correlation_adjacency_torch(f, 3).cpu() > 0)
                for f in (featurize_clip(raw.to(dev), 1),
                          featurize_clip(raw, 1))]
        keep = torch.nonzero((same[0] == same[1]).flatten(1).all(dim=1))[:, 0]
        assert len(keep) >= b - 1
    for augment in (False, True):
        cpu = make_device_pipeline(augment=augment, device="cpu", **kw)
        card = make_device_pipeline(augment=augment, device=dev, **kw)
        feats = featurize_clip(raw, 1)
        fy = featurize_clip(raw_y, 1)
        rounded = feats.bfloat16().float()
        pairs = [
            (card.features(feats.to(dev), training=True, draws=card_draws),
             cpu.features(feats, training=True, draws=draws), 1e-4),
            (card.ssl_features(feats.to(dev), fy.to(dev), training=True,
                               draws=card_draws),
             cpu.ssl_features(feats, fy, training=True, draws=draws), 1e-4),
            (card.features(feats.to(dev).bfloat16(), training=True,
                           draws=card_draws)[:1],
             cpu.features(feats, training=True, draws=draws)[:1], 2e-2),
            ((card.features(feats.to(dev).bfloat16(), training=True,
                            draws=card_draws)[1],
              card.ssl_features(feats.to(dev).bfloat16(),
                                fy.to(dev).bfloat16(), training=True,
                                draws=card_draws)[2]),
             (cpu.features(rounded, training=True, draws=draws)[1],
              cpu.ssl_features(rounded, fy.bfloat16().float(),
                               training=True, draws=draws)[2]),
             1e-4 if graph_type == "individual" else 0.0),
            ((amp(card(raw.to(dev))[0]), card(raw.to(dev))[1][:, keep]),
             (amp(cpu(raw)[0]), cpu(raw)[1][:, keep]), 1e-4)]
        for got, want, tol in pairs:
            for g, w in zip(got, want):
                assert g.is_cuda and g.shape == w.shape
                assert _err(g.cpu(), w) <= tol, (augment, tol)
        reflect, scale = card.draw(b, torch.Generator(dev).manual_seed(0))
        assert reflect.is_cuda and reflect.dtype == torch.bool
        assert 0.8 <= float(scale.min()) and float(scale.max()) < 1.2


def _cache_setup(tmp_path, task, **flags):
    from eeg_gnn_tpu_torch.config import ExperimentConfig
    from eeg_gnn_tpu_torch.data.datasets import (
        load_dataset_detection,
        load_dataset_ssl,
    )
    from eeg_gnn_tpu_torch.data.synthetic import make_synthetic_corpus

    signals = {}
    p = make_synthetic_corpus(str(tmp_path / "corpus"), num_files=4,
                              file_seconds=96, clip_len=12, seed=0,
                              signals=signals)
    ssl = task == "SS pre-training"
    cfg = ExperimentConfig(
        task=task, graph_type="combined", max_seq_len=12, use_fft=True,
        num_rnn_layers=1, rnn_units=16, max_diffusion_step=1,
        output_seq_len=12, train_batch_size=4, test_batch_size=8,
        num_epochs=2, do_train=True, num_workers=1,
        metric_name="loss" if ssl else "auroc", input_dir=p["input_dir"],
        raw_data_dir=p["raw_data_dir"], **flags).finalize()
    common = dict(
        input_dir=p["input_dir"], raw_data_dir=p["raw_data_dir"],
        train_batch_size=4, test_batch_size=8, num_workers=1,
        adj_mat_dir=p["adj_mat_dir"], graph_type="combined",
        filter_type=cfg.filter_type, use_fft=True,
        marker_dir=p["marker_dir"], signals=signals)
    load = (lambda: load_dataset_ssl(input_len=12, output_len=12, **common)
            ) if ssl else (lambda: load_dataset_detection(max_seq_len=12,
                                                         **common))
    return cfg, p, signals, load


@pytest.mark.parametrize("task", ["detection", "SS pre-training"])
def test_cached_epochs_launch_the_kernels(dev, tmp_path, task):
    """``--hbm_cache`` through the CLI's input path and ``run_experiment``
    on the card and on the CPU from the same weights: the cached epochs
    (resident; ``fused_steps=2`` accepted and ignored) launch the
    encoder's kernels (and the
    decoder's for SSL); losses and the test loss agree at rtol 1e-4."""
    import json
    import logging

    from eeg_gnn_tpu_torch.cli.train import input_path
    from eeg_gnn_tpu_torch.data.device_cache import DeviceDatasetCache
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.ops import cuda_decoder as cd
    from eeg_gnn_tpu_torch.train.trainer import run_experiment
    from eeg_gnn_tpu_torch.utils.logging import MetricsWriter

    cfg, p, signals, load = _cache_setup(tmp_path, task, hbm_cache=True,
                                         fused_steps=2)
    init = build_model(cfg, torch.Generator().manual_seed(3)).state_dict()
    kernels = [cr.dcgru_xin_proj, cr.dcgru_xin_fwd_loop,
               cr.dcgru_xin_bwd_loop, cr.dcgru_xin_dw]
    if task == "SS pre-training":
        kernels += [cd.dcgru_decoder_fwd, cd.dcgru_dec_bwd_loop]
    runs = {}
    for where in ("cpu", "cuda"):
        loaders, _, scaler = load()
        pipe, caches = input_path(cfg, scaler, adj_mat_dir=p["adj_mat_dir"],
                                  marker_dir=p["marker_dir"],
                                  signals=signals, device=where)
        assert all(isinstance(c, DeviceDatasetCache)
                   and c.x.device.type == where for c in caches.values())
        for k in kernels:
            k.launches = 0
        out = str(tmp_path / where)
        os.makedirs(out)
        res = run_experiment(cfg, loaders, scaler, out,
                             logging.getLogger("cached_epochs"),
                             MetricsWriter(out), init_params=init,
                             device=where, input_pipeline=pipe,
                             device_caches=caches)
        with open(os.path.join(out, "metrics.jsonl")) as f:
            losses = [r["value"] for r in map(json.loads, f)
                      if r["tag"] == "train/Loss"]
        runs[where] = (res, losses, [k.launches for k in kernels])
    (res_c, loss_c, n_c), (res_g, loss_g, n_g) = runs["cpu"], runs["cuda"]
    assert n_c == [0] * len(kernels) and min(n_g) > 0, n_g
    assert len(loss_g) == len(loss_c) > 0
    np.testing.assert_allclose(loss_g, loss_c, rtol=1e-4)
    np.testing.assert_allclose(res_g["loss"], res_c["loss"], rtol=1e-4)


@pytest.mark.parametrize("task", ["detection", "SS pre-training"])
def test_rotating_prefetch_matches_resident_eval(dev, tmp_path, task):
    """A rotating dev split (at least 3 shards) on the card: its slabs are
    copied from pinned host memory on a side stream (an event to wait on
    until first use), at most two live at a prefetch, and its evaluation
    equals the resident cache's (rtol 1e-5)."""
    import logging

    from eeg_gnn_tpu_torch.data.datasets import (
        load_dataset_detection,
        load_dataset_ssl,
    )
    from eeg_gnn_tpu_torch.data.device_cache import (
        build_detection_cache,
        build_ssl_cache,
    )
    from eeg_gnn_tpu_torch.data.device_pipeline import make_device_pipeline
    from eeg_gnn_tpu_torch.data.rotating_cache import build_rotating_cache
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.train.trainer import Trainer

    cfg, p, signals, load = _cache_setup(tmp_path, task)
    ssl = task == "SS pre-training"
    loaders, _, scaler = load()
    plain_kw = dict(input_dir=p["input_dir"], raw_data_dir=p["raw_data_dir"],
                    train_batch_size=4, test_batch_size=8,
                    standardize=False, use_fft=True,
                    marker_dir=p["marker_dir"], signals=signals,
                    build_loaders=False)
    plain = (load_dataset_ssl(input_len=12, output_len=12, **plain_kw)
             if ssl else load_dataset_detection(max_seq_len=12,
                                                **plain_kw))[1]["dev"]
    resident = (build_ssl_cache if ssl else build_detection_cache)(
        plain, 12, device=dev)
    rot = build_rotating_cache(plain, 12, "ssl" if ssl else "detection",
                               budget_bytes=0, min_shards=3, device=dev)
    assert rot.num_shards >= 3 and rot._x.is_pinned()
    slab = rot.prefetch(1)
    assert slab._event is not None and slab.x.is_cuda
    slab.ready()
    lo = rot.shard_rows
    assert torch.equal(slab.x[:rot.shard_real_rows(1)].cpu(),
                       rot._x[lo:lo + rot.shard_real_rows(1)])
    del slab
    live = []
    prefetch = rot.prefetch

    def counting(shard):
        s = prefetch(shard)
        live.append(rot.resident())
        return s

    rot.prefetch = counting
    pipe = make_device_pipeline(
        graph_type="combined", filter_type=cfg.filter_type, top_k=3,
        use_fft=True, time_step_size=1, scaler=scaler, augment=False,
        adj_mat_dir=p["adj_mat_dir"], device=dev)
    model = build_model(cfg, torch.Generator().manual_seed(3))
    results = []
    for cache in (resident, rot):
        trainer = Trainer(cfg, loaders, scaler, logging.getLogger("rot"),
                          None, model, device=dev, input_pipeline=pipe,
                          device_caches={"dev": cache})
        results.append(trainer.evaluate("dev"))
    assert len(live) == rot.num_shards and max(live) <= 2
    for k in results[0]:
        np.testing.assert_allclose(results[1][k], results[0][k], rtol=1e-5)


# ---------------------------------------------------------------------------
# seizure-type classification: padded clips of mixed lengths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graph_type", ["combined", "individual"])
def test_classification_step_on_the_card_matches_the_cpu(dev, graph_type):
    """The 4-class step at mixed lengths that include 1 and T, the padded
    tail exactly zero: at dropout 0 the loss and every gradient on the
    card against the CPU's plain versions (1e-4), each kernel launched on
    the card only; at dropout 0.5 from one seeded generator, the card's
    gradients bitwise equal when the step runs twice (the bulk dW's split
    partials under the last-step cotangent)."""
    from eeg_gnn_tpu_torch.config import ExperimentConfig
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.train import TrainStep

    t, b = 12, 9
    rng = np.random.RandomState(8)
    lens = rng.randint(1, t + 1, size=b)
    lens[:2] = (1, t)
    x = rng.randn(b, t, N, 20).astype(np.float32)
    for i, n in enumerate(lens):
        x[i, n:] = 0.0
    adj = np.abs(rng.rand(b, N, N)).astype(np.float32)
    batch = {"x": x, "y": rng.randint(0, 4, size=b), "seq_lengths": lens,
             "adjacency": (adj + adj.transpose(0, 2, 1)) / 2}
    cfg = ExperimentConfig(task="classification", num_classes=4,
                           graph_type=graph_type, max_seq_len=t,
                           num_rnn_layers=2, rnn_units=16,
                           max_diffusion_step=2, input_dim=20).finalize()
    init = build_model(cfg, torch.Generator().manual_seed(2)).state_dict()
    kernels = [cr.dcgru_xin_proj, cr.dcgru_xin_fwd_loop,
               cr.dcgru_xin_bwd_loop, cr.dcgru_xin_dw, cr.dcgru_xin_dx,
               cr.dcgru_dw_reduce]
    runs = []
    for where, rate in (("cpu", 0.0), (dev, 0.0), (dev, 0.5), (dev, 0.5)):
        c = dataclasses.replace(cfg, dropout=rate)
        model = build_model(c)
        model.load_state_dict(init)
        step = TrainStep(c, model, 1, device=where,
                         generator=torch.Generator(device=where)
                         .manual_seed(4))
        for k in kernels:
            k.launches = 0
        loss = float(step.loss_and_grads(batch))
        runs.append((loss, {n: p.grad.cpu() for n, p in
                            step.model.named_parameters()},
                     [k.launches for k in kernels]))
    (loss_c, grads_c, n_c), (loss_g, grads_g, n_g) = runs[:2]
    assert n_c == [0] * len(kernels) and n_g == [2, 2, 2, 2, 1, 2], n_g
    assert abs(loss_g - loss_c) <= 1e-4 * abs(loss_c)
    for n, g in grads_c.items():
        assert _err(grads_g[n], g) <= 1e-4, n
    for n, g in runs[2][1].items():
        assert torch.equal(g, runs[3][1][n]), n


@pytest.mark.parametrize("flags", [{}, {"hbm_cache": True},
                                   {"hbm_cache": True,
                                    "hbm_budget_gb": 0.0001}],
                         ids=["streaming", "hbm_cache", "rotating"])
def test_classification_run_on_the_card_matches_the_cpu(dev, tmp_path,
                                                        flags):
    """``run_experiment(task="classification")`` on a corpus of 12 files x
    96 s (12 s clips of mixed lengths; 1 layer x 16 units, K=1, float32,
    augmentation off), streaming, resident and rotating, on the card and
    on the CPU from the same weights: losses and the test loss at rtol
    1e-4, the encoder's kernels launched on the card."""
    import json
    import logging

    from eeg_gnn_tpu_torch.cli.train import input_path
    from eeg_gnn_tpu_torch.config import ExperimentConfig
    from eeg_gnn_tpu_torch.data.datasets import load_dataset_classification
    from eeg_gnn_tpu_torch.data.synthetic import make_synthetic_corpus
    from eeg_gnn_tpu_torch.models.registry import build_model
    from eeg_gnn_tpu_torch.train.trainer import run_experiment
    from eeg_gnn_tpu_torch.utils.logging import MetricsWriter

    signals = {}
    p = make_synthetic_corpus(str(tmp_path / "corpus"), num_files=12,
                              file_seconds=96, clip_len=12, seed=1,
                              signals=signals)
    cfg = ExperimentConfig(
        task="classification", num_classes=4, graph_type="combined",
        max_seq_len=12, use_fft=True, num_rnn_layers=1, rnn_units=16,
        max_diffusion_step=1, train_batch_size=4, test_batch_size=8,
        num_epochs=2, do_train=True, num_workers=1, metric_name="F1",
        input_dir=p["input_dir"], raw_data_dir=p["raw_data_dir"],
        **flags).finalize()
    init = build_model(cfg, torch.Generator().manual_seed(3)).state_dict()
    kernels = [cr.dcgru_xin_proj, cr.dcgru_xin_fwd_loop,
               cr.dcgru_xin_bwd_loop, cr.dcgru_xin_dw]
    runs = {}
    for where in ("cpu", "cuda"):
        loaders, _, scaler = load_dataset_classification(
            input_dir=p["input_dir"], raw_data_dir=p["raw_data_dir"],
            train_batch_size=4, test_batch_size=8, max_seq_len=12,
            num_workers=1, adj_mat_dir=p["adj_mat_dir"],
            graph_type="combined", use_fft=True,
            marker_dir=p["marker_dir"], signals=signals)
        pipe, caches = input_path(cfg, scaler, adj_mat_dir=p["adj_mat_dir"],
                                  marker_dir=p["marker_dir"],
                                  signals=signals, device=where)
        for k in kernels:
            k.launches = 0
        out = str(tmp_path / where)
        os.makedirs(out)
        res = run_experiment(cfg, loaders, scaler, out,
                             logging.getLogger("classification_run"),
                             MetricsWriter(out), init_params=init,
                             device=where, input_pipeline=pipe,
                             device_caches=caches)
        with open(os.path.join(out, "metrics.jsonl")) as f:
            losses = [r["value"] for r in map(json.loads, f)
                      if r["tag"] == "train/Loss"]
        runs[where] = (res, losses, [k.launches for k in kernels])
    (res_c, loss_c, n_c), (res_g, loss_g, n_g) = runs["cpu"], runs["cuda"]
    assert n_c == [0] * len(kernels) and min(n_g) > 0, n_g
    assert len(loss_g) == len(loss_c) > 0
    np.testing.assert_allclose(loss_g, loss_c, rtol=1e-4)
    np.testing.assert_allclose(res_g["loss"], res_c["loss"], rtol=1e-4)


def test_ring_spmm_on_one_nccl_rank_matches_dense(dev):
    """graph:1 on a one-rank NCCL group: the ring SpMM against the dense
    product, its dx and dvalues against ``graphs.sparse.spmm``'s autograd
    (CUDA ``index_add_`` sums with atomics: 1e-4, not bitwise)."""
    import socket

    from eeg_gnn_tpu_torch.graphs.sparse import SparseGraph, spmm
    from eeg_gnn_tpu_torch.parallel import distributed, make_mesh
    from eeg_gnn_tpu_torch.parallel.edge_partition import (
        edge_partitioned_spmm,
        place_edge_partitioned,
    )

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    distributed.initialize(f"tcp://127.0.0.1:{port}", 1, 0, device=dev)
    try:
        mesh = make_mesh("graph:1")
        assert mesh.backend == "nccl"
        rng = np.random.RandomState(0)
        n, d, e = 1024, 64, 4096
        g = SparseGraph(*(torch.from_numpy(a) for a in (
            rng.randint(0, n, e).astype(np.int32),
            rng.randint(0, n, e).astype(np.int32),
            rng.randn(e).astype(np.float32))), n)
        x = torch.from_numpy(rng.randn(n, d).astype(np.float32))
        w = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to(dev)
        shard, xb = place_edge_partitioned(mesh, g, x)
        v = shard.values.clone().requires_grad_()
        xb.requires_grad_()
        out = edge_partitioned_spmm(mesh, dataclasses.replace(shard, values=v),
                                    xb)
        (out * w).sum().backward()
        gd = SparseGraph(g.rows.to(dev), g.cols.to(dev),
                         g.values.to(dev).requires_grad_(), n)
        xd = x.to(dev).requires_grad_()
        ref = spmm(gd, xd)
        (ref * w).sum().backward()
        torch.testing.assert_close(out, g.to_dense().to(dev) @ x.to(dev),
                                   rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(xb.grad, xd.grad, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(v.grad, gd.values.grad, rtol=1e-4,
                                   atol=1e-4)
    finally:
        distributed.shutdown()


def test_sparse_step_on_the_card_matches_dense(dev):
    """The sparse DCGRU step (graph:1, its diffusions the ring SpMM)
    against the dense (stacked) path on the same supports: gradients
    rtol 2e-3 / atol 1e-5, and no hand-written kernel launches."""
    from eeg_gnn_tpu_torch.graphs.sparse import from_dense_batch
    from eeg_gnn_tpu_torch.graphs.supports import compute_supports_torch
    from eeg_gnn_tpu_torch.models.dcrnn import DCRNNClassifier, DCRNNConfig
    from eeg_gnn_tpu_torch.parallel.edge_partition import partition_by_dest
    from eeg_gnn_tpu_torch.parallel.mesh import Mesh
    from eeg_gnn_tpu_torch.parallel.sparse_model import make_sparse_train_step
    from eeg_gnn_tpu_torch.train.losses import bce_with_logits
    from eeg_gnn_tpu_torch.train.optim import make_optimizer

    t, b, d, h = 6, 8, 12, 16
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(t, b, N, d).astype(np.float32)).to(dev)
    y = torch.from_numpy((rng.rand(b) > 0.5).astype(np.float32)).to(dev)
    sup = compute_supports_torch(torch.from_numpy(
        np.abs(rng.rand(b, N, N)).astype(np.float32)), "laplacian")
    model = DCRNNClassifier(DCRNNConfig(
        input_dim=d, rnn_units=h, num_rnn_layers=2, max_diffusion_step=K,
        num_nodes=N, num_supports=1, recurrence="stacked"),
        torch.Generator().manual_seed(0))
    mesh = Mesh(("graph",), (1,), 0, 1, dev, "nccl")
    step = make_sparse_train_step(
        model, make_optimizer(model.parameters(), 1e-3, 0.0, 5.0, 10, 10),
        mesh)
    kernels = [cr.dcgru_xin_proj, cr.dcgru_xin_fwd_loop,
               cr.dcgru_xin_bwd_loop, cr.dcgru_xin_dw, cr.dcgru_xin_dx,
               cr.dcgru_recurrence_fwd, cr.dcgru_dw_reduce]
    for k in kernels:
        k.launches = 0
    step.loss_and_grads(partition_by_dest(from_dense_batch(sup[0]), 1), x, y)
    assert [k.launches for k in kernels] == [0] * len(kernels)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad()
    bce_with_logits(model(x.transpose(0, 1), torch.full((b,), t,
                                                        device=dev),
                          sup.to(dev)), y).backward()
    for k, p in model.named_parameters():
        torch.testing.assert_close(grads[k], p.grad, rtol=2e-3, atol=1e-5)
