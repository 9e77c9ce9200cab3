"""The plain versions of the port's DCGRU recurrence kernels
(eeg_gnn_tpu_torch/ops/cuda_recurrent.py), forward and backward, against
the JAX package's Pallas kernels run in interpret mode (values, and
``jax.grad`` through their custom VJPs), as tests/test_recurrent.py runs
them; the stacked recurrence's hand-written BPTT against torch autograd;
the encoder against the JAX encoder; and the wrappers' CPU/CUDA dispatch.
The kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.

bf16 cases hold the port's bf16 streams against JAX in float32 (the JAX
CPU bf16 path is a known red test): normalized inf-norm error <= 2e-2,
the bound of benchmarks/tpu_kernel_parity.json. float32 cases use the
criterion of tests/test_recurrent.py:316 (rtol 1e-4, atol 1e-5).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_gnn_tpu.models import dcgru as jdcgru
from eeg_gnn_tpu.ops.pallas_recurrent import (
    dcgru_layer_recurrence_pallas_fused,
    dcgru_layer_recurrence_pallas_xin,
)
from eeg_gnn_tpu.ops.recurrent import _scan_forward as jax_scan_forward
from eeg_gnn_tpu.ops.recurrent import chebyshev_operators as jax_ops
from eeg_gnn_tpu_torch.models import dcgru as tdcgru
from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr
from eeg_gnn_tpu_torch.ops.recurrent import (
    _scan_forward,
    chebyshev_operators,
    dcgru_layer_recurrence,
    shift_h_prev,
)

T, N, H, D, K = 5, 19, 16, 12, 2
BF16_TOL = 2e-2


def _close(ours, ref, bf16, name=""):
    ours = ours.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, name
    if bf16:
        err = np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-9)
        assert err <= BF16_TOL, (name, err)
    else:
        np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _layer(rng, num_supports, batch, shared):
    """Numpy inputs of one layer: supports, x, weights (JAX layouts)."""
    m = num_supports * K + 1
    sb = 1 if shared else batch
    sup = (np.abs(rng.randn(num_supports, sb, N, N)) / N).astype(np.float32)
    f = lambda *s, scale=0.1: (rng.randn(*s) * scale).astype(np.float32)
    return dict(
        m=m, sup=sup, x=f(T, batch, N, D, scale=1.0),
        wxg=f(D * m, 2 * H), wxc=f(D * m, H), wg=f(m, H, 2 * H),
        wc=f(m, H, H), bg=f(2 * H), bc=f(H), h0=f(batch, N, H),
        xp=f(T, batch, N, 3 * H, scale=0.5))


def _mmajor(w, d, m):
    return np.ascontiguousarray(
        w.reshape(d, m, -1).transpose(1, 0, 2).reshape(m * d, -1))


def _torch(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


CASES = [  # num_supports (M = 2K+1 or K+1), batch, shared, bf16
    (1, 4, False, False),
    (1, 4, True, False),
    (2, 5, False, False),
    (2, 3, True, False),
    (1, 4, False, True),
    (2, 5, False, True),
]


@pytest.mark.parametrize("num_supports,batch,shared,bf16", CASES)
def test_plain_xin_matches_pallas_interpret(rng, num_supports, batch,
                                            shared, bf16):
    L = _layer(rng, num_supports, batch, shared)
    m = L["m"]
    a_j = jax_ops(jnp.asarray(L["sup"]), K)
    wxg_f, wxc_f = _mmajor(L["wxg"], D, m), _mmajor(L["wxc"], D, m)
    _, ref = dcgru_layer_recurrence_pallas_xin(
        a_j, jnp.asarray(L["x"]), jnp.asarray(wxg_f), jnp.asarray(wxc_f),
        *map(jnp.asarray, (L["wg"], L["wc"], L["bg"], L["bc"], L["h0"])),
        "tanh", 2, True, "float32")

    a_t = chebyshev_operators(_torch(L["sup"]), K)
    stream = torch.bfloat16 if bf16 else torch.float32
    h_seq, ru, c = cr.dcgru_recurrence_xin_fwd_plain(
        _torch(L["x"], stream), a_t, _torch(wxg_f), _torch(wxc_f),
        *map(_torch, (L["wg"], L["wc"], L["bg"], L["bc"], L["h0"])))
    assert h_seq.dtype == stream and ru is None and c is None
    _close(h_seq, ref, bf16)


@pytest.mark.parametrize("num_supports,batch,shared,bf16", CASES)
def test_plain_hoisted_matches_pallas_interpret(rng, num_supports, batch,
                                                shared, bf16):
    L = _layer(rng, num_supports, batch, shared)
    a_j = jax_ops(jnp.asarray(L["sup"]), K)
    _, ref = dcgru_layer_recurrence_pallas_fused(
        a_j, jnp.asarray(L["xp"]),
        *map(jnp.asarray, (L["wg"], L["wc"], L["bg"], L["bc"], L["h0"])),
        "tanh", 2, True, "float32")

    a_t = chebyshev_operators(_torch(L["sup"]), K)
    stream = torch.bfloat16 if bf16 else torch.float32
    h_seq, _, _ = cr.dcgru_recurrence_fwd_plain(
        _torch(L["xp"], stream), a_t,
        *map(_torch, (L["wg"], L["wc"], L["bg"], L["bc"], L["h0"])))
    assert h_seq.dtype == stream
    _close(h_seq, ref, bf16)


@pytest.mark.parametrize("activation", ["tanh", "relu", "linear"])
def test_plain_residuals_match_jax_scan(rng, activation):
    """ru_seq / c_seq of both plain versions vs the JAX stacked scan's
    residuals; the xin version is fed the x_proj its input makes."""
    L = _layer(rng, 2, 3, False)
    m = L["m"]
    a_j = jax_ops(jnp.asarray(L["sup"]), K)
    xf = np.asarray(jdcgru.chebyshev_diffusion(
        jnp.asarray(L["sup"]), jnp.asarray(L["x"]), K)).reshape(
            T, 3, N, D * m)
    gx, cx = xf @ L["wxg"], xf @ L["wxc"]
    _, h_ref, ru_ref, c_ref = jax_scan_forward(
        a_j, jnp.asarray(gx), jnp.asarray(cx),
        *map(jnp.asarray, (L["wg"], L["wc"], L["bg"], L["bc"], L["h0"])),
        activation, jnp.float32)

    a_t = chebyshev_operators(_torch(L["sup"]), K)
    hidden = [_torch(L[k]) for k in ("wg", "wc", "bg", "bc", "h0")]
    xin = cr.dcgru_recurrence_xin_fwd_plain(
        _torch(L["x"]), a_t, _torch(_mmajor(L["wxg"], D, m)),
        _torch(_mmajor(L["wxc"], D, m)), *hidden, activation, residuals=True)
    hoisted = cr.dcgru_recurrence_fwd_plain(
        _torch(np.concatenate([gx, cx], -1)), a_t, *hidden, activation,
        residuals=True)
    for out in (xin, hoisted):
        for got, ref, name in zip(out, (h_ref, ru_ref, c_ref),
                                  ("h", "ru", "c")):
            _close(got, ref, False, name)


@pytest.mark.parametrize("recurrence,fusion", [
    ("pallas", True), ("pallas", False), ("stacked", False)])
@pytest.mark.parametrize("num_supports,shared", [(1, False), (2, False),
                                                 (1, True)])
def test_encoder_matches_jax(rng, recurrence, fusion, num_supports, shared):
    """Two-layer encoder: every port dispatch vs the JAX encoder (which
    runs its stacked scan off-TPU)."""
    b = 3
    jcfgs = jdcgru.encoder_configs(D, H, K, N, num_supports, 2)
    params = jax.tree_util.tree_map(
        np.array, jdcgru.encoder_init(jax.random.PRNGKey(0), jcfgs))
    sup = (np.abs(rng.randn(num_supports, *(() if shared else (b,)), N, N))
           / N).astype(np.float32)
    x = rng.randn(T, b, N, D).astype(np.float32)
    stack_j, seq_j = jdcgru.encoder_apply(jcfgs, params, jnp.asarray(sup),
                                          jnp.asarray(x))
    tcfgs = tdcgru.encoder_configs(D, H, K, N, num_supports, 2,
                                   recurrence=recurrence, input_fusion=fusion)
    tparams = [{k: torch.from_numpy(v) for k, v in p.items()} for p in params]
    stack_t, seq_t = tdcgru.encoder_apply(tcfgs, tparams, _torch(sup),
                                          _torch(x))
    _close(stack_t, stack_j, False, "stack")
    _close(seq_t, seq_j, False, "seq")


@pytest.mark.parametrize("recurrence,fusion", [
    ("pallas", True), ("pallas", False), ("stacked", False)])
@pytest.mark.parametrize("num_supports,bf16", [(1, False), (2, False),
                                               (2, True)])
def test_encoder_grads_match_jax(rng, recurrence, fusion, num_supports,
                                 bf16):
    """Two-layer encoder gradients under one dense cotangent on the top
    h_seq, every port dispatch (the BPTT of both layers, the hoisted
    projection's autograd, the bf16 layer-to-layer cotangent) vs
    jax.vjp of the JAX encoder in float32."""
    b = 3
    jcfgs = jdcgru.encoder_configs(D, H, K, N, num_supports, 2)
    params = jax.tree_util.tree_map(
        np.array, jdcgru.encoder_init(jax.random.PRNGKey(0), jcfgs))
    sup = (np.abs(rng.randn(num_supports, b, N, N)) / N).astype(np.float32)
    x = rng.randn(T, b, N, D).astype(np.float32)
    cot = rng.randn(T, b, N, H).astype(np.float32)
    _, vjp = jax.vjp(lambda p: jdcgru.encoder_apply(
        jcfgs, p, jnp.asarray(sup), jnp.asarray(x))[1], params)
    want = vjp(jnp.asarray(cot))[0]

    tcfgs = tdcgru.encoder_configs(
        D, H, K, N, num_supports, 2, recurrence=recurrence,
        input_fusion=fusion, compute_dtype="bfloat16" if bf16 else "float32")
    tparams = [{k: torch.from_numpy(v).requires_grad_() for k, v in
                p.items()} for p in params]
    _, seq = tdcgru.encoder_apply(tcfgs, tparams, _torch(sup), _torch(x))
    leaves = [p[k] for p in tparams for k in sorted(p)]
    got = torch.autograd.grad((seq.float() * _torch(cot)).sum(), leaves)
    for i, (p, w) in enumerate(zip(tparams, want)):
        for k, g in zip(sorted(p), got[4 * i:4 * i + 4]):
            _close(g, w[k], bf16, f"layer {i} {k}")


def test_cpu_wrappers_use_plain_and_do_not_count(rng):
    L = _layer(rng, 1, 2, False)
    m = L["m"]
    a_t = chebyshev_operators(_torch(L["sup"]), K)
    hidden = [_torch(L[k]) for k in ("wg", "wc", "bg", "bc", "h0")]
    xin_args = (_torch(L["x"]), a_t, _torch(_mmajor(L["wxg"], D, m)),
                _torch(_mmajor(L["wxc"], D, m)), *hidden)
    counters = (cr.dcgru_xin_proj, cr.dcgru_xin_fwd_loop,
                cr.dcgru_recurrence_fwd)
    before = [k.launches for k in counters]
    torch.testing.assert_close(cr.dcgru_recurrence_xin_fwd(*xin_args)[0],
                               cr.dcgru_recurrence_xin_fwd_plain(*xin_args)[0])
    hoisted_args = (_torch(L["xp"]), a_t, *hidden)
    torch.testing.assert_close(cr.dcgru_recurrence_fwd(*hoisted_args)[0],
                               cr.dcgru_recurrence_fwd_plain(*hoisted_args)[0])
    assert [k.launches for k in counters] == before


def test_wrappers_raise_off_cpu_without_cuda(rng):
    """No silent fallback: a tensor that is not on the CPU goes to the
    kernel or raises (here: the meta device)."""
    m = 3
    meta = lambda *s: torch.empty(*s, device="meta")
    hidden = (meta(m, H, 2 * H), meta(m, H, H), meta(2 * H), meta(H),
              meta(2, N, H))
    with pytest.raises(ValueError, match="neither on the CPU nor"):
        cr.dcgru_recurrence_xin_fwd(meta(T, 2, N, D), meta(m, 2, N, N),
                                    meta(m * D, 2 * H), meta(m * D, H),
                                    *hidden)
    with pytest.raises(ValueError, match="neither on the CPU nor"):
        cr.dcgru_recurrence_fwd(meta(T, 2, N, 3 * H), meta(m, 2, N, N),
                                *hidden)


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

XIN_GRADS = ("x", "wxg", "wxc", "wg", "wc", "bg", "bc", "h0")
HOISTED_GRADS = ("xp", "wg", "wc", "bg", "bc", "h0")


@functools.lru_cache(maxsize=None)
def _jax_grads(kind, num_supports, batch, shared, activation="tanh"):
    """Inputs (numpy, drawn from RandomState(0)) and JAX's float32 loss
    and gradients of sum(h_seq * wl) through the Pallas kernel's custom
    VJP in interpret mode; cached so a bf16 case reuses its f32 run."""
    rng = np.random.RandomState(0)
    L = _layer(rng, num_supports, batch, shared)
    wl = rng.randn(T, batch, N, H).astype(np.float32)
    m = L["m"]
    a_j = jax_ops(jnp.asarray(L["sup"]), K)
    hidden = tuple(jnp.asarray(L[k]) for k in ("wg", "wc", "bg", "bc",
                                               "h0"))
    if kind == "xin":
        L["wxg"], L["wxc"] = _mmajor(L["wxg"], D, m), _mmajor(L["wxc"], D, m)

        def loss(op):
            _, hs = dcgru_layer_recurrence_pallas_xin(
                a_j, *op, activation, 2, True, "float32")
            return jnp.sum(hs * wl)

        names = XIN_GRADS
        op = (jnp.asarray(L["x"]), jnp.asarray(L["wxg"]),
              jnp.asarray(L["wxc"])) + hidden
    else:
        def loss(op):
            _, hs = dcgru_layer_recurrence_pallas_fused(
                a_j, *op, activation, 2, True, "float32")
            return jnp.sum(hs * wl)

        names = HOISTED_GRADS
        op = (jnp.asarray(L["xp"]),) + hidden
    value, grads = jax.value_and_grad(loss)(op)
    return L, wl, float(value), dict(zip(names, map(np.asarray, grads)))


def _port_grads(kind, L, wl, activation, stream):
    """The port's autograd Function on CPU tensors: loss and gradients."""
    a_t = chebyshev_operators(_torch(L["sup"]), K)
    names = XIN_GRADS if kind == "xin" else HOISTED_GRADS
    leaves = {k: _torch(L[k], stream if k in ("x", "xp") else torch.float32)
              .requires_grad_() for k in names}
    hidden = [leaves[k] for k in ("wg", "wc", "bg", "bc", "h0")]
    if kind == "xin":
        h_seq = cr.dcgru_layer_recurrence_xin(
            leaves["x"], a_t, leaves["wxg"], leaves["wxc"], *hidden,
            activation)
    else:
        h_seq = cr.dcgru_layer_recurrence_fused(leaves["xp"], a_t, *hidden,
                                                activation)
    assert h_seq.dtype == stream
    value = (h_seq.float() * _torch(wl)).sum()
    grads = torch.autograd.grad(value, [leaves[k] for k in names])
    for k, g in zip(names, grads):
        assert g.dtype == leaves[k].dtype, k  # dx in the stream dtype
    return float(value.detach()), dict(zip(names, grads))


@pytest.mark.parametrize("num_supports,batch,shared,bf16", CASES)
def test_plain_xin_bwd_matches_pallas_grad(num_supports, batch, shared,
                                           bf16):
    """jax.grad through dcgru_layer_recurrence_pallas_xin (interpret) vs
    the port's xin autograd Function, whose backward is the plain
    version of the backward kernel on CPU tensors."""
    L, wl, want, jg = _jax_grads("xin", num_supports, batch, shared)
    stream = torch.bfloat16 if bf16 else torch.float32
    got, tg = _port_grads("xin", L, wl, "tanh", stream)
    if not bf16:  # sum(h_seq * wl) cancels: bf16 is held by the grads
        np.testing.assert_allclose(got, want, rtol=1e-4)
    for k in XIN_GRADS:
        _close(tg[k], jg[k], bf16, k)


@pytest.mark.parametrize("num_supports,batch,shared,bf16,activation", [
    (1, 4, False, False, "tanh"),
    (2, 3, True, False, "tanh"),
    (2, 5, False, True, "tanh"),
    (1, 4, False, False, "relu"),
])
def test_plain_hoisted_bwd_matches_pallas_grad(num_supports, batch, shared,
                                               bf16, activation):
    """jax.grad through dcgru_layer_recurrence_pallas_fused (interpret)
    vs the port's fused autograd Function (plain backward on the CPU)."""
    L, wl, want, jg = _jax_grads("hoisted", num_supports, batch, shared,
                                 activation)
    stream = torch.bfloat16 if bf16 else torch.float32
    got, tg = _port_grads("hoisted", L, wl, activation, stream)
    if not bf16:  # sum(h_seq * wl) cancels: bf16 is held by the grads
        np.testing.assert_allclose(got, want, rtol=1e-4)
    for k in HOISTED_GRADS:
        _close(tg[k], jg[k], bf16, k)


@pytest.mark.parametrize("activation", ["tanh", "relu", "linear"])
@pytest.mark.parametrize("shared", [False, True])
def test_stacked_bwd_matches_torch_autograd(rng, activation, shared):
    """The stacked Function's hand-written BPTT against torch autograd of
    the plain forward loop, with cotangents on h_seq and h_last."""
    L = _layer(rng, 2, 3, shared)
    a_t = chebyshev_operators(_torch(L["sup"]), K)
    leaves = [_torch(L["xp"][..., :2 * H]), _torch(L["xp"][..., 2 * H:])]
    leaves += [_torch(L[k]) for k in ("wg", "wc", "bg", "bc", "h0")]
    for t in leaves:
        t.requires_grad_()
    wl = _torch(rng.randn(T, 3, N, H))
    wlast = _torch(rng.randn(3, N, H))
    h_last, h_seq = dcgru_layer_recurrence(a_t, *leaves, activation)
    got = torch.autograd.grad((h_seq * wl).sum() + (h_last * wlast).sum(),
                              leaves)
    _, ref_seq, _, _ = _scan_forward(a_t, *leaves, activation)
    want = torch.autograd.grad((ref_seq * wl).sum()
                               + (ref_seq[-1] * wlast).sum(), leaves)
    for name, g, w in zip(("gx", "cx", "wg", "wc", "bg", "bc", "h0"), got,
                          want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5, msg=name)


def _bwd_args(L, m):
    a_t = chebyshev_operators(_torch(L["sup"]), K)
    h_seq, ru, c = cr.dcgru_recurrence_xin_fwd_plain(
        _torch(L["x"]), a_t, _torch(_mmajor(L["wxg"], D, m)),
        _torch(_mmajor(L["wxc"], D, m)),
        *map(_torch, (L["wg"], L["wc"], L["bg"], L["bc"], L["h0"])),
        residuals=True)
    d_seq = _torch(np.random.RandomState(1).randn(*h_seq.shape))
    streams = (shift_h_prev(_torch(L["h0"]), h_seq), ru, c)
    xin = (a_t, _torch(_mmajor(L["wxg"], D, m)),
           _torch(_mmajor(L["wxc"], D, m)), _torch(L["wg"]),
           _torch(L["wc"]), *streams, _torch(L["x"]), d_seq)
    hoisted = (a_t, _torch(L["wg"]), _torch(L["wc"]), *streams, d_seq)
    return xin, hoisted


def test_cpu_bwd_wrappers_use_plain_and_do_not_count(rng):
    L = _layer(rng, 1, 2, False)
    xin, hoisted = _bwd_args(L, L["m"])
    # the two BPTT wrappers launch nothing of their own: their kernels count
    counters = (cr.dcgru_xin_bwd_loop, cr.dcgru_xin_dw, cr.dcgru_xin_dx,
                cr.dcgru_dw_reduce)
    before = [k.launches for k in counters]
    for kern, plain, args in (
            (cr.dcgru_recurrence_xin_bwd, cr.dcgru_recurrence_xin_bwd_plain,
             xin),
            (cr.dcgru_recurrence_bwd, cr.dcgru_recurrence_bwd_plain,
             hoisted)):
        for g, w in zip(kern(*args), plain(*args)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    part = _torch(rng.randn(3, 7))
    torch.testing.assert_close(cr.dcgru_dw_reduce(part), part.sum(0))
    assert [k.launches for k in counters] == before


def test_xin_bwd_without_dx(rng):
    """need_dx=False returns dx as None and every other output as with
    dx; the autograd Function asks for no dx when x needs no gradient."""
    L = _layer(rng, 2, 3, False)
    xin, _ = _bwd_args(L, L["m"])
    full = cr.dcgru_recurrence_xin_bwd(*xin)
    part = cr.dcgru_recurrence_xin_bwd(*xin, need_dx=False)
    assert part[0] is None and full[0].shape == xin[-2].shape
    for g, w in zip(part[1:], full[1:]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)

    a_t, wxg, wxc, wg, wc = xin[:5]
    leaves = [t.clone().requires_grad_() for t in
              (wxg, wxc, wg, wc, _torch(L["bg"]), _torch(L["bc"]),
               _torch(L["h0"]))]
    asked, grads = [], []
    wrapper = cr.dcgru_recurrence_xin_bwd

    def spy(*args, need_dx=True, **kwargs):
        asked.append(need_dx)
        return wrapper(*args, need_dx=need_dx, **kwargs)

    for x_grad in (True, False):
        x = _torch(L["x"]).requires_grad_(x_grad)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(cr, "dcgru_recurrence_xin_bwd", spy)
            h_seq = cr.dcgru_layer_recurrence_xin(x, a_t, *leaves[:4],
                                                  *leaves[4:])
            grads.append(torch.autograd.grad(h_seq.sum(), leaves))
        assert asked[-1] == x_grad
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_bwd_wrappers_raise_off_cpu_without_cuda(rng):
    """No silent fallback for the backward wrappers either."""
    L = _layer(rng, 1, 2, False)
    xin, hoisted = _bwd_args(L, L["m"])
    meta = lambda args: [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="neither on the CPU nor"):
        cr.dcgru_recurrence_xin_bwd(*meta(xin))
    with pytest.raises(ValueError, match="neither on the CPU nor"):
        cr.dcgru_recurrence_bwd(*meta(hoisted))
    with pytest.raises(ValueError, match="neither on the CPU nor"):
        cr.dcgru_dw_reduce(torch.empty(3, 7, device="meta"))
