"""The x-in-kernel DCGRU layer split as the card runs it (the bulk
kernels and state loops of ``eeg_gnn_tpu_torch/ops/cuda_recurrent.py``),
in their plain versions, against the JAX package's fused Pallas kernels
run in interpret mode:

- the bulk input projection followed by the state-only forward loop,
  against ``_forward_xin`` (``pallas_recurrent.py:902``);
- the state-only backward loop's dpre fed to the bulk dW (split partials,
  summed) and dx products, against ``jax.grad`` through
  ``dcgru_layer_recurrence_pallas_xin`` (its custom VJP, ``_bwd_kernel_xin``);
- and the new wrappers' CPU/CUDA dispatch.

Sizes: T=6, B=3, N=19, H=8, D=12; M=3 and 5, per-clip and shared graphs.
Tolerance: float32, normalized inf-norm error max|ours - ref| / max|ref|
<= 1e-5 (the same f32 arithmetic summed in another order). The kernels
themselves are held against these plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_gnn_tpu.ops.pallas_recurrent import (
    _forward_xin,
    dcgru_layer_recurrence_pallas_xin,
)
from eeg_gnn_tpu.ops.recurrent import chebyshev_operators as jax_ops
from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr
from eeg_gnn_tpu_torch.ops.recurrent import chebyshev_operators, shift_h_prev

T, B, N, H, D, K = 6, 3, 19, 8, 12, 2
TOL = 1e-5
GRADS = ("x", "wxg", "wxc", "wg", "wc", "bg", "bc", "h0")
GRAPHS = [(1, False), (2, False), (1, True), (2, True)]  # (S, shared)


def _err(ours, ref):
    ours = np.asarray(ours.detach().float().numpy() if isinstance(
        ours, torch.Tensor) else ours, np.float32)
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12))


@functools.lru_cache(maxsize=None)
def _layer(num_supports, shared):
    """Numpy inputs of one layer (m-major input weights) and JAX's float32
    h_seq, loss and gradients of sum(h_seq * wl) through the Pallas
    kernel's custom VJP in interpret mode."""
    rng = np.random.RandomState(num_supports + 2 * shared)
    m = num_supports * K + 1
    f = lambda *s, scale=0.1: (rng.randn(*s) * scale).astype(np.float32)
    L = dict(
        m=m, sup=(np.abs(rng.randn(num_supports, 1 if shared else B, N, N))
                  / N).astype(np.float32),
        x=f(T, B, N, D, scale=1.0), wxg=f(m * D, 2 * H), wxc=f(m * D, H),
        wg=f(m, H, 2 * H), wc=f(m, H, H), bg=f(2 * H), bc=f(H),
        h0=f(B, N, H), wl=f(T, B, N, H, scale=1.0))
    a_j = jax_ops(jnp.asarray(L["sup"]), K)
    op = tuple(jnp.asarray(L[k]) for k in GRADS)
    h_seq, _ = _forward_xin(a_j, *op, "tanh", 2, True, jnp.float32)

    def loss(op):
        _, hs = dcgru_layer_recurrence_pallas_xin(a_j, *op, "tanh", 2, True,
                                                  "float32")
        return jnp.sum(hs * L["wl"])

    grads = jax.grad(loss)(op)
    return L, np.asarray(h_seq), dict(zip(GRADS, map(np.asarray, grads)))


def _torch(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port(L):
    """The port's operators, weights and forward residuals (plain)."""
    a_t = chebyshev_operators(_torch(L["sup"]), K)
    t = {k: _torch(L[k]) for k in GRADS}
    wx = torch.cat([t["wxg"], t["wxc"]], dim=1)
    xp = cr.dcgru_xin_proj_plain(t["x"], a_t, wx)
    h_seq, ru, c = cr.dcgru_xin_fwd_loop_plain(
        xp, a_t, t["wg"], t["wc"], t["bg"], t["bc"], t["h0"],
        residuals=True)
    return a_t, t, wx, xp, h_seq, ru, c


@pytest.mark.parametrize("num_supports,shared", GRAPHS)
def test_projection_and_loop_match_forward_xin(num_supports, shared):
    L, h_ref, _ = _layer(num_supports, shared)
    _, _, _, xp, h_seq, _, _ = _port(L)
    assert xp.dtype == torch.float32 and xp.shape == (T, B, N, 3 * H)
    assert _err(h_seq, h_ref) <= TOL


@pytest.mark.parametrize("splits", [1, 5])
@pytest.mark.parametrize("num_supports,shared", GRAPHS)
def test_dw_and_dx_from_dpre_match_pallas_grad(num_supports, shared, splits):
    """dpre of the state-only loop, fed to the bulk dW (its split partials
    of the 18 (t, b) pairs, summed) and dx, against jax.grad."""
    L, _, jg = _layer(num_supports, shared)
    a_t, t, wx, _, h_seq, ru, c = _port(L)
    h_prev = shift_h_prev(t["h0"], h_seq)
    dpre, dh0 = cr.dcgru_xin_bwd_loop_plain(a_t, t["wg"], t["wc"], h_prev,
                                            ru, c, _torch(L["wl"]))
    assert dpre.dtype == torch.float32 and dpre.shape == (T, B, N, 3 * H)
    part = cr.dcgru_xin_dw_plain(a_t, h_prev, ru, t["x"], dpre, splits)
    assert part.shape == (splits, cr.dw_size(L["m"], D, H))
    got = dict(zip(GRADS[1:7], cr._split_dw(part.sum(0), L["m"], D, H)))
    got["x"] = cr.dcgru_xin_dx_plain(a_t, wx, dpre, torch.float32)
    got["h0"] = dh0
    for k in GRADS:
        assert _err(got[k], jg[k]) <= TOL, k


@pytest.mark.parametrize("num_supports", [1, 2])
def test_without_dx_the_first_layer_needs_only_dw(num_supports):
    """need_dx=False (a layer fed data): the split path's dW, db and dh0
    alone equal the full plain backward's, dx is not formed."""
    L, _, jg = _layer(num_supports, False)
    a_t, t, _, _, h_seq, ru, c = _port(L)
    args = (a_t, t["wxg"], t["wxc"], t["wg"], t["wc"],
            shift_h_prev(t["h0"], h_seq), ru, c, t["x"], _torch(L["wl"]))
    nodx = cr.dcgru_recurrence_xin_bwd_plain(*args, need_dx=False)
    assert nodx[0] is None
    dpre, dh0 = cr.dcgru_xin_bwd_loop_plain(a_t, t["wg"], t["wc"], *args[5:8],
                                            args[9])
    part = cr.dcgru_xin_dw_plain(a_t, args[5], ru, t["x"], dpre)
    split = (*cr._split_dw(part.sum(0), L["m"], D, H), dh0)
    for k, g, w in zip(GRADS[1:], split, nodx[1:]):
        assert _err(g, w.numpy()) <= TOL, k
        assert _err(g, jg[k]) <= TOL, k


def _wrapper_cases(L):
    a_t, t, wx, xp, h_seq, ru, c = _port(L)
    h_prev = shift_h_prev(t["h0"], h_seq)
    d_seq = _torch(L["wl"])
    dpre, _ = cr.dcgru_xin_bwd_loop_plain(a_t, t["wg"], t["wc"], h_prev, ru,
                                          c, d_seq)
    hidden = (t["wg"], t["wc"], t["bg"], t["bc"], t["h0"])
    return [
        (cr.dcgru_xin_proj, cr.dcgru_xin_proj_plain, (t["x"], a_t, wx)),
        (cr.dcgru_xin_fwd_loop, cr.dcgru_xin_fwd_loop_plain,
         (xp, a_t, *hidden)),
        (cr.dcgru_xin_bwd_loop, cr.dcgru_xin_bwd_loop_plain,
         (a_t, t["wg"], t["wc"], h_prev, ru, c, d_seq)),
        (cr.dcgru_xin_dw, cr.dcgru_xin_dw_plain,
         (a_t, h_prev, ru, t["x"], dpre)),
        (cr.dcgru_xin_dx, cr.dcgru_xin_dx_plain,
         (a_t, wx, dpre, torch.float32)),
    ]


@pytest.mark.parametrize("case", range(5))
def test_new_wrappers_use_plain_on_cpu_and_do_not_count(case):
    kern, plain, args = _wrapper_cases(_layer(1, False)[0])[case]
    before = kern.launches
    got, want = kern(*args), plain(*args)
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        if w is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert kern.launches == before


@pytest.mark.parametrize("case", range(5))
def test_new_wrappers_raise_off_cpu_without_cuda(case):
    """No silent fallback: a tensor that is not on the CPU goes to the
    kernel or raises (here: the meta device)."""
    kern, _, args = _wrapper_cases(_layer(1, False)[0])[case]
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="neither on the CPU nor"):
        kern(*meta)
