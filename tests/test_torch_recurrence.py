"""The plain versions of the port's DCGRU recurrence kernels
(eeg_gnn_tpu_torch/ops/cuda_recurrent.py) against the JAX package's Pallas
kernels run in interpret mode, as tests/test_recurrent.py runs them; the
encoder against the JAX encoder; and the wrappers' CPU/CUDA dispatch.
The kernels themselves are held against the plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.

bf16 cases hold the port's bf16 streams against JAX in float32 (the JAX
CPU bf16 path is a known red test): normalized inf-norm error <= 2e-2,
the bound of benchmarks/tpu_kernel_parity.json. float32 cases use the
criterion of tests/test_recurrent.py:316 (rtol 1e-4, atol 1e-5).
"""

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
from eeg_gnn_tpu_torch.ops.recurrent import chebyshev_operators

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


def test_cpu_wrappers_use_plain_and_do_not_count(rng):
    L = _layer(rng, 1, 2, False)
    m = L["m"]
    a_t = chebyshev_operators(_torch(L["sup"]), K)
    hidden = [_torch(L[k]) for k in ("wg", "wc", "bg", "bc", "h0")]
    xin_args = (_torch(L["x"]), a_t, _torch(_mmajor(L["wxg"], D, m)),
                _torch(_mmajor(L["wxc"], D, m)), *hidden)
    before = (cr.dcgru_recurrence_xin_fwd.launches,
              cr.dcgru_recurrence_fwd.launches)
    torch.testing.assert_close(cr.dcgru_recurrence_xin_fwd(*xin_args)[0],
                               cr.dcgru_recurrence_xin_fwd_plain(*xin_args)[0])
    hoisted_args = (_torch(L["xp"]), a_t, *hidden)
    torch.testing.assert_close(cr.dcgru_recurrence_fwd(*hoisted_args)[0],
                               cr.dcgru_recurrence_fwd_plain(*hoisted_args)[0])
    assert (cr.dcgru_recurrence_xin_fwd.launches,
            cr.dcgru_recurrence_fwd.launches) == before


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
