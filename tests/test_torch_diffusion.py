"""The port's Chebyshev diffusion, operator stack and golden DCGRU cell
against the JAX package's (eeg_gnn_tpu/ops/diffusion.py, ops/recurrent.py,
models/dcgru.py), including the cross-support carry-over quirk."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_gnn_tpu.models import dcgru as jdcgru
from eeg_gnn_tpu.ops import diffusion as jdiff
from eeg_gnn_tpu.ops import recurrent as jrec
from eeg_gnn_tpu_torch.models import dcgru as tdcgru
from eeg_gnn_tpu_torch.ops import diffusion as tdiff
from eeg_gnn_tpu_torch.ops import recurrent as trec

N, B, D = 19, 3, 12
F32 = dict(rtol=1e-4, atol=1e-5)


def _supports(rng, s, batched):
    shape = (s, B, N, N) if batched else (s, N, N)
    return (np.abs(rng.randn(*shape)) / N).astype(np.float32)


@pytest.mark.parametrize("s,k,batched", [
    (2, 2, True),   # dual support, K=2: exercises the carry-over quirk
    (1, 2, True),
    (2, 3, False),  # shared graph, deeper recurrence
    (1, 0, True),   # identity feature only
])
def test_chebyshev_diffusion_matches_jax(rng, s, k, batched):
    sup = _supports(rng, s, batched)
    x = rng.randn(B, N, D).astype(np.float32)
    ours = tdiff.chebyshev_diffusion(torch.from_numpy(sup),
                                     torch.from_numpy(x), k)
    ref = np.asarray(jdiff.chebyshev_diffusion(jnp.asarray(sup),
                                               jnp.asarray(x), k))
    assert ours.shape == ref.shape == (B, N, D, s * k + 1)
    np.testing.assert_allclose(ours.numpy(), ref, **F32)


def test_carry_over_quirk_terms(rng):
    """At M=5 the terms are [x, S0x, 2S0^2x - x, S1S0x, 2S1^2S0x - S0x]."""
    sup = torch.from_numpy(_supports(rng, 2, True)).double()
    x = torch.from_numpy(rng.randn(B, N, D)).double()
    f = tdiff.chebyshev_diffusion(sup, x, 2)
    s0, s1 = sup
    s0x = s0 @ x
    want = [x, s0x, 2 * s0 @ s0x - x, s1 @ s0x, 2 * s1 @ (s1 @ s0x) - s0x]
    for m, w in enumerate(want):
        torch.testing.assert_close(f[..., m], w)


def test_diffusion_conv_matches_jax(rng):
    sup = _supports(rng, 2, True)
    x = rng.randn(B, N, D).astype(np.float32)
    w = (rng.randn(D * 5, 7) * 0.1).astype(np.float32)
    bias = rng.randn(7).astype(np.float32)
    ours = tdiff.diffusion_conv(*map(torch.from_numpy, (sup, x, w, bias)), 2)
    ref = jdiff.diffusion_conv(*map(jnp.asarray, (sup, x, w, bias)), 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("s,batched", [(2, True), (1, True), (1, False)])
def test_chebyshev_operators_match_jax(rng, s, batched):
    sup = _supports(rng, s, batched)
    ours = trec.chebyshev_operators(torch.from_numpy(sup), 2)
    ref = np.asarray(jrec.chebyshev_operators(jnp.asarray(sup), 2))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, **F32)
    # A_0 = I: the kernels skip its product
    np.testing.assert_array_equal(ours[0].numpy(),
                                  np.broadcast_to(np.eye(N), ours[0].shape))


def test_operator_stack_equals_term_recurrence(rng):
    """sum_m (A_m x) W_m == diffusion_conv's term-by-term recurrence."""
    sup = torch.from_numpy(_supports(rng, 2, True))
    x = torch.from_numpy(rng.randn(B, N, D).astype(np.float32))
    w = torch.from_numpy((rng.randn(D * 5, 7) * 0.1).astype(np.float32))
    a_ops = trec.chebyshev_operators(sup, 2)
    via_ops = trec._contract_w(trec._apply_ops(a_ops, x),
                               trec.rearrange_hidden_weight(w, D, 5))
    direct = tdiff.diffusion_conv(sup, x, w, torch.zeros(7), 2)
    torch.testing.assert_close(via_ops, direct, **F32)


def test_rearrange_hidden_weight_matches_jax(rng):
    w = rng.randn(16 * 5, 32).astype(np.float32)
    ours = trec.rearrange_hidden_weight(torch.from_numpy(w), 16, 5)
    ref = np.asarray(jrec.rearrange_hidden_weight(jnp.asarray(w), 16, 5))
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("s,activation", [(1, "tanh"), (2, "tanh"),
                                          (2, "relu")])
def test_dcgru_cell_apply_matches_jax(rng, s, activation):
    h_units = 16
    jcfg = jdcgru.DCGRUConfig(D, h_units, 2, N, s, activation)
    params = jax.tree_util.tree_map(
        np.array, jdcgru.init_dcgru_cell(jax.random.PRNGKey(1), jcfg))
    sup = _supports(rng, s, True)
    x = rng.randn(B, N, D).astype(np.float32)
    h = (rng.randn(B, N, h_units) * 0.5).astype(np.float32)
    ref = jdcgru.dcgru_cell_apply(jcfg, params, jnp.asarray(sup),
                                  jnp.asarray(x), jnp.asarray(h))
    tcfg = tdcgru.DCGRUConfig(D, h_units, 2, N, s, activation)
    ours = tdcgru.dcgru_cell_apply(
        tcfg, {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(sup), torch.from_numpy(x), torch.from_numpy(h))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **F32)
