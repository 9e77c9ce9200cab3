"""The bulk dW kernel's inputs and arithmetic (``dcgru_xin_dw``,
``csrc/dcgru_xin_gemm.cu``) on the CPU:

- the operators the wrapper lays out as the kernel's tensor-core A
  fragments (``dw_op_frags``), decoded by the PTX fragment maps of
  ``mma.m16n8k16`` (bf16) and ``mma.m16n8k8`` (tf32, split into hi and
  lo), hold every clip's A_m^T;
- the split count follows from the shape alone (the same on every card),
  and the plain version's partials follow it;
- the kernel's rounding, emulated (``tests/chain_emulation.py``,
  ``dw_chain``: the diffusion moved to dpre's side, G_m = A_m^T dpre, in
  bf16 one bf16 pass rounded to bf16 and r h_prev rounded to bf16),
  against the JAX package's gradients through ``_bwd_kernel_xin`` in
  interpret mode: bf16 within 2e-2 (normalized inf-norm), f32 within
  1e-5 (the same f32 arithmetic summed in another order).

Sizes: T=6, B=3, N=19, H=8, D=12 (the JAX comparison); N=7, 19 and 32 for
the layouts. The kernel itself is held against these on the card by
tests/test_torch_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chain_emulation import dw_chain
from eeg_gnn_tpu.ops.pallas_recurrent import dcgru_layer_recurrence_pallas_xin
from eeg_gnn_tpu.ops.recurrent import chebyshev_operators as jax_ops
from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr
from eeg_gnn_tpu_torch.ops.recurrent import chebyshev_operators, shift_h_prev

T, B, N, H, D, K = 6, 3, 19, 8, 12, 2
GRADS = ("x", "wxg", "wxc", "wg", "wc", "bg", "bc", "h0")


def _ops(n, b, num_supports, seed):
    rng = np.random.RandomState(seed)
    sup = (np.abs(rng.randn(num_supports, b, n, n)) / n).astype(np.float32)
    return chebyshev_operators(torch.from_numpy(sup), K)


def _decode(frags, n, bf16):
    """A (M-1, a_batch) stack of (16 RT, depth KT) matrices from the
    fragments: bf16 lane 4g + t holds a0 = (g, 2t..2t+1), a1 = (g+8, ..),
    a2 = (g, 2t+8..), a3 = (g+8, 2t+8..); tf32 lane 4g + t holds (g, t),
    (g+8, t), (g, t+4), (g+8, t+4), hi and lo summed."""
    rt = -(-n // 16)
    if bf16:
        kt = -(-n // 16)
        f = frags.float().reshape(*frags.shape[:2], rt, kt, 8, 4, 4, 2)
        out = torch.zeros(*frags.shape[:2], 16 * rt, 16 * kt)
        for r in range(rt):
            for k in range(kt):
                for reg in range(4):
                    for e in range(2):
                        row = 16 * r + torch.arange(8)[:, None] + 8 * (reg & 1)
                        col = (16 * k + 2 * torch.arange(4)[None, :] + e
                               + 8 * (reg >> 1))
                        out[:, :, row, col] = f[:, :, r, k, :, :, reg, e]
        return out
    kt = -(-n // 8)
    f = frags.reshape(*frags.shape[:2], rt, kt, 2, 8, 4, 4)
    hi, lo = f[..., 0, :, :, :], f[..., 1, :, :, :]
    assert torch.equal(hi, cr.round_tf32(hi))  # hi holds TF32's bits only
    out = torch.zeros(*frags.shape[:2], 16 * rt, 8 * kt)
    for r in range(rt):
        for k in range(kt):
            for w in range(4):
                row = 16 * r + torch.arange(8)[:, None] + 8 * (w & 1)
                col = 8 * k + torch.arange(4)[None, :] + 4 * (w >> 1)
                out[:, :, row, col] = (hi + lo)[:, :, r, k, :, :, w]
    return out


@pytest.mark.parametrize("n", [7, 19, 32])
@pytest.mark.parametrize("num_supports,b", [(1, 3), (2, 1)])
@pytest.mark.parametrize("bf16", [False, True])
def test_dw_op_frags_hold_each_clip_transposed_operator(n, num_supports, b,
                                                        bf16):
    a = _ops(n, b, num_supports, seed=n + b)
    frags = cr.dw_op_frags(a, bf16)
    m = a.shape[0]
    assert frags.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert frags.shape[:2] == (m - 1, b) and frags.is_contiguous()
    got = _decode(frags, n, bf16)
    want = a[1:].transpose(-1, -2)
    if bf16:
        want = want.to(torch.bfloat16).float()
    assert torch.equal(got[..., :n, :n], want)  # hi + lo is exact
    assert not got[..., n:, :].any() and not got[..., :, n:].any()


def test_dw_splits_follow_the_shape():
    """Whole waves of 132 blocks (9 a split at M=3, H=64; 15 at M=5), the
    fewest whose splits hold at most 192 pairs: the detector (T=60,
    B=128, D=100 and 64), the SSL decoder's layer 0 (12 steps) and tied
    cell (24 stacked steps), a ragged and a small batch."""
    assert (cr.DW_WAVE_BLOCKS, cr.DW_SPLIT_PAIRS) == (132, 192)
    assert cr.dw_blocks(3, 100, 64) == cr.dw_blocks(3, 64, 64) == 9
    assert cr.dw_blocks(5, 100, 64) == 15 and cr.dw_blocks(3, 12, 16) == 6
    rule = {(7680, 3, 100, 64): 44, (7680, 3, 64, 64): 44,
            (7680, 5, 100, 64): 44, (1536, 3, 100, 64): 14,
            (3072, 3, 64, 64): 29, (185, 3, 12, 16): 21, (20, 3, 12, 16): 20,
            (1, 3, 12, 16): 1}
    for shape, splits in rule.items():
        assert cr.dw_splits(*shape) == splits, shape


@pytest.mark.parametrize("t,b", [(60, 5), (5, 37), (2, 3)])
def test_plain_dw_partials_follow_the_split_rule(t, b):
    """The plain version, and the wrapper on CPU tensors, make one partial
    per split of the rule, each over its own pairs."""
    rng = np.random.RandomState(t * b)
    a = _ops(7, b, 1, seed=3)
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    args = (a, f(t, b, 7, 8), torch.sigmoid(f(t, b, 7, 16)), f(t, b, 7, 12),
            f(t, b, 7, 24))
    part = cr.dcgru_xin_dw_plain(*args)
    assert part.shape == (cr.dw_splits(t * b, 3, 12, 8),
                          cr.dw_size(3, 12, 8))
    torch.testing.assert_close(cr.dcgru_xin_dw(*args), part, rtol=0, atol=0)
    one = cr.dcgru_xin_dw_plain(*args, splits=1)[0]
    assert ((part.sum(0) - one).abs().max() / one.abs().max()).item() <= 1e-6


@functools.lru_cache(maxsize=None)
def _layer(num_supports, shared):
    """Numpy inputs of one layer and JAX's float32 gradients of
    sum(h_seq * wl) through the Pallas kernel's custom VJP (interpret
    mode)."""
    rng = np.random.RandomState(7 + num_supports + 2 * shared)
    m = num_supports * K + 1
    f = lambda *s, scale=0.1: (rng.randn(*s) * scale).astype(np.float32)
    L = dict(
        m=m, sup=(np.abs(rng.randn(num_supports, 1 if shared else B, N, N))
                  / N).astype(np.float32),
        x=f(T, B, N, D, scale=1.0), wxg=f(m * D, 2 * H), wxc=f(m * D, H),
        wg=f(m, H, 2 * H), wc=f(m, H, H), bg=f(2 * H), bc=f(H),
        h0=f(B, N, H), wl=f(T, B, N, H, scale=1.0))
    a_j = jax_ops(jnp.asarray(L["sup"]), K)

    def loss(op):
        _, hs = dcgru_layer_recurrence_pallas_xin(a_j, *op, "tanh", 2, True,
                                                  "float32")
        return jnp.sum(hs * L["wl"])

    grads = jax.grad(loss)(tuple(jnp.asarray(L[k]) for k in GRADS))
    return L, dict(zip(GRADS, map(np.asarray, grads)))


def _err(ours, ref):
    ours = ours.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12))


@pytest.mark.parametrize("num_supports,shared", [(1, False), (2, False),
                                                 (1, True), (2, True)])
@pytest.mark.parametrize("bf16", [False, True])
def test_dw_rounding_matches_pallas_grad(num_supports, shared, bf16):
    """dW and db as the kernel rounds them (the emulation), from the
    port's dpre, against jax.grad through _bwd_kernel_xin: bf16 streams
    (x, h_prev, ru rounded to bf16; G_m and r h_prev rounded) within the
    bf16 bound 2e-2, f32 within 1e-5."""
    L, jg = _layer(num_supports, shared)
    t = {k: torch.from_numpy(np.ascontiguousarray(L[k])) for k in GRADS}
    a = chebyshev_operators(torch.from_numpy(L["sup"]), K)
    xp = cr.dcgru_xin_proj_plain(t["x"], a, torch.cat([t["wxg"], t["wxc"]],
                                                      dim=1))
    h_seq, ru, c = cr.dcgru_xin_fwd_loop_plain(
        xp, a, t["wg"], t["wc"], t["bg"], t["bc"], t["h0"], residuals=True)
    h_prev = shift_h_prev(t["h0"], h_seq)
    dpre, _ = cr.dcgru_xin_bwd_loop_plain(a, t["wg"], t["wc"], h_prev, ru,
                                          c, torch.from_numpy(L["wl"]))
    stream = torch.bfloat16 if bf16 else torch.float32
    flat = dw_chain(a, h_prev.to(stream), ru.to(stream), t["x"].to(stream),
                    dpre, bf16)
    got = dict(zip(GRADS[1:7], cr._split_dw(flat, L["m"], D, H)))
    tol = 2e-2 if bf16 else 1e-5
    for k in GRADS[1:7]:
        assert _err(got[k], jg[k]) <= tol, (k, _err(got[k], jg[k]))
    if bf16:
        # the emulation rounds where the kernel does: it is not f32
        f32 = dw_chain(a, h_prev, ru, t["x"], dpre, False)
        assert not torch.equal(flat, f32)
