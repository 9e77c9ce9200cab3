"""The bulk projection and dx kernels' inputs and arithmetic
(``dcgru_xin_proj`` / ``dcgru_xin_dx``, ``csrc/dcgru_xin_gemm.cu``) on the
CPU:

- the operators the wrappers lay out as the kernels' tensor-core A
  fragments (``dw_op_frags``: A_m for the projection, A_m^T for dx, clip
  major), decoded by the PTX fragment maps of ``mma.m16n8k16`` (bf16) and
  ``mma.m16n8k8`` (tf32, split into hi and lo), hold every clip's
  operator;
- the weights the wrappers stage as B fragments (``xin_weight_frags``:
  Wx_m for the projection, Wx_m^T for dx), decoded by the same maps, hold
  every Wx_m, staged alike from [Wxg | Wxc] joined or from its two blocks;
- the kernels' rounding, emulated (``tests/chain_emulation.py``:
  ``proj_chain``, F_m = A_m x in one bf16 pass rounded to bf16 times bf16
  Wx_m; ``dx_chain``, G_m = A_m^T dpre likewise times bf16 Wx_m^T), against
  the JAX package in interpret mode: the projection through
  ``dcgru_layer_recurrence_pallas_xin``'s h_seq (the port's plain state
  loop after it), dx through the x gradient of ``_bwd_kernel_xin``; bf16
  within 2e-2 (normalized inf-norm), f32 within 1e-5 (the same f32
  arithmetic summed in another order).

Sizes: T=6, B=3, N=19, H=8, D=12 (the JAX comparison); N=7, 19 and 32,
D=12, 64 and 100, M=3 and 5, a_batch 1 and B for the layouts. The kernels
are held against these on the card by tests/test_torch_cuda.py.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chain_emulation import dx_chain, proj_chain
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


def _decode_a(frags, n, bf16):
    """A (lead..., 16 RT, depth KT) stack from A fragments: bf16 lane
    4g + t holds (g, 2t..2t+1), (g+8, ..), (g, 2t+8..), (g+8, 2t+8..);
    tf32 lane 4g + t holds (g, t), (g+8, t), (g, t+4), (g+8, t+4), hi and
    lo summed."""
    lead = frags.shape[:2]
    rt = -(-n // 16)
    g = torch.arange(8)[:, None]
    t = torch.arange(4)[None, :]
    if bf16:
        kt = -(-n // 16)
        f = frags.float().reshape(*lead, rt, kt, 8, 4, 4, 2)
        out = torch.zeros(*lead, 16 * rt, 16 * kt)
        for r in range(rt):
            for k in range(kt):
                for reg in range(4):
                    for e in range(2):
                        out[..., 16 * r + g + 8 * (reg & 1),
                            16 * k + 2 * t + e + 8 * (reg >> 1)] = \
                            f[..., r, k, :, :, reg, e]
        return out
    kt = -(-n // 8)
    f = frags.reshape(*lead, rt, kt, 2, 8, 4, 4)
    hi, lo = f[..., 0, :, :, :], f[..., 1, :, :, :]
    assert torch.equal(hi, cr.round_tf32(hi))  # hi holds TF32's bits only
    out = torch.zeros(*lead, 16 * rt, 8 * kt)
    for r in range(rt):
        for k in range(kt):
            for w in range(4):
                out[..., 16 * r + g + 8 * (w & 1), 8 * k + t + 4 * (w >> 1)] = \
                    (hi + lo)[..., r, k, :, :, w]
    return out


def _decode_b(frags, bf16):
    """(M, 16 KT or 8 KT, 8 NT) from the staged B operands: bf16 fragments
    (M, KT, NT, 32, 4), lane 4g + t holding rows 2t, 2t+1 (b0) and 2t+8,
    2t+9 (b1) of column g; f32 wgmma planes (M, KT, 2, NT, 2, 8, 4), hi
    then lo, group j's core matrix h holding column 8j + r's rows 4h..4h+3
    (hi + lo)."""
    if not bf16:
        m, kt, _, nt = frags.shape[:4]
        hi, lo = frags[:, :, 0], frags[:, :, 1]
        assert torch.equal(hi, cr.round_tf32(hi))  # hi holds TF32's bits only
        # [m, kt, j, h, r, c] -> row 8 kt + 4 h + c, column 8 j + r
        return (hi + lo).permute(0, 1, 3, 5, 2, 4).reshape(m, 8 * kt, 8 * nt)
    m, kt, nt = frags.shape[:3]
    g = torch.arange(8)[:, None]
    t = torch.arange(4)[None, :]
    f = frags.float().reshape(m, kt, nt, 8, 4, 4)
    out = torch.zeros(m, 16 * kt, 8 * nt)
    for k in range(kt):
        for j in range(nt):
            for el in range(4):
                row = 16 * k + 2 * t + (el & 1) + 8 * (el >> 1)
                out[:, row, 8 * j + g] = f[:, k, j, :, :, el]
    return out


@pytest.mark.parametrize("n", [7, 19, 32])
@pytest.mark.parametrize("num_supports,b", [(1, 3), (2, 1)])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_op_frags_hold_each_clip_operator(n, num_supports, b, transpose,
                                          bf16):
    """A_m (the projection's) or A_m^T (dx's), clip major as the bulk
    kernels take them: every clip's operator, zero past N."""
    a = _ops(n, b, num_supports, seed=n + b)
    m = a.shape[0]
    frags = cr.dw_op_frags(a, bf16, transpose=transpose, batch_major=True)
    assert frags.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert frags.shape[:2] == (b, m - 1) and frags.is_contiguous()
    got = _decode_a(frags, n, bf16)
    want = a[1:].transpose(0, 1)
    if transpose:
        want = want.transpose(-1, -2)
    if bf16:
        want = want.to(torch.bfloat16).float()
    assert torch.equal(got[..., :n, :n], want)  # hi + lo is exact
    assert not got[..., n:, :].any() and not got[..., :, n:].any()
    # the clip-major layout is the dW kernel's with the first axes swapped
    assert torch.equal(frags, cr.dw_op_frags(a, bf16, transpose)
                       .transpose(0, 1).contiguous())


@pytest.mark.parametrize("d", [12, 64, 100])
@pytest.mark.parametrize("h", [8, 64])
@pytest.mark.parametrize("m", [3, 5])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_weight_frags_hold_wx(d, h, m, transpose, bf16):
    """Wx_m (D x 3H; the projection) or Wx_m^T (3H x D; dx) of every m,
    zero-padded to whole k and n8 tiles, from [Wxg | Wxc] joined or from
    its two blocks (the same bits)."""
    rng = np.random.RandomState(d + h + m)
    wxg = torch.from_numpy(rng.randn(m * d, 2 * h).astype(np.float32))
    wxc = torch.from_numpy(rng.randn(m * d, h).astype(np.float32))
    wx = torch.cat([wxg, wxc], dim=1)
    frags = cr.xin_weight_frags((wxg, wxc), m, transpose, bf16)
    assert torch.equal(frags, cr.xin_weight_frags((wx,), m, transpose, bf16))
    k, c = (3 * h, d) if transpose else (d, 3 * h)
    if bf16:
        assert frags.shape == (m, -(-k // 16), -(-c // 8), 32, 4)
    else:
        assert frags.shape == (m, -(-k // 8), 2, -(-c // 8), 2, 8, 4)
    assert frags.dtype == (torch.bfloat16 if bf16 else torch.float32)
    got = _decode_b(frags, bf16)
    want = wx.reshape(m, d, 3 * h)
    if transpose:
        want = want.transpose(1, 2)
    if bf16:
        want = want.to(torch.bfloat16).float()
    assert torch.equal(got[:, :k, :c], want)
    assert not got[:, k:, :].any() and not got[:, :, c:].any()


@pytest.mark.parametrize("n", [7, 19, 32])
@pytest.mark.parametrize("num_supports,b", [(1, 3), (2, 1)])
@pytest.mark.parametrize("transpose", [False, True])
def test_op_rows_hold_each_clip_operator(n, num_supports, b, transpose):
    """The f32 kernels' operators (``xin_op_rows``: Op_m^T, row j holding
    Op_m[n, j] for the nodes n, Op_m = A_m for the projection and A_m^T
    for dx), clip major: every clip's operator, zero past N in whole
    blocks of 4 nodes."""
    a = _ops(n, b, num_supports, seed=3 * n + b)
    m = a.shape[0]
    rows = cr.xin_op_rows(a, transpose)
    assert rows.dtype == torch.float32 and rows.is_contiguous()
    assert rows.shape == (b, m - 1, n, 4 * -(-n // 4))
    op = a[1:].transpose(0, 1)
    if transpose:
        op = op.transpose(-1, -2)
    assert torch.equal(rows[..., :n], op.transpose(-1, -2))
    assert not rows[..., n:].any()


@pytest.mark.parametrize("transpose", [False, True])
def test_weight_frags_at_the_cells_shape(transpose):
    """The f32 staging at the benchmark cells' first layer (D=100, H=64,
    M=3): the projection's 3H = 192 columns as 24 groups an m and k8 step
    (13 of them), dx's D = 100 (104 padded) as 13 groups an m and k8 step
    (24 of them), each group's hi and lo planes holding Wx_m exactly."""
    d, h, m = 100, 64, 3
    rng = np.random.RandomState(7)
    wxg = torch.from_numpy(rng.randn(m * d, 2 * h).astype(np.float32))
    wxc = torch.from_numpy(rng.randn(m * d, h).astype(np.float32))
    frags = cr.xin_weight_frags((wxg, wxc), m, transpose, False)
    k, c = (3 * h, d) if transpose else (d, 3 * h)
    assert frags.shape == (m, -(-k // 8), 2, -(-c // 8), 2, 8, 4)
    want = torch.cat([wxg, wxc], dim=1).reshape(m, d, 3 * h)
    if transpose:
        want = want.transpose(1, 2)
    got = _decode_b(frags, False)
    assert torch.equal(got[:, :k, :c], want)
    assert not got[:, k:, :].any() and not got[:, :, c:].any()


@pytest.mark.parametrize("bf16", [False, True])
def test_wrappers_take_the_weight_blocks_on_the_cpu(bf16):
    """On CPU tensors the wrappers give the plain versions' results, from
    [Wxg | Wxc] joined or as the pair (Wxg, Wxc)."""
    rng = np.random.RandomState(4)
    stream = torch.bfloat16 if bf16 else torch.float32
    a = _ops(N, B, 2, seed=5)
    m = a.shape[0]
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    x, wxg, wxc, dpre = f(T, B, N, D).to(stream), f(m * D, 2 * H), \
        f(m * D, H), f(T, B, N, 3 * H)
    wx = torch.cat([wxg, wxc], dim=1)
    want = cr.dcgru_xin_proj_plain(x, a, wx)
    for w in (wx, (wxg, wxc)):
        assert torch.equal(cr.dcgru_xin_proj(x, a, w), want)
    want = cr.dcgru_xin_dx_plain(a, wx, dpre, stream)
    for w in (wx, (wxg, wxc)):
        assert torch.equal(cr.dcgru_xin_dx(a, w, dpre, stream), want)
    with pytest.raises(ValueError, match="not \\(M\\*D, w\\)"):
        cr.dcgru_xin_proj(x, a, (wxg, wxc[:-1]))


@functools.lru_cache(maxsize=None)
def _layer(num_supports, shared):
    """Numpy inputs of one layer, JAX's float32 h_seq and its gradients of
    sum(h_seq * wl) through the Pallas kernels' custom VJP (interpret
    mode)."""
    rng = np.random.RandomState(11 + num_supports + 2 * shared)
    m = num_supports * K + 1
    f = lambda *s, scale=0.1: (rng.randn(*s) * scale).astype(np.float32)
    L = dict(
        m=m, sup=(np.abs(rng.randn(num_supports, 1 if shared else B, N, N))
                  / N).astype(np.float32),
        x=f(T, B, N, D, scale=1.0), wxg=f(m * D, 2 * H), wxc=f(m * D, H),
        wg=f(m, H, 2 * H), wc=f(m, H, H), bg=f(2 * H), bc=f(H),
        h0=f(B, N, H), wl=f(T, B, N, H, scale=1.0))
    a_j = jax_ops(jnp.asarray(L["sup"]), K)

    def run(op):
        return dcgru_layer_recurrence_pallas_xin(a_j, *op, "tanh", 2, True,
                                                 "float32")[1]

    op = tuple(jnp.asarray(L[k]) for k in GRADS)
    h_seq = np.asarray(run(op))
    grads = jax.grad(lambda o: jnp.sum(run(o) * L["wl"]))(op)
    return L, h_seq, dict(zip(GRADS, map(np.asarray, grads)))


def _err(ours, ref):
    ours = ours.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12))


CASES = [(1, False), (2, False), (1, True), (2, True)]


@pytest.mark.parametrize("num_supports,shared", CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_proj_rounding_matches_pallas_h_seq(num_supports, shared, bf16):
    """The projection as the kernel rounds it (the emulation; bf16 x), fed
    to the port's plain f32 state loop, against h_seq of the JAX layer
    through _fwd_kernel_xin: bf16 within 2e-2, f32 within 1e-5."""
    L, h_ref, _ = _layer(num_supports, shared)
    t = {k: torch.from_numpy(np.ascontiguousarray(L[k])) for k in GRADS}
    a = chebyshev_operators(torch.from_numpy(L["sup"]), K)
    wx = torch.cat([t["wxg"], t["wxc"]], dim=1)
    stream = torch.bfloat16 if bf16 else torch.float32
    xp = proj_chain(a, t["x"].to(stream), wx, bf16)
    h_seq, _, _ = cr.dcgru_xin_fwd_loop_plain(
        xp, a, t["wg"], t["wc"], t["bg"], t["bc"], t["h0"])
    tol = 2e-2 if bf16 else 1e-5
    assert _err(h_seq, h_ref) <= tol, _err(h_seq, h_ref)
    if bf16:
        # the emulation rounds where the kernel does: it is not f32
        assert not torch.equal(xp, proj_chain(a, t["x"], wx, False))


@pytest.mark.parametrize("num_supports,shared", CASES)
@pytest.mark.parametrize("bf16", [False, True])
def test_dx_rounding_matches_pallas_grad(num_supports, shared, bf16):
    """dx as the kernel rounds it (the emulation), from the port's dpre,
    against jax.grad's x cotangent through _bwd_kernel_xin: bf16 (G_m and
    dpre rounded to bf16, dx in bf16) within 2e-2, f32 within 1e-5."""
    L, _, jg = _layer(num_supports, shared)
    t = {k: torch.from_numpy(np.ascontiguousarray(L[k])) for k in GRADS}
    a = chebyshev_operators(torch.from_numpy(L["sup"]), K)
    wx = torch.cat([t["wxg"], t["wxc"]], dim=1)
    xp = cr.dcgru_xin_proj_plain(t["x"], a, wx)
    h_seq, ru, c = cr.dcgru_xin_fwd_loop_plain(
        xp, a, t["wg"], t["wc"], t["bg"], t["bc"], t["h0"], residuals=True)
    dpre, _ = cr.dcgru_xin_bwd_loop_plain(
        a, t["wg"], t["wc"], shift_h_prev(t["h0"], h_seq), ru, c,
        torch.from_numpy(L["wl"]))
    stream = torch.bfloat16 if bf16 else torch.float32
    dx = dx_chain(a, wx, dpre, stream, bf16)
    assert dx.dtype == stream
    tol = 2e-2 if bf16 else 1e-5
    assert _err(dx, jg["x"]) <= tol, _err(dx, jg["x"])
    if bf16:
        assert not torch.equal(dx.float(),
                               dx_chain(a, wx, dpre, torch.float32, False))
