"""The port's correlation graph (``graphs/xcorr.py``) and SDDMM
(``ops/sddmm.py``) against the JAX package's on the CPU: the host oracle,
the batched Gram version with ties, top-k directed and undirected; the
edge-list SDDMM, the block bucketing, the block-sparse kernel's plain
version against the Pallas kernel run by the Mosaic interpreter
(``sddmm_blocksparse(..., interpret=True)``, including the zero rows past
N) and the edge-list front door with normalization, at the sizes of
tests/test_sddmm.py.

Tolerance 1e-5 (f32 dot products of at most a few hundred terms summed in
another order); the host oracles are the same float64 code and match
exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eeg_gnn_tpu.graphs import xcorr as jx
from eeg_gnn_tpu.ops import sddmm as jsd
from eeg_gnn_tpu_torch.graphs import xcorr as tx
from eeg_gnn_tpu_torch.ops import sddmm as tsd


def _random_topology(rng, n, k):
    """Directed top-k-like edge list without self loops
    (tests/test_sddmm.py)."""
    rows = np.repeat(np.arange(n), k)
    cols = np.concatenate(
        [rng.choice(np.delete(np.arange(n), i), size=k, replace=False)
         for i in range(n)])
    return rows.astype(np.int32), cols.astype(np.int32)


def _clip_with_ties(rng, b=3, t=8, n=19, d=5):
    """Integer-valued clips (every dot product exact in float32) whose
    channels 3 and 7 copy channel 1 and whose channel 11 is silent: exactly
    equal correlations (ties for top-k) and a zero-energy row."""
    clip = rng.randint(-2, 3, size=(b, t, n, d)).astype(np.float32)
    clip[:, :, 3] = clip[:, :, 1]
    clip[:, :, 7] = clip[:, :, 1]
    clip[:, :, 11] = 0.0
    return clip


# ---------------------------------------------------------------------------
# graphs/xcorr.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("top_k,apply_swap", [(3, False), (3, True),
                                              (None, False)])
def test_host_oracle_matches_jax(rng, top_k, apply_swap):
    clip = _clip_with_ties(rng, b=1)[0]
    swaps = [(0, 5), (2, 9)]
    got = tx.correlation_adjacency(clip, top_k, swaps, apply_swap)
    want = jx.correlation_adjacency(clip, top_k, swaps, apply_swap)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    flat = clip.transpose(1, 0, 2).reshape(19, -1).astype(np.float64)
    for a, b in ((flat[0], flat[1]), (flat[0], flat[11])):
        assert tx.comp_xcorr_zero_lag(a, b) == jx.comp_xcorr_zero_lag(a, b)


@pytest.mark.parametrize("top_k", [3, None])
def test_batched_adjacency_matches_jax(rng, top_k):
    """The batched Gram version against JAX's and against the host oracle,
    on clips with tied correlations and a zero-energy channel."""
    clip = _clip_with_ties(rng)
    got = tx.correlation_adjacency_torch(torch.from_numpy(clip), top_k)
    want = np.asarray(jx.correlation_adjacency_jnp(jnp.asarray(clip), top_k))
    assert got.shape == want.shape == (3, 19, 19)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.numpy() != 0, want != 0)
    # the host oracle's top-k argsort is not stable, so on these ties it
    # is compared dense
    dense = tx.correlation_adjacency_torch(torch.from_numpy(clip), None)
    for c, a in zip(clip, dense.numpy()):
        np.testing.assert_allclose(a, tx.correlation_adjacency(c, None),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("directed", [True, False])
def test_keep_topk_matches_jax(rng, directed):
    """Host and batched top-k against JAX's; the ties of a quantized
    matrix go to the lowest column index."""
    adj = np.round(rng.rand(4, 19, 19) * 4) / 4  # many exact ties
    adj = adj.astype(np.float32)
    for a in adj:
        np.testing.assert_array_equal(
            tx.keep_topk(a, 3, directed), jx.keep_topk(a, 3, directed))
    got = tx.keep_topk_torch(torch.from_numpy(adj), 3, directed)
    want = np.asarray(jx.keep_topk_jnp(jnp.asarray(adj), 3, directed))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# ops/sddmm.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("normalize", [False, True])
def test_sddmm_edges_matches_jax(rng, normalize):
    n, d = 37, 96
    x = rng.randn(n, d).astype(np.float32)
    y = rng.randn(n, d).astype(np.float32)
    x[4] = 0.0  # zero-energy row: normalization is skipped
    rows, cols = _random_topology(rng, n, 3)
    got = tsd.sddmm_edges(rows, cols, torch.from_numpy(x),
                          torch.from_numpy(y), normalize)
    want = np.asarray(jsd.sddmm_edges(rows, cols, x, y, normalize))
    assert got.shape == (n * 3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,block", [(300, 128), (19, 128), (300, 64)])
def test_edges_to_blocks_matches_jax(rng, n, block):
    rows, cols = _random_topology(rng, n, 4)
    got = tsd.edges_to_blocks(rows, cols, n, block)
    want = jsd.edges_to_blocks(rows, cols, n, block)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,d", [(19, 60), (300, 200), (150, 77)])
def test_blocksparse_plain_matches_jax_kernel(rng, n, d):
    """Every occupied block, rows and columns past N included (zeros)."""
    x = rng.randn(n, d).astype(np.float32)
    y = rng.randn(n, d).astype(np.float32)
    rows, cols = _random_topology(rng, n, 3)
    br, bc, _, _ = tsd.edges_to_blocks(rows, cols, n)
    want = np.asarray(jsd.sddmm_blocksparse(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(br), jnp.asarray(bc),
        interpret=True))
    args = (torch.from_numpy(x), torch.from_numpy(y), br, bc)
    got = tsd.sddmm_blocksparse_plain(*args)
    assert got.shape == want.shape == (len(br), 128, 128)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    last = (n - 1) // 128  # a block that holds the rows past N
    pad = (br == last) | (bc == last)
    if n % 128:
        assert pad.any()
        np.testing.assert_array_equal(
            got.numpy()[br == last][:, n % 128:], 0.0)
        np.testing.assert_array_equal(
            got.numpy()[bc == last][:, :, n % 128:], 0.0)
    # on CPU tensors the wrapper is the plain version and counts nothing
    before = tsd.sddmm_blocksparse.launches
    torch.testing.assert_close(tsd.sddmm_blocksparse(*args), got, rtol=0,
                               atol=0)
    assert tsd.sddmm_blocksparse.launches == before


@pytest.mark.parametrize("n,d,normalize", [(19, 60, False),
                                           (300, 200, False),
                                           (150, 77, True)])
def test_edges_blocksparse_matches_jax(rng, n, d, normalize):
    x = rng.randn(n, d).astype(np.float32)
    y = x if normalize else rng.randn(n, d).astype(np.float32)
    rows, cols = _random_topology(rng, n, 3)
    want = np.asarray(jsd.sddmm_edges_blocksparse(
        rows, cols, jnp.asarray(x), jnp.asarray(y), n, normalize=normalize,
        interpret=True))
    got = tsd.sddmm_edges_blocksparse(rows, cols, torch.from_numpy(x),
                                      torch.from_numpy(y), n,
                                      normalize=normalize)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    edges = tsd.sddmm_edges(rows, cols, torch.from_numpy(x),
                            torch.from_numpy(y), normalize)
    np.testing.assert_allclose(got.numpy(), edges.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_rescored_edges_are_the_adjacency(rng):
    """Normalized SDDMM scores on a clip's top-k edges are the entries of
    its correlation adjacency (up to the abs)."""
    clip = rng.randn(6, 19, 10).astype(np.float32)
    adj = tx.correlation_adjacency_torch(torch.from_numpy(clip))
    flat = torch.from_numpy(clip).transpose(0, 1).reshape(19, -1)
    rows, cols = np.nonzero(adj.numpy() * (1 - np.eye(19)))
    vals = tsd.sddmm_edges_blocksparse(rows, cols, flat, flat, 19,
                                       normalize=True)
    np.testing.assert_allclose(vals.abs().numpy(), adj.numpy()[rows, cols],
                               rtol=1e-5, atol=1e-5)


def _tf32(v):
    """The kernel's ``round_tf32``: finite float32 rounded to TF32's 10
    mantissa bits, to nearest, ties away from zero (``cvt.rna.tf32.f32``)."""
    bits = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _tf32_cut(v):
    """float32 bits read as a TF32 operand: the 10 mantissa bits kept, the
    rest cut (toward zero), as the kernel passes lo in."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _chunked_f32_sum(terms, d, shape, chunk=32):
    """Sum ``terms(k)`` over k < d as the kernel does: f32 adds into an
    accumulator that is added into an f32 sum, and restarted, after every
    ``chunk`` of k (one K slice of the kernel)."""
    total = np.zeros(shape, np.float32)
    acc = np.zeros(shape, np.float32)
    for k in range(d):
        for t in terms(k):
            acc = (acc + t).astype(np.float32)
        if (k + 1) % chunk == 0 or k == d - 1:
            total = (total + acc).astype(np.float32)
            acc[:] = 0.0
    return total


def test_3xtf32_keeps_f32_accuracy_at_the_rescore_depth():
    """The precision argument of the tensor-core SDDMM (csrc/sddmm.cu),
    emulated in numpy on 64 re-score rows of D=6000 against their float64
    Gram: x = hi + lo, hi rounded to TF32 and lo = x - hi cut to TF32 (as
    the tensor cores read it); hi*hi + hi*lo + lo*hi (each product exact
    in f32) summed in f32 per 32-wide K slice and the slices into an f32
    sum. It stays within 1e-5 normalized, as close as an f32 FMA sum over
    k; one TF32 pass (hi*hi) is an order of magnitude off. (The tensor
    cores' own f32 adds do not round to nearest; the kernel's slice sums
    keep each such run short.)"""
    rng = np.random.RandomState(0)
    x = rng.randn(64, 6000).astype(np.float32)
    n, d = x.shape
    exact = x.astype(np.float64) @ x.astype(np.float64).T
    hi = _tf32(x)
    lo = _tf32_cut(x - hi)
    outer = lambda u, v, k: np.outer(u[:, k], v[:, k]).astype(np.float32)
    three = _chunked_f32_sum(lambda k: (outer(lo, hi, k), outer(hi, lo, k),
                                        outer(hi, hi, k)), d, (n, n))
    one = _chunked_f32_sum(lambda k: (outer(hi, hi, k),), d, (n, n))
    fma = np.zeros((n, n), np.float32)
    for k in range(d):  # one rounding per step: fmaf
        fma = (fma + np.outer(x[:, k].astype(np.float64), x[:, k])).astype(
            np.float32)
    err = lambda v: float(np.abs(v - exact).max() / np.abs(exact).max())
    assert err(three) <= 1e-5
    assert err(three) <= err(fma)
    assert err(one) > 10 * err(three)


def test_blocksparse_wrapper_raises_off_cpu_and_cuda():
    x = torch.zeros(19, 8, device="meta")
    with pytest.raises(ValueError, match="neither on the CPU nor"):
        tsd.sddmm_blocksparse(x, x, np.zeros(1, np.int32),
                              np.zeros(1, np.int32))
