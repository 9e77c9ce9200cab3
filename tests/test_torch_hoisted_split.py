"""The hoisted layer's BPTT (``dcgru_recurrence_bwd``) as the port runs it
on the card, in plain PyTorch on the CPU: the state loop without dW
(``dcgru_xin_bwd_loop_plain``), the bulk dW split partials at D = 0
(``dcgru_xin_dw_plain`` fed a zero-width x: the layer has no input x),
their reduction and dx_proj = dpre cast to the stream dtype; against the
JAX package's ``_backward`` (``eeg_gnn_tpu/ops/pallas_recurrent.py:462``)
run in interpret mode through its custom VJP's backward, on the same
numpy inputs and the JAX forward's own residuals.

Tolerances: normalized inf-norm error max|port - jax| / max|jax|
<= 1e-5 in float32 (the same f32 arithmetic summed in another order);
the bf16 kernels' rounding, emulated (``tests/chain_emulation.py``: the
loop's bf16 products, then G_m = A_m^T dpre and r h_prev rounded to
bf16), against JAX in float32 <= 2e-2 (the bf16 bound of
benchmarks/tpu_kernel_parity.json).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chain_emulation import chain_bwd, dw_chain
from eeg_gnn_tpu.ops.pallas_recurrent import _vjp_bwd, _vjp_fwd
from eeg_gnn_tpu.ops.recurrent import chebyshev_operators as jax_ops
from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr
from eeg_gnn_tpu_torch.ops.recurrent import chebyshev_operators, shift_h_prev

F32_TOL, BF16_TOL = 1e-5, 2e-2
GRADS = ("dxp", "dwg", "dwc", "dbg", "dbc", "dh0")

# (N, S, K, shared graph, T, B, H): M = S*K + 1 = 1, 3 and 5; ragged and
# detector-sized node counts; per-clip and shared graphs
CASES = [
    (7, 1, 0, False, 3, 3, 8),
    (19, 1, 2, False, 4, 3, 16),
    (19, 1, 2, True, 5, 2, 12),
    (7, 2, 2, False, 3, 4, 16),
    (19, 2, 2, True, 4, 3, 8),
]


def _err(got, want):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@functools.lru_cache(maxsize=None)
def _case(n, s, k, shared, t, b, h):
    """Numpy inputs (seeded), the JAX forward's residuals handed to the
    port, and JAX's _backward results (interpret mode) in float32."""
    rng = np.random.RandomState(n * 100 + s * 10 + k + t + h)
    m = s * k + 1
    f = lambda *sh, scale=0.1: (rng.randn(*sh) * scale).astype(np.float32)
    sup = (np.abs(rng.randn(s, 1 if shared else b, n, n)) / n).astype(
        np.float32)
    wg, wc, bg, bc = f(m, h, 2 * h), f(m, h, h), f(2 * h), f(h)
    h0, xp = f(b, n, h), f(t, b, n, 3 * h, scale=0.5)
    d_seq, d_last = f(t, b, n, h, scale=1.0), f(b, n, h, scale=1.0)
    a_j = jax_ops(jnp.asarray(sup), k)
    (_, h_seq), res = _vjp_fwd(a_j, jnp.asarray(xp), *map(jnp.asarray, (
        wg, wc, bg, bc, h0)), "tanh", 2, True, "float32")
    _, dxp, dwg, dwc, dbg, dbc, dh0 = _vjp_bwd(
        "tanh", 2, True, "float32", res,
        (jnp.asarray(d_last), jnp.asarray(d_seq)))
    want = dict(zip(GRADS, map(np.asarray, (dxp, dwg, dwc, dbg, dbc, dh0))))
    # the port's inputs: the same residuals (ru, c from the JAX forward's
    # trimmed streams), h_prev = [h0, h_seq[:-1]], d_seq with d_last added
    a_ops = chebyshev_operators(torch.from_numpy(sup), k).contiguous()
    t_ = lambda v: torch.from_numpy(np.array(v, np.float32))
    dims = res[-1]
    _, b_, n_, np_, tb, g, _ = dims
    trim = lambda v: np.asarray(v).reshape(t, g * tb, np_, -1)[:, :b_, :n_]
    ru, c = t_(trim(res[5])), t_(trim(res[6]))
    d_all = d_seq.copy()
    d_all[-1] += d_last
    port = dict(a_ops=a_ops, wg=t_(wg), wc=t_(wc),
                h_prev=shift_h_prev(t_(h0), t_(np.asarray(h_seq))), ru=ru,
                c=c, d_seq=t_(d_all), m=m, h=h)
    return port, want


def _composite_plain(p, stream):
    """The composite's pieces, plain, in the stream dtype: loop, dW at
    D = 0, reduction, cast."""
    streams = [p[k].to(stream) for k in ("h_prev", "ru", "c", "d_seq")]
    dpre, dh0 = cr.dcgru_xin_bwd_loop_plain(p["a_ops"], p["wg"], p["wc"],
                                            *streams)
    t, b, n, _ = streams[0].shape
    x0 = streams[0].new_empty((t, b, n, 0))
    part = cr.dcgru_xin_dw_plain(p["a_ops"], streams[0], streams[1], x0,
                                 dpre)
    assert part.shape == (cr.dw_splits(t * b, p["m"], 0, p["h"]),
                          cr.dw_size(p["m"], 0, p["h"]))
    _, _, dwg, dwc, dbg, dbc = cr._split_dw(cr.dcgru_dw_reduce_plain(part),
                                            p["m"], 0, p["h"])
    return dict(zip(GRADS, (dpre.to(stream), dwg, dwc, dbg, dbc, dh0)))


@pytest.mark.parametrize("case", CASES)
def test_composite_plain_matches_jax_backward(case):
    """The composite's plain pieces in float32 against JAX ``_backward``
    (interpret): dx_proj, dWg, dWc, dbg, dbc and dh0 within 1e-5."""
    port, want = _case(*case)
    got = _composite_plain(port, torch.float32)
    assert got["dxp"].dtype == torch.float32
    errs = {k: _err(got[k], want[k]) for k in GRADS}
    assert max(errs.values()) <= F32_TOL, errs


@pytest.mark.parametrize("case", CASES[1:4])
def test_composite_plain_matches_the_whole_plain_bwd(case):
    """The pieces give what the wrapper's own plain version gives (the
    reverse loop with dW inside it), which the CPU wrapper returns."""
    port, _ = _case(*case)
    args = (port["a_ops"], port["wg"], port["wc"], port["h_prev"],
            port["ru"], port["c"], port["d_seq"])
    whole = cr.dcgru_recurrence_bwd(*args)
    got = _composite_plain(port, torch.float32)
    for name, w in zip(GRADS, whole):
        torch.testing.assert_close(got[name], w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", CASES[1:3])
def test_d0_partials_sum_to_the_per_clip_slabs(case):
    """The D = 0 split partials, whatever the split count, sum to the sum
    of per-clip slabs [dWg | dWc | dbg | dbc] (each clip's dW over its T
    steps, the old kernel's layout); the default count is the kernel's
    split rule."""
    port, _ = _case(*case)
    a, h_prev, ru = port["a_ops"], port["h_prev"], port["ru"]
    dpre, _ = cr.dcgru_xin_bwd_loop_plain(a, port["wg"], port["wc"], h_prev,
                                          ru, port["c"], port["d_seq"])
    t, b, n, h = h_prev.shape
    x0 = h_prev.new_empty((t, b, n, 0))
    slabs = []
    for clip in range(b):
        ac = a if a.shape[1] == 1 else a[:, clip:clip + 1]
        sl = lambda v: v[:, clip:clip + 1]
        slabs.append(cr.dcgru_xin_dw_plain(ac, sl(h_prev), sl(ru),
                                           sl(x0), sl(dpre), splits=1)[0])
    per_clip = torch.stack(slabs)
    assert per_clip.shape == (b, cr.dw_size(port["m"], 0, h))
    want = per_clip.sum(0)
    for splits in (None, 1, 2, t * b):
        part = cr.dcgru_xin_dw_plain(a, h_prev, ru, x0, dpre, splits=splits)
        torch.testing.assert_close(part.sum(0), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", CASES[1:])
def test_bf16_rounding_of_the_d0_dw_matches_jax(case):
    """bf16 streams through the kernels' emulated arithmetic: the loop's
    bf16 products (``chain_bwd``), then dW at D = 0 with G_m = A_m^T dpre
    and r h_prev rounded to bf16 (``dw_chain``); dx_proj in bf16. Against
    JAX in float32 within 2e-2."""
    port, want = _case(*case)
    streams = [port[k].to(torch.bfloat16)
               for k in ("h_prev", "ru", "c", "d_seq")]
    dpre, dh0 = chain_bwd(port["a_ops"], port["wg"], port["wc"], *streams)
    t, b, n, h = streams[0].shape
    flat = dw_chain(port["a_ops"], streams[0], streams[1],
                    streams[0].new_empty((t, b, n, 0)), dpre, bf16=True)
    _, _, dwg, dwc, dbg, dbc = cr._split_dw(flat, port["m"], 0, h)
    got = dict(zip(GRADS, (dpre.to(torch.bfloat16), dwg, dwc, dbg, dbc,
                           dh0)))
    errs = {k: _err(got[k], want[k]) for k in GRADS}
    assert max(errs.values()) <= BF16_TOL, errs
