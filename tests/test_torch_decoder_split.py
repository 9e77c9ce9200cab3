"""The decoder BPTT split as the card runs it (the state loop, the bulk
x-in dW kernel once for layer 0 and once for the tied cell over the
stacked layers, and the dWp kernel; ``eeg_gnn_tpu_torch/ops/
cuda_decoder.py``), in its plain versions, against the JAX package's
decoder Pallas kernels run in interpret mode (``_decoder_pallas(...,
interpret=True)``, whose backward is ``_bwd_kernel_dec``).

The loop's dpre and dproj are held through every gradient they make:
the cells' dW and db (dpre fed to the bulk dW product's split partials,
summed), dWp and dbp (dproj fed to the dWp split partials, summed); dx and
dh0 come from the loop itself. Then: the tied cell's dW over the stacked
layers is the sum of its per-layer dW; the composed pieces equal the
plain composite ``dcgru_decoder_bwd_plain``; and the new wrappers'
CPU/CUDA dispatch.

Sizes: T_out=4, B=3, N=19, H=8, D=12; L in {1, 2, 3}, M in {3, 5},
per-clip and shared graphs, forces none / mixed / all. Tolerance: float32,
normalized inf-norm error max|ours - ref| / max|ref| <= 1e-5 (the same
f32 arithmetic summed in another order). The kernels themselves are held
against these plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_gnn_tpu.models.dcgru import _decoder_pallas
from eeg_gnn_tpu.models.dcgru import decoder_init as jax_decoder_init
from eeg_gnn_tpu.ops.recurrent import chebyshev_operators as jax_cheb
from eeg_gnn_tpu_torch.models import dcgru as tdcgru
from eeg_gnn_tpu_torch.ops import cuda_decoder as cd
from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr
from eeg_gnn_tpu_torch.ops.recurrent import chebyshev_operators

T_OUT, B, N, H, D, K = 4, 3, 19, 8, 12, 2
TOL = 1e-5
FORCES = {"none": np.zeros(T_OUT), "all": np.ones(T_OUT),
          "mixed": (np.arange(T_OUT) % 2).astype(float)}
# the 14 weight and bias gradients, in decoder_kernel_weights' order
WEIGHTS = ("wx0g", "wx0c", "wh0g", "wh0c", "b0g", "b0c", "wxsg", "wxsc",
           "whsg", "whsc", "bsg", "bsc", "wp", "bp")


def _err(ours, ref):
    ours = ours.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-12))


@functools.lru_cache(maxsize=None)
def _case(num_layers, num_supports, shared, force_pat):
    """Seeded numpy inputs with JAX's float32 output (``proj``), and its
    gradients of sum(out * wl) through ``_decoder_pallas`` in interpret
    mode, re-packed into the kernels' layout by the port's
    ``decoder_kernel_weights`` (a permutation, so gradients map as weights
    do)."""
    seed = 100 * num_layers + 10 * num_supports + 2 * shared + len(force_pat)
    rng = np.random.RandomState(seed)
    params, cfgs = jax_decoder_init(jax.random.PRNGKey(seed), D, H, K, N,
                                    num_supports, num_layers, D, "tanh")
    params = jax.tree_util.tree_map(np.asarray, params)
    cfgs = tuple(dataclasses.replace(c, batch_tile=4) for c in cfgs)
    shape = (num_supports, 1 if shared else B, N, N)
    sup = (np.abs(rng.randn(*shape)) / N).astype(np.float32)
    dec = rng.randn(T_OUT, B, N, D).astype(np.float32)
    h0 = (rng.randn(num_layers, B, N, H) * 0.1).astype(np.float32)
    wl = rng.randn(T_OUT, B, N, D).astype(np.float32)
    force = FORCES[force_pat].astype(np.float32)
    a_j = jax.lax.stop_gradient(jax_cheb(jnp.asarray(sup), K))
    fn = lambda p, d, h: _decoder_pallas(
        cfgs[0], cfgs[1], p, a_j, d, jnp.asarray(force), h, num_layers,
        p["proj_w"].T, interpret=True)
    op = jax.tree_util.tree_map(jnp.asarray, (params, dec, h0))
    grads = jax.grad(lambda o: jnp.sum(fn(*o) * wl))(op)
    g_params, g_dec, g_h0 = jax.tree_util.tree_map(np.asarray, grads)
    cfg0 = tdcgru.DCGRUConfig(D, H, K, N, num_supports)
    to_t = lambda tree: jax.tree_util.tree_map(torch.from_numpy, tree)
    want = dict(zip(WEIGHTS, tdcgru.decoder_kernel_weights(
        cfg0, to_t(g_params), num_layers)))
    want.update(dx=g_dec, dh0=g_h0)
    inputs = dict(params=to_t(params), sup=sup, dec=dec, h0=h0, wl=wl,
                  force=force, cfg0=cfg0, proj=np.asarray(fn(*op)))
    return inputs, {k: None if v is None else np.asarray(v)
                    for k, v in want.items()}


def _port(inputs, num_layers):
    """The port's operators and packed weights, the plain forward's
    residuals and the plain loop's outputs."""
    a_ops = chebyshev_operators(torch.from_numpy(inputs["sup"]), K)
    a_ops = a_ops.contiguous()
    w = tdcgru.decoder_kernel_weights(inputs["cfg0"], inputs["params"],
                                      num_layers)
    force = torch.from_numpy(inputs["force"])
    h0 = torch.from_numpy(inputs["h0"])
    _, in0, h_seq, ru, c = cd.dcgru_decoder_fwd_plain(
        a_ops, torch.from_numpy(inputs["dec"]), force, *w, h0, num_layers,
        residuals=True)
    h_prev = cd.decoder_h_prev(h0, h_seq)
    bwd_args = (a_ops, *w[0:4], *w[6:10], w[12], h_prev, h_seq, ru, c, in0,
                torch.from_numpy(inputs["wl"]), force, num_layers)
    loop_args, dw_cells, h_top = cd.decoder_bwd_pieces(*bwd_args)
    return dict(a_ops=a_ops, h_seq=h_seq, h_prev=h_prev, ru=ru,
                bwd_args=bwd_args, loop_args=loop_args, dw_cells=dw_cells,
                h_top=h_top, loop=cd.dcgru_dec_bwd_loop_plain(*loop_args))


def _cells(p):
    return p["dw_cells"](p["loop"][2])


def _split_grads(p, num_layers, splits=(5, 4, 3)):
    """Every gradient from the split pieces: the loop's dx and dh0, the
    bulk dW partials of layer 0 and of the stacked shared cell, the dWp
    partials, each summed."""
    dx, dh0, _, dproj = p["loop"]
    m = p["a_ops"].shape[0]
    out = dict(dx=dx, dh0=dh0)
    cells = _cells(p)
    assert len(cells) == min(num_layers, 2)
    for cell, names, d_in, sp in zip(cells, (WEIGHTS[:6], WEIGHTS[6:12]),
                                     (D, H), splits):
        part = cr.dcgru_xin_dw_plain(*cell, sp)
        assert part.shape == (sp, cr.dw_size(m, d_in, H))
        out.update(zip(names, cd._cell_grads(part.sum(0), m, d_in, H)))
    part = cd.dcgru_dec_dwp_plain(p["h_top"], dproj, splits[2])
    assert part.shape == (splits[2], H * D + D)
    flat = part.sum(0)
    out.update(wp=flat[:H * D].view(H, D), bp=flat[H * D:])
    return out


CASES = [(ll, s, shared, f) for ll in (1, 2, 3) for s in (1, 2)
         for shared in (False, True) for f in ("none", "mixed", "all")]


@pytest.mark.parametrize("num_layers,num_supports,shared,force_pat", CASES)
def test_split_pieces_match_pallas_grad(num_layers, num_supports, shared,
                                        force_pat):
    """dx and dh0 of the state loop, the cells' dW / db from its dpre and
    dWp / dbp from its dproj, against jax.grad through the decoder's
    Pallas kernels."""
    inputs, want = _case(num_layers, num_supports, shared, force_pat)
    p = _port(inputs, num_layers)
    _, _, dpre, dproj = p["loop"]
    assert dpre.dtype == dproj.dtype == torch.float32
    assert dpre.shape == (num_layers, T_OUT, B, N, 3 * H)
    assert dproj.shape == (T_OUT, B, N, D)
    got = _split_grads(p, num_layers)
    for k, w in want.items():
        if w is None:
            assert k not in got and num_layers == 1
            continue
        assert _err(got[k], w) <= TOL, (k, _err(got[k], w))


@pytest.mark.parametrize("num_supports,shared", [(1, False), (2, True)])
def test_tied_cell_dw_is_the_sum_over_its_layers(num_supports, shared):
    """The shared cell's dW from layers 1..L-1 stacked as (L-1)*T steps
    equals the sum of one dW product per layer (pair p of the stack is
    clip p % B, so each layer's rows meet their own operators)."""
    inputs, _ = _case(3, num_supports, shared, "mixed")
    p = _port(inputs, 3)
    dpre = p["loop"][2]
    a_ops = p["a_ops"]
    tied = _cells(p)[1]
    assert tied[1].shape == (2 * T_OUT, B, N, H)
    stacked = cr.dcgru_xin_dw_plain(*tied, 3).sum(0)
    per_layer = sum(cr.dcgru_xin_dw_plain(
        a_ops, p["h_prev"][li], p["ru"][li], p["h_seq"][li - 1],
        dpre[li], 1).sum(0) for li in (1, 2))
    assert _err(stacked, per_layer.numpy()) <= TOL


@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_composed_pieces_equal_the_plain_composite(num_layers):
    """The composite's CPU path is ``dcgru_decoder_bwd_plain``, which sums
    every dW inside its reverse loop; the split pieces composed as the
    CUDA path composes them give the same 16 results."""
    inputs, _ = _case(num_layers, 2, False, "mixed")
    p = _port(inputs, num_layers)
    args = p["bwd_args"]
    whole = cd.dcgru_decoder_bwd(*args)  # CPU tensors: the plain composite
    names = ("dx", "dh0") + WEIGHTS[:12] + ("wp", "bp")
    want = dict(zip(names, cd.dcgru_decoder_bwd_plain(*args)))
    got = _split_grads(p, num_layers, splits=(1, 1, 1))
    for k, v in zip(names, whole):
        if v is None:
            assert want[k] is None and k not in got
            continue
        torch.testing.assert_close(v, want[k], rtol=0, atol=0)
        assert _err(got[k], want[k].numpy()) <= TOL, k


def _wrapper_cases(num_layers=2):
    inputs, _ = _case(num_layers, 1, False, "mixed")
    p = _port(inputs, num_layers)
    _, _, _, dproj = p["loop"]
    return [
        (cd.dcgru_dec_bwd_loop, cd.dcgru_dec_bwd_loop_plain, p["loop_args"]),
        (cd.dcgru_dec_dwp, cd.dcgru_dec_dwp_plain, (p["h_top"], dproj)),
    ]


@pytest.mark.parametrize("case", range(2))
def test_new_wrappers_use_plain_on_cpu_and_do_not_count(case):
    kern, plain, args = _wrapper_cases()[case]
    before = kern.launches
    got, want = kern(*args), plain(*args)
    if isinstance(want, torch.Tensor):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert kern.launches == before


@pytest.mark.parametrize("case", range(2))
def test_new_wrappers_raise_off_cpu_without_cuda(case):
    """No silent fallback: a tensor that is not on the CPU goes to the
    kernel or raises (here: the meta device)."""
    kern, _, args = _wrapper_cases()[case]
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="neither on the CPU nor"):
        kern(*meta)


def test_dwp_splits_follow_the_rows_only():
    """dWp splits by a fixed 256 node rows on every device (bitwise stable
    across card models), and the split partials sum to the whole."""
    assert cd.dwp_splits(1) == 1 and cd.dwp_splits(256) == 1
    assert cd.dwp_splits(257) == 2
    assert cd.dwp_splits(12 * 128 * 19) == 114
    rng = np.random.RandomState(0)
    h_top = torch.from_numpy(rng.randn(3, 7, N, H).astype(np.float32))
    g = torch.from_numpy(rng.randn(3, 7, N, D).astype(np.float32))
    part = cd.dcgru_dec_dwp_plain(h_top, g)
    assert part.shape == (2, H * D + D)
    whole = cd.dcgru_dec_dwp_plain(h_top, g, 1)[0]
    assert _err(part.sum(0), whole.numpy()) <= TOL
    assert _err(whole[:H * D].view(H, D),
                torch.einsum("tbnh,tbnd->hd", h_top, g).numpy()) <= TOL
    assert _err(whole[H * D:], g.sum(dim=(0, 1, 2)).numpy()) <= TOL
