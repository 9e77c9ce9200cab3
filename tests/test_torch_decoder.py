"""The port's seq2seq decoder against the JAX package on the CPU: the
decoder Function (its kernels' plain versions, forward and hand-written
backward) against ``_decoder_pallas(..., interpret=True)``, the JAX
decoder kernels run by the Mosaic interpreter; the stacked scan against
JAX ``decoder_apply`` fed the force vector JAX drew; the plain backward
against torch autograd of the plain forward; and the dispatch rules.

float32 criterion: forward rtol 1e-4 / atol 1e-5, gradients rtol 2e-4 /
atol 2e-5 (tests/test_pallas_decoder.py:86-96); bfloat16 streams:
normalized inf-norm error <= 2e-2, held against the JAX float32 path
(the JAX bf16 CPU path is itself outside its bound, ROADMAP.md Queue 3).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_gnn_tpu.models.dcgru import _decoder_pallas
from eeg_gnn_tpu.models.dcgru import decoder_apply as jax_decoder_apply
from eeg_gnn_tpu.models.dcgru import decoder_init as jax_decoder_init
from eeg_gnn_tpu.ops.recurrent import chebyshev_operators as jax_cheb
from eeg_gnn_tpu_torch.models import dcgru as tdcgru
from eeg_gnn_tpu_torch.ops import cuda_decoder as cd
from eeg_gnn_tpu_torch.ops.recurrent import chebyshev_operators

N, D, H, K, T_OUT = 19, 10, 16, 2, 4
FORCES = {"none": np.zeros(T_OUT), "all": np.ones(T_OUT),
          "mixed": (np.arange(T_OUT) % 2).astype(float)}


def _setup(rng, *, num_supports, batch, num_layers, batched_graph=True):
    """JAX decoder params (numpy), supports, inputs, initial states and a
    loss weight, from one seed."""
    params, _ = jax_decoder_init(jax.random.PRNGKey(0), D, H, K, N,
                                 num_supports, num_layers, D, "tanh")
    shape = ((num_supports, batch, N, N) if batched_graph
             else (num_supports, N, N))
    sup = (np.abs(rng.randn(*shape)) / N).astype(np.float32)
    dec = rng.randn(T_OUT, batch, N, D).astype(np.float32)
    h0 = (rng.randn(num_layers, batch, N, H) * 0.1).astype(np.float32)
    wl = rng.randn(T_OUT, batch, N, D).astype(np.float32)
    return jax.tree_util.tree_map(np.asarray, params), sup, dec, h0, wl


def _jax_cfgs(num_supports, num_layers, dtype="float32"):
    _, cfgs = jax_decoder_init(jax.random.PRNGKey(0), D, H, K, N,
                               num_supports, num_layers, D, "tanh")
    return tuple(dataclasses.replace(c, batch_tile=4, compute_dtype=dtype)
                 for c in cfgs)


def _torch_cfgs(num_supports, dtype="float32", recurrence="pallas"):
    mk = lambda d: tdcgru.DCGRUConfig(d, H, K, N, num_supports, "tanh",
                                      dtype, recurrence)
    return mk(D), mk(H)


def _jax_grads(fn, params, dec, h0, wl):
    """fn(params, dec, h0) -> out; (out, grads of sum(out * wl) wrt the
    three) as numpy."""
    op = jax.tree_util.tree_map(jnp.asarray, (params, dec, h0))
    out = fn(*op)
    grads = jax.grad(lambda o: jnp.sum(fn(*o) * wl))(op)
    return np.asarray(out), jax.tree_util.tree_map(np.asarray, grads)


def _torch_grads(fn, params, dec, h0, wl):
    """The same on the port: params a JAX-layout tree of numpy arrays."""
    tp = jax.tree_util.tree_map(
        lambda a: torch.tensor(a, requires_grad=True), params)
    td = torch.tensor(dec, requires_grad=True)
    th = torch.tensor(h0, requires_grad=True)
    out = fn(tp, td, th)
    (out.float() * torch.from_numpy(wl)).sum().backward()
    grads = jax.tree_util.tree_map(lambda t: t.grad.numpy(), (tp, td, th))
    return out.detach().float().numpy(), grads


def _pairs(g_jax, g_torch):
    """(name, jax, torch) for every gradient: layer 0, the shared cell,
    the projection, dec_inputs, h0_stack."""
    flat_j = jax.tree_util.tree_leaves_with_path(g_jax)
    flat_t = jax.tree_util.tree_leaves(g_torch)
    assert len(flat_j) == len(flat_t)
    return [(jax.tree_util.keystr(k), a, b)
            for (k, a), b in zip(flat_j, flat_t)]


def _a_ops_jax(sup):
    a = jax_cheb(jnp.asarray(sup), K)
    return jax.lax.stop_gradient(a[:, None] if a.ndim == 3 else a)


def _a_ops_torch(sup):
    a = chebyshev_operators(torch.from_numpy(sup), K)
    return (a[:, None] if a.ndim == 3 else a).contiguous()


def _norm_err(got, want):
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-9))


CASES = [
    (1, 6, 2, True, "none"),    # no forcing
    (2, 4, 2, True, "mixed"),   # dual supports, mixed force steps
    (1, 5, 3, False, "all"),    # shared graph, 3 layers, all forced
    (1, 4, 1, True, "mixed"),   # a single layer: no shared cell
]


@pytest.mark.parametrize(
    "num_supports,batch,num_layers,batched_graph,force_pat", CASES)
def test_decoder_kernels_match_jax_pallas(rng, num_supports, batch,
                                          num_layers, batched_graph,
                                          force_pat):
    """Forward and every gradient of the decoder Function on the CPU vs
    JAX ``_decoder_pallas`` in interpret mode."""
    params, sup, dec, h0, wl = _setup(
        rng, num_supports=num_supports, batch=batch, num_layers=num_layers,
        batched_graph=batched_graph)
    force = FORCES[force_pat].astype(np.float32)
    cfgs = _jax_cfgs(num_supports, num_layers)
    a = _a_ops_jax(sup)
    want, g_jax = _jax_grads(
        lambda p, d, h: _decoder_pallas(
            cfgs[0], cfgs[1], p, a, d, jnp.asarray(force), h, num_layers,
            p["proj_w"].T, interpret=True), params, dec, h0, wl)
    cfg0, _ = _torch_cfgs(num_supports)
    at = _a_ops_torch(sup)
    got, g_torch = _torch_grads(
        lambda p, d, h: tdcgru._decoder_kernels(
            cfg0, p, at, d, torch.from_numpy(force), h, num_layers),
        params, dec, h0, wl)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    pairs = _pairs(g_jax, g_torch)
    assert len(pairs) == 4 * (2 if num_layers > 1 else 1) + 2 + 2
    for name, gj, gt in pairs:
        np.testing.assert_allclose(gt, gj, rtol=2e-4, atol=2e-5,
                                   err_msg=name)


def test_decoder_kernels_bf16_streams(rng):
    """bfloat16 streams (x, proj, residuals, the proj cotangent, dx)
    against the JAX float32 decoder kernels: forward and every gradient
    within 2e-2, normalized."""
    params, sup, dec, h0, wl = _setup(rng, num_supports=2, batch=4,
                                      num_layers=3)
    force = FORCES["mixed"].astype(np.float32)
    cfgs = _jax_cfgs(2, 3)
    a = _a_ops_jax(sup)
    want, g_jax = _jax_grads(
        lambda p, d, h: _decoder_pallas(
            cfgs[0], cfgs[1], p, a, d, jnp.asarray(force), h, 3,
            p["proj_w"].T, interpret=True), params, dec, h0, wl)
    cfg0, _ = _torch_cfgs(2, "bfloat16")
    at = _a_ops_torch(sup)
    got, g_torch = _torch_grads(
        lambda p, d, h: tdcgru._decoder_kernels(
            cfg0, p, at, d, torch.from_numpy(force), h, 3),
        params, dec, h0, wl)
    assert _norm_err(got, want) <= 2e-2
    for name, gj, gt in _pairs(g_jax, g_torch):
        assert _norm_err(gt, gj) <= 2e-2, name


@pytest.mark.parametrize("num_layers,num_supports", [(2, 1), (3, 2)])
def test_stacked_decoder_matches_jax_scan(rng, num_layers, num_supports):
    """The port's stacked scan (autograd through ``dcgru_cell_apply_ops``)
    vs JAX ``decoder_apply`` on the CPU (its scan) with teacher forcing
    0.5, fed the force vector JAX drew (tests/test_pallas_decoder.py
    :193-200); forward and gradients."""
    params, sup, dec, h0, wl = _setup(
        rng, num_supports=num_supports, batch=4, num_layers=num_layers)
    key = jax.random.PRNGKey(5)
    step_keys = jax.random.split(key, T_OUT)
    force = np.array([float(jax.random.uniform(jax.random.split(k)[0], ()))
                      < 0.5 for k in step_keys], np.float32)
    cfgs = _jax_cfgs(num_supports, num_layers)
    want, g_jax = _jax_grads(
        lambda p, d, h: jax_decoder_apply(
            cfgs, p, jnp.asarray(sup), d, h, num_layers,
            teacher_forcing_ratio=0.5, rng=key, training=True),
        params, dec, h0, wl)
    tcfgs = _torch_cfgs(num_supports, recurrence="stacked")
    got, g_torch = _torch_grads(
        lambda p, d, h: tdcgru.decoder_apply(
            tcfgs, p, torch.from_numpy(sup), d, h, num_layers,
            force=torch.from_numpy(force), training=True),
        params, dec, h0, wl)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for name, gj, gt in _pairs(g_jax, g_torch):
        np.testing.assert_allclose(gt, gj, rtol=2e-4, atol=2e-5,
                                   err_msg=name)


def _plain_args(rng, *, num_layers, num_supports, batch=3, dtype=torch.float32):
    m = num_supports * K + 1
    f = lambda *s, scale=0.3: torch.from_numpy(
        (rng.randn(*s) * scale).astype(np.float32))
    sup = (np.abs(rng.randn(num_supports, batch, N, N)) / N).astype(
        np.float32)
    cell = lambda d_in: [f(m * d_in, 2 * H), f(m * d_in, H), f(m * H, 2 * H),
                         f(m * H, H), f(2 * H, scale=0.1), f(H, scale=0.1)]
    shared = cell(H) if num_layers > 1 else [None] * 6
    return (_a_ops_torch(sup), f(T_OUT, batch, N, D, scale=1.0).to(dtype),
            torch.tensor([1.0, 0.0, 0.0, 1.0][:T_OUT]), *cell(D), *shared,
            f(H, D), f(D, scale=0.1), f(num_layers, batch, N, H, scale=0.1))


@pytest.mark.parametrize("num_layers,num_supports", [(1, 2), (3, 1)])
def test_plain_bwd_matches_autograd_of_plain_fwd(rng, num_layers,
                                                 num_supports):
    """The hand-written reverse loop vs torch autograd through the plain
    forward, for every gradient."""
    args = _plain_args(rng, num_layers=num_layers, num_supports=num_supports)
    cot = torch.from_numpy(rng.randn(T_OUT, 3, N, D).astype(np.float32))
    diff = [i for i, t in enumerate(args) if t is not None and i not in
            (0, 2)]
    leaves = [args[i].clone().requires_grad_() for i in diff]
    full = list(args)
    for i, t in zip(diff, leaves):
        full[i] = t
    proj, in0, h_seq, ru, c = cd.dcgru_decoder_fwd_plain(
        *full, num_layers, residuals=True)
    auto = torch.autograd.grad((proj * cot).sum(), leaves)
    auto = dict(zip(diff, auto))
    a_ops, x, force, *w = args
    layer0, shared, wp, h0 = w[:6], w[6:12], w[12], w[14]
    ll = num_layers
    got = cd.dcgru_decoder_bwd_plain(
        a_ops, *layer0[:4], *shared[:4], wp,
        cd.decoder_h_prev(h0, h_seq).detach(), h_seq.detach(), ru.detach(),
        c.detach(), in0.detach(), cot, force, ll)
    # (dx, dh0, layer 0 six, shared six, dwp, dbp) vs the primals' order
    index = [1, 17, *range(3, 9), *range(9, 15), 15, 16]
    assert len(got) == len(index)
    for i, g in zip(index, got):
        if args[i] is None:
            assert g is None
            continue
        torch.testing.assert_close(g, auto[i], rtol=1e-4, atol=1e-5)


def test_plain_fwd_residuals_layout(rng):
    """The residuals' layout: in0 is GO then the feedback; h/ru/c are
    layer-major (L, T, B, N, W), so each layer's stream is contiguous for
    the bulk dW kernel; proj is the top layer's h projected; layer 1's
    input is layer 0's h; each step's incoming states are h0 then h."""
    args = _plain_args(rng, num_layers=2, num_supports=1)
    proj, in0, h_seq, ru, c = cd.dcgru_decoder_fwd_plain(*args, 2,
                                                         residuals=True)
    x, force, wp, bp, h0 = args[1], args[2], args[15], args[16], args[17]
    assert h_seq.shape == c.shape == (2, T_OUT, 3, N, H)
    assert ru.shape == (2, T_OUT, 3, N, 2 * H)
    assert torch.all(in0[0] == 0)
    for t in range(1, T_OUT):
        want = x[t - 1] if force[t - 1] else proj[t - 1]
        torch.testing.assert_close(in0[t], want)
    torch.testing.assert_close(proj, h_seq[1] @ wp + bp)
    h_prev = cd.decoder_h_prev(h0, h_seq)
    assert h_prev.shape == h_seq.shape
    torch.testing.assert_close(h_prev[:, 0], h0)
    torch.testing.assert_close(h_prev[:, 1:], h_seq[:, :-1])
    assert cd.dcgru_decoder_fwd_plain(*args, 2)[1:] == (None,) * 4


def test_decoder_bf16_residuals_and_dx_dtype(rng):
    args = _plain_args(rng, num_layers=2, num_supports=1,
                       dtype=torch.bfloat16)
    outs = cd.dcgru_decoder_fwd(*args, 2, residuals=True)
    assert all(o.dtype == torch.bfloat16 for o in outs)
    x = args[1].clone().requires_grad_()
    w = [t.clone().requires_grad_() if t is not None else None
         for t in args[3:]]
    out = cd.dcgru_decoder_recurrence(args[0], x, args[2], *w, 2)
    out.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16 and w[-1].grad.dtype == torch.float32


def test_cpu_wrappers_use_plain_and_do_not_count(rng):
    """On CPU tensors the forward and the backward composite run their
    plain versions and no kernel counts a launch; the composite has no
    counter of its own."""
    from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr

    args = _plain_args(rng, num_layers=2, num_supports=1)
    kernels = (cd.dcgru_decoder_fwd, cd.dcgru_dec_bwd_loop, cd.dcgru_dec_dwp,
               cr.dcgru_xin_dw, cr.dcgru_dw_reduce)
    before = [k.launches for k in kernels]
    w = [t.clone().requires_grad_() for t in args[3:]]
    out = cd.dcgru_decoder_recurrence(args[0], args[1], args[2], *w, 2)
    out.sum().backward()
    want = cd.dcgru_decoder_fwd_plain(*args, 2)[0]
    torch.testing.assert_close(out.detach(), want)
    assert [k.launches for k in kernels] == before
    assert not hasattr(cd.dcgru_decoder_bwd, "launches")


def test_wrappers_raise_off_cpu_without_cuda(rng):
    """Off the CPU a wrapper launches its kernel or raises (here: the meta
    device), never the plain version."""
    args = [t.to("meta") if t is not None else None
            for t in _plain_args(rng, num_layers=2, num_supports=1)]
    with pytest.raises(ValueError, match="neither on the CPU nor"):
        cd.dcgru_decoder_fwd(*args, 2)
    m = lambda *s: torch.empty(*s, device="meta")
    with pytest.raises(ValueError, match="neither on the CPU nor"):
        cd.dcgru_decoder_bwd(
            args[0], *args[3:7], *args[9:13], args[15],
            m(2, T_OUT, 3, N, H), m(2, T_OUT, 3, N, H),
            m(2, T_OUT, 3, N, 2 * H), m(2, T_OUT, 3, N, H),
            m(T_OUT, 3, N, D), m(T_OUT, 3, N, D), args[2], 2)


def test_dropout_in_training_takes_the_scan(rng, monkeypatch):
    """As JAX (``models/dcgru.py:569``): training with dropout > 0 runs the
    stacked scan; otherwise ``recurrence="pallas"`` runs the kernels."""
    params, sup, dec, h0, _ = _setup(rng, num_supports=1, batch=3,
                                     num_layers=2)
    tp = jax.tree_util.tree_map(torch.tensor, params)
    cfgs = _torch_cfgs(1)
    calls = []
    spy = lambda *a: calls.append(1) or cd.dcgru_decoder_fwd(*a)
    monkeypatch.setattr(tdcgru, "dcgru_decoder_fwd", spy)
    monkeypatch.setattr(tdcgru, "dcgru_decoder_recurrence", spy)
    run = lambda **kw: tdcgru.decoder_apply(
        cfgs, tp, torch.from_numpy(sup), torch.from_numpy(dec),
        torch.from_numpy(h0), 2, generator=torch.Generator().manual_seed(1),
        **kw)
    run(dropout_rate=0.3, training=True)
    assert calls == []
    run(dropout_rate=0.3, training=False)
    run(dropout_rate=0.0, training=True)
    assert calls == [1, 1]
    a = run(dropout_rate=0.3, training=True)
    b = run(dropout_rate=0.3, training=True)
    torch.testing.assert_close(a, b)  # masks from the seeded generator


def test_single_layer_decoder_has_no_shared_cell(rng):
    cfgs = _torch_cfgs(1)
    one = tdcgru.DCGRUDecoder(cfgs, 1, D, torch.Generator().manual_seed(0))
    three = tdcgru.DCGRUDecoder(cfgs, 3, D, torch.Generator().manual_seed(0))
    assert not any(k.startswith("shared") for k in one.state_dict())
    assert "shared" not in one.params()
    assert sum(k.startswith("shared.") for k in three.state_dict()) == 4
    args = _plain_args(rng, num_layers=1, num_supports=1)
    w = [t.clone().requires_grad_() if t is not None else None
         for t in args[3:]]
    cd.dcgru_decoder_recurrence(args[0], args[1], args[2], *w, 1) \
        .sum().backward()
    assert all(t.grad is not None for t in w[:6] + w[12:])


def test_force_draws_from_the_generator():
    draw = lambda ratio, seed: tdcgru.draw_force(
        12, ratio, torch.Generator().manual_seed(seed), "cpu")
    torch.testing.assert_close(draw(0.5, 3), draw(0.5, 3))
    assert set(draw(0.5, 3).tolist()) == {0.0, 1.0}
    assert draw(None, 3).sum() == 0 and draw(1.0, 3).sum() == 12
    assert draw(torch.tensor(0.0), 3).sum() == 0
