"""The port's ``use_pallas`` path against the JAX package on the CPU: the
fused diffusion conv's plain version against the Pallas kernel run by the
Mosaic interpreter (``fused_diffusion_conv(..., interpret=True)``), its
autograd Function against ``jax.grad`` through the kernel's custom VJP,
the weight layout, and the slice as a whole: the detector's forward
(``Predictor``) and 3 ``TrainStep`` steps, and one SSL step, with
``use_pallas=True`` against JAX ``use_pallas=True`` (the kernel patched to
interpret, since JAX ``_layer_scan`` calls it without ``interpret``) and
against JAX ``recurrence="naive"``; the dispatch rules (2 T L convs per
forward with per-clip supports, none with a shared graph).

float32 criterion: outputs, losses and model gradients rtol 1e-4 / atol
1e-5 (tests/test_torch_train.py); the convolution's gradients, of order
10-100 here, normalized inf-norm error <= 1e-4; bfloat16 streams:
normalized inf-norm error <= 2e-2 against JAX float32.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_gnn_tpu.config import ExperimentConfig as JaxConfig
from eeg_gnn_tpu.graphs import compute_supports_jnp
from eeg_gnn_tpu.models.dcrnn import init_next_time_pred_model
from eeg_gnn_tpu.models.registry import build_model as jax_build_model
from eeg_gnn_tpu.ops import pallas_kernels as jpk
from eeg_gnn_tpu.ops.diffusion import diffusion_conv as jax_diffusion_conv
from eeg_gnn_tpu.serve import Predictor as JaxPredictor
from eeg_gnn_tpu.train.optim import make_optimizer as jax_make_optimizer
from eeg_gnn_tpu.train.step import make_train_step, ssl_loss_fn
from eeg_gnn_tpu.train.step import supervised_loss_fn
from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.graphs import compute_supports_torch
from eeg_gnn_tpu_torch.io import params_from_jax
from eeg_gnn_tpu_torch.models import dcgru as tdcgru
from eeg_gnn_tpu_torch.models.registry import build_model
from eeg_gnn_tpu_torch.ops import cuda_kernels as ck
from eeg_gnn_tpu_torch.ops import diffusion as tdiff
from eeg_gnn_tpu_torch.serve import Predictor
from eeg_gnn_tpu_torch.train import TrainStep

T, N, D, H, B, L, VALID = 6, 19, 12, 16, 5, 2, 4
STEPS_PER_EPOCH, EPOCHS = 2, 3  # the cosine LR moves at step 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _norm_err(got, want):
    """Normalized inf-norm error max|got - want| / max|want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


@pytest.fixture()
def interpret(monkeypatch):
    """JAX ``_layer_scan`` imports ``fused_diffusion_conv`` from its module
    at call time: run it in the Mosaic interpreter there."""
    monkeypatch.setattr(jpk, "fused_diffusion_conv", functools.partial(
        jpk.fused_diffusion_conv, interpret=True))


def _conv_inputs(rng, s, k, d, o, b):
    m = s * k + 1
    sup = rng.randn(s, b, N, N).astype(np.float32) * 0.3
    x = rng.randn(b, N, d).astype(np.float32)
    w = rng.randn(d * m, o).astype(np.float32) * 0.05
    bias = rng.randn(o).astype(np.float32)
    return sup, x, w, bias


# ---------------------------------------------------------------------------
# the convolution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,k,d,o,b", [
    (1, 2, 164, 128, 8),    # laplacian gate (tests/test_pallas_kernels.py)
    (2, 2, 164, 64, 8),     # dual_random_walk candidate
    (1, 1, 36, 16, 5),      # batch not a multiple of the TPU tile
    (2, 3, 20, 24, 4),      # deeper diffusion: the carry-over at K=3
])
def test_fused_plain_matches_jax_kernel(rng, s, k, d, o, b):
    m = s * k + 1
    sup, x, w, bias = _conv_inputs(rng, s, k, d, o, b)
    want = np.asarray(jpk.fused_diffusion_conv(
        jnp.asarray(sup), jnp.asarray(x),
        jpk.rearrange_weight(jnp.asarray(w), d, m), jnp.asarray(bias), k,
        batch_tile=4, interpret=True))
    w_mdo = ck.rearrange_weight(torch.from_numpy(w), d, m)
    args = (torch.from_numpy(sup), torch.from_numpy(x), w_mdo,
            torch.from_numpy(bias), k)
    got = ck.fused_diffusion_conv_plain(*args)
    assert got.shape == (b, N, o) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # on CPU tensors the wrapper is the plain version and counts nothing
    before = ck.fused_diffusion_conv_fwd.launches
    torch.testing.assert_close(ck.fused_diffusion_conv_fwd(*args), got,
                               rtol=0, atol=0)
    assert ck.fused_diffusion_conv_fwd.launches == before


@pytest.mark.parametrize("s", [1, 2])
def test_fused_function_gradients_match_jax(rng, s):
    """dx, dW in (M, D, O) layout and db against ``jax.grad`` through the
    Pallas kernel's custom VJP; no gradient for the supports."""
    k, d, o, b = 2, 12, 8, 4
    m = s * k + 1
    sup, x, w, bias = _conv_inputs(rng, s, k, d, o, b)
    w_r = np.array(jpk.rearrange_weight(jnp.asarray(w), d, m))

    def loss(x_, w_, b_):
        out = jpk.fused_diffusion_conv(jnp.asarray(sup), x_, w_, b_, k,
                                       batch_tile=4, interpret=True)
        return jnp.sum(out ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w_r), jnp.asarray(bias))
    leaves = [torch.from_numpy(v).requires_grad_() for v in (x, w_r, bias)]
    sup_t = torch.from_numpy(sup).requires_grad_()
    out = ck.fused_diffusion_conv(sup_t, *leaves, k)
    (out ** 2).sum().backward()
    for leaf, ref in zip(leaves, want):
        assert leaf.grad.shape == leaf.shape
        assert _norm_err(leaf.grad.numpy(), ref) <= 1e-4
    assert sup_t.grad is None
    jax_out = jax_diffusion_conv(jnp.asarray(sup), jnp.asarray(x),
                                 jnp.asarray(w), jnp.asarray(bias), k)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jax_out),
                               rtol=1e-4, atol=1e-5)
    # dW is autograd's of the plain diffusion conv, re-laid to (M, D, O)
    w_ref = torch.from_numpy(w).requires_grad_()
    (tdiff.diffusion_conv(torch.from_numpy(sup), torch.from_numpy(x), w_ref,
                          torch.from_numpy(bias), k) ** 2).sum().backward()
    torch.testing.assert_close(
        ck.rearrange_weight(w_ref.grad, d, m), leaves[1].grad, rtol=1e-5,
        atol=1e-6)


def test_rearrange_weight_layout(rng):
    d, m, o = 5, 3, 4
    w = rng.randn(d * m, o).astype(np.float32)
    w_r = ck.rearrange_weight(torch.from_numpy(w), d, m)
    np.testing.assert_array_equal(
        w_r.numpy(), np.asarray(jpk.rearrange_weight(jnp.asarray(w), d, m)))
    for di in range(d):
        for mi in range(m):
            np.testing.assert_array_equal(w_r[mi, di].numpy(), w[di * m + mi])
    np.testing.assert_array_equal(ck.restore_weight(w_r).numpy(), w)


def test_wrapper_raises_off_cpu_and_cuda(rng):
    sup, x, w, bias = _conv_inputs(rng, 1, 2, 12, 8, 3)
    args = [torch.from_numpy(v).to("meta") for v in (sup, x)]
    with pytest.raises(ValueError, match="neither on the CPU nor"):
        ck.fused_diffusion_conv_fwd(
            *args, ck.rearrange_weight(torch.from_numpy(w), 12, 3).to("meta"),
            torch.from_numpy(bias).to("meta"), 2)


# ---------------------------------------------------------------------------
# the slice: the detector and the SSL model with use_pallas
# ---------------------------------------------------------------------------


def _kw(graph_type, **kw):
    return dict(graph_type=graph_type, max_seq_len=T, num_rnn_layers=L,
                rnn_units=H, max_diffusion_step=2, input_dim=D,
                num_epochs=EPOCHS, test_batch_size=4, **kw)


def _adjacency(rng, n):
    adj = np.abs(rng.rand(n, N, N)).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    for a in adj:
        np.fill_diagonal(a, 1.0)
    return adj


def _batch():
    rng = np.random.RandomState(0)
    adj = _adjacency(rng, B)
    return {"x": rng.randn(B, T, N, D).astype(np.float32),
            "y": rng.randint(0, 2, size=B).astype(np.float32),
            "seq_lengths": rng.randint(1, T + 1, size=B), "adjacency": adj,
            "valid": VALID}


@functools.lru_cache(maxsize=None)
def _jax_params(graph_type):
    jcfg = JaxConfig(do_train=True, **_kw(graph_type)).finalize()
    params, _ = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    return _np(params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("graph_type", ["combined", "individual"])
def test_use_pallas_predictor_matches_jax(interpret, graph_type, dtype):
    """The detector's ``use_pallas`` forward through ``Predictor`` (n=7 at
    batch 4: the last chunk pads) against JAX ``use_pallas=True`` and JAX
    ``recurrence="naive"``; the port's naive path too."""
    params = _jax_params(graph_type)
    rng = np.random.RandomState(1)
    x = rng.randn(7, T, N, D).astype(np.float32)
    lens = rng.randint(1, T + 1, size=7)
    adj = _adjacency(rng, 7)
    want = {}
    for name, kw in (("pallas", dict(use_pallas=True)),
                     ("naive", dict(recurrence="naive"))):
        jcfg = JaxConfig(do_train=True, **_kw(graph_type, **kw)).finalize()
        want[name] = JaxPredictor(jcfg, params).predict_proba(
            x, lens, adjacency=adj)
    np.testing.assert_allclose(want["pallas"], want["naive"], rtol=1e-4,
                               atol=1e-5)
    sd = params_from_jax(params)
    for kw in (dict(use_pallas=True), dict(recurrence="naive")):
        cfg = ExperimentConfig(**_kw(graph_type, dtype=dtype, **kw)).finalize()
        got = Predictor(cfg, sd, device="cpu").predict_proba(x, lens,
                                                             adjacency=adj)
        assert got.shape == (7,) and np.all((got >= 0) & (got <= 1))
        for ref in want.values():
            if dtype == "float32":
                np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
            else:
                assert np.abs(got - ref).max() / np.abs(ref).max() <= 2e-2


@functools.lru_cache(maxsize=None)
def _jax_train_run(graph_type, kw_items):
    """JAX: step-1 gradients and the losses and params of 3
    ``make_train_step`` steps."""
    jcfg = JaxConfig(do_train=True, **_kw(graph_type, **dict(kw_items))
                     ).finalize()
    bundle = jax_build_model(jcfg)
    params, state = bundle.init(jax.random.PRNGKey(0))
    b = _batch()
    jb = {"x": jnp.asarray(b["x"]), "y": jnp.asarray(b["y"]),
          "seq_lengths": jnp.asarray(b["seq_lengths"]),
          "supports": compute_supports_jnp(jnp.asarray(b["adjacency"]),
                                           jcfg.filter_type),
          "valid": jnp.asarray(VALID, jnp.int32)}
    key = jax.random.PRNGKey(1)
    loss_fn = supervised_loss_fn(bundle, "detection")
    (_, _), grads = jax.value_and_grad(
        lambda p: loss_fn(p, state, jb, key, True), has_aux=True)(params)
    opt = jax_make_optimizer(jcfg.lr_init, jcfg.l2_wd, jcfg.max_grad_norm,
                             jcfg.num_epochs, STEPS_PER_EPOCH)
    train_step = make_train_step(loss_fn, opt, donate=False)
    p, s, o, losses = params, state, opt.init(params), []
    for _ in range(3):
        p, s, o, loss = train_step(p, s, o, jb, key)
        losses.append(float(loss))
    return _np(params), _np(grads), losses, _np(p)


@pytest.mark.parametrize("graph_type", ["combined", "individual"])
def test_use_pallas_train_step_matches_jax(interpret, graph_type):
    """3 ``TrainStep`` steps with ``use_pallas=True`` (the Function's
    forward and its plain-VJP backward) against JAX ``use_pallas=True``:
    step-1 gradients, losses, parameters after 3 steps; the losses also
    against JAX ``recurrence="naive"``."""
    params, grads, losses, final = _jax_train_run(
        graph_type, (("use_pallas", True),))
    cfg = ExperimentConfig(**_kw(graph_type, use_pallas=True)).finalize()
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(params))
    step = TrainStep(cfg, model, STEPS_PER_EPOCH, device="cpu")
    batch = _batch()
    got = [float(step.loss_and_grads(batch))]
    named = dict(step.model.named_parameters())
    for name, want in params_from_jax(grads).items():
        np.testing.assert_allclose(named[name].grad.numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    step.update()
    got += [float(step(batch)) for _ in range(2)]
    np.testing.assert_allclose(got, losses, rtol=1e-4, atol=1e-5)
    sd = step.model.state_dict()
    for name, want in params_from_jax(final).items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)
    if graph_type == "combined":
        _, _, naive_losses, _ = _jax_train_run(
            graph_type, (("recurrence", "naive"),))
        np.testing.assert_allclose(got, naive_losses, rtol=1e-4, atol=1e-5)


def _count_convs(monkeypatch):
    """Spy on the two names ``_step_scan`` calls; returns the call log."""
    calls = []

    def spy(name):
        fn = getattr(ck, name)

        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapped

    for name in ("fused_diffusion_conv", "fused_diffusion_conv_fwd"):
        monkeypatch.setattr(tdcgru, name, spy(name))
    return calls


def test_use_pallas_dispatch(monkeypatch):
    """Per-clip supports: 2 T L convs per forward, through the bare wrapper
    under inference mode and the autograd Function in training; no other
    recurrence kernel's wrapper is called."""
    calls = _count_convs(monkeypatch)

    def refuse(*args, **kwargs):
        raise AssertionError("use_pallas reached an encoder kernel")

    for name in ("dcgru_recurrence_xin_fwd", "dcgru_recurrence_fwd",
                 "dcgru_layer_recurrence_xin", "dcgru_layer_recurrence_fused",
                 "dcgru_layer_recurrence"):
        monkeypatch.setattr(tdcgru, name, refuse)
    cfg = ExperimentConfig(**_kw("individual", use_pallas=True,
                                 input_fusion=True)).finalize()
    pred = Predictor(cfg, build_model(
        cfg, torch.Generator().manual_seed(0)).state_dict(), device="cpu")
    b = _batch()
    pred.predict_proba(b["x"][:4], b["seq_lengths"][:4],
                       adjacency=b["adjacency"][:4])
    assert calls == ["fused_diffusion_conv_fwd"] * (2 * T * L)
    calls.clear()
    step = TrainStep(cfg, build_model(cfg, torch.Generator().manual_seed(0)),
                     STEPS_PER_EPOCH, device="cpu")
    assert np.isfinite(float(step(b)))
    assert calls == ["fused_diffusion_conv"] * (2 * T * L)


def test_shared_graph_runs_no_kernel(monkeypatch):
    """A shared (S, N, N) graph takes the plain loop, as JAX does
    (``supports.ndim == 4`` gates the kernel): the same output as the
    naive and the stacked recurrences."""
    calls = _count_convs(monkeypatch)
    b = _batch()
    x = torch.from_numpy(b["x"])
    lens = torch.from_numpy(b["seq_lengths"])
    out = {}
    for kw in (dict(use_pallas=True), dict(recurrence="naive"),
               dict(recurrence="stacked")):
        cfg = ExperimentConfig(**_kw("individual", **kw)).finalize()
        sup = compute_supports_torch(torch.from_numpy(b["adjacency"][0]),
                                     cfg.filter_type)
        assert sup.ndim == 3
        model = build_model(cfg, torch.Generator().manual_seed(0))
        with torch.no_grad():
            out[tuple(kw.items())] = model(x, lens, sup)
    assert calls == []
    first, *rest = out.values()
    for other in rest:
        torch.testing.assert_close(first, other, rtol=1e-5, atol=1e-6)


def test_use_pallas_ssl_step_matches_jax(interpret):
    """One SSL pre-training step with ``use_pallas`` (the encoder's loop,
    the decoder's kernels' plain versions: the decoder ignores the flag)
    against JAX ``use_pallas=True``: loss and every gradient."""
    t_out, mean, std = 3, 0.25, 1.5
    kw = dict(task="SS pre-training", graph_type="combined",
              max_seq_len=T, num_rnn_layers=L, rnn_units=H,
              max_diffusion_step=2, input_dim=D, output_dim=D,
              use_pallas=True)
    jcfg = JaxConfig(do_train=True, **kw).finalize()
    params = init_next_time_pred_model(jax.random.PRNGKey(0),
                                       jcfg.dcrnn_config())
    rng = np.random.RandomState(0)
    batch = {"x": rng.randn(B, T, N, D).astype(np.float32),
             "y": rng.randn(B, t_out, N, D).astype(np.float32),
             "adjacency": _adjacency(rng, B), "valid": VALID}
    jb = {"x": jnp.asarray(batch["x"]), "y": jnp.asarray(batch["y"]),
          "supports": compute_supports_jnp(jnp.asarray(batch["adjacency"]),
                                           jcfg.filter_type),
          "valid": jnp.asarray(VALID, jnp.int32)}
    loss_fn = ssl_loss_fn(jcfg.dcrnn_config(), jnp.float32(mean),
                          jnp.float32(std))
    (want_loss, _), grads = jax.value_and_grad(
        lambda p: loss_fn(p, {}, jb, jax.random.PRNGKey(1), True,
                          jnp.int32(0)), has_aux=True)(params)
    cfg = ExperimentConfig(**kw).finalize()
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(_np(params)))
    step = TrainStep(cfg, model, STEPS_PER_EPOCH, device="cpu", mean=mean,
                     std=std)
    got = float(step.loss_and_grads(batch, batches_seen=0))
    np.testing.assert_allclose(got, float(want_loss), rtol=1e-4, atol=1e-5)
    named = dict(step.model.named_parameters())
    want = params_from_jax(_np(grads))
    assert set(want) == set(named)
    for name, g in want.items():
        np.testing.assert_allclose(named[name].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_config_threads_use_pallas():
    cfg = ExperimentConfig(**_kw("combined", use_pallas=True)).finalize()
    assert all(c.use_pallas for c in cfg.dcrnn_config().encoder_cfgs())
    ssl = build_model(dataclasses.replace(cfg, task="SS pre-training"))
    assert not any(c.use_pallas for c in ssl.dec_cfgs)
    with pytest.raises(ValueError, match="unknown recurrence"):
        Predictor(dataclasses.replace(cfg, use_pallas=False,
                                      recurrence="scan"),
                  build_model(cfg).state_dict(), device="cpu").predict_proba(
            _batch()["x"][:2], adjacency=_batch()["adjacency"][:2])
