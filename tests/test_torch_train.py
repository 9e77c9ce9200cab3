"""The port's training slice against the JAX package on the CPU: losses,
the optimizer (clip, L2 + Adam, cosine LR), and the whole train step —
JAX ``make_train_step`` (its stacked recurrence off-TPU) against the
port's ``TrainStep(device="cpu")`` (its kernels' plain versions) from the
same weights, over 3 steps; plus the device rule, dropout and the rule
that serving records no autograd residuals.

float32 criterion: rtol 1e-4, atol 1e-5 (tests/test_recurrent.py:316);
parameters after 3 steps atol 1e-5, about 1/30 of one Adam step at lr
3e-4.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from eeg_gnn_tpu.config import ExperimentConfig as JaxConfig
from eeg_gnn_tpu.graphs import compute_supports_jnp
from eeg_gnn_tpu.models.registry import build_model as jax_build_model
from eeg_gnn_tpu.train import losses as jlosses
from eeg_gnn_tpu.train.optim import cosine_annealing_lr as jax_cosine
from eeg_gnn_tpu.train.optim import make_optimizer as jax_make_optimizer
from eeg_gnn_tpu.train.step import make_train_step, supervised_loss_fn
from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.io import params_from_jax
from eeg_gnn_tpu_torch.models import dcgru as tdcgru
from eeg_gnn_tpu_torch.models.dcrnn import dropout
from eeg_gnn_tpu_torch.models.registry import build_model
from eeg_gnn_tpu_torch.ops import cuda_recurrent as cr
from eeg_gnn_tpu_torch.serve import Predictor
from eeg_gnn_tpu_torch.train import (
    TrainStep,
    bce_with_logits,
    cosine_annealing_lr,
    cross_entropy,
    make_optimizer,
)
from eeg_gnn_tpu_torch.train import step as tstep

T, N, D, H, B, VALID = 6, 19, 12, 16, 5, 4
STEPS_PER_EPOCH, EPOCHS = 2, 3  # the cosine LR moves at step 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("valid", [None, 3, "mask"])
@pytest.mark.parametrize("task", ["detection", "classification"])
def test_losses_match_jax(rng, task, valid):
    n = 6
    if valid == "mask":
        valid = np.array([1, 0, 1, 1, 0, 1], bool)
    if task == "detection":
        logits = rng.randn(n, 1).astype(np.float32) * 3
        y = rng.randint(0, 2, size=n).astype(np.float32)
        want = jlosses.bce_with_logits(jnp.asarray(logits), jnp.asarray(y),
                                       valid=valid)
        got = bce_with_logits(torch.from_numpy(logits), torch.from_numpy(y),
                              valid=valid)
    else:
        logits = rng.randn(n, 4).astype(np.float32) * 3
        y = rng.randint(0, 4, size=n)
        want = jlosses.cross_entropy(jnp.asarray(logits), jnp.asarray(y),
                                     valid=valid)
        got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(y),
                            valid=valid)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def test_cosine_schedule_matches_jax():
    jax_s = jax_cosine(3e-4, EPOCHS, STEPS_PER_EPOCH)
    ours = cosine_annealing_lr(3e-4, EPOCHS, STEPS_PER_EPOCH)
    for step in range(8):
        np.testing.assert_allclose(ours(step), float(jax_s(step)),
                                   rtol=1e-6)


def test_optimizer_matches_optax(rng):
    """5 steps on the same parameter and gradient trees; step 3's
    gradient is scaled so the global-norm clip triggers."""
    shapes = {"w": (7, 5), "b": (5,), "v": (3, 4, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) * 0.3
              for k, s in shapes.items()} for _ in range(5)]
    grads[3] = {k: 40.0 * g for k, g in grads[3].items()}
    norms = [np.sqrt(sum((g ** 2).sum() for g in gs.values()))
             for gs in grads]
    assert norms[3] > 5.0 > max(norms[:3] + norms[4:])

    opt = jax_make_optimizer(3e-4, 5e-4, 5.0, EPOCHS, STEPS_PER_EPOCH)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    topt = make_optimizer(tp.values(), 3e-4, 5e-4, 5.0, EPOCHS,
                          STEPS_PER_EPOCH)
    for i, g in enumerate(grads):
        updates, state = opt.update(
            jax.tree_util.tree_map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        topt.zero_grad()
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    assert topt.lr == pytest.approx(
        cosine_annealing_lr(3e-4, EPOCHS, STEPS_PER_EPOCH)(5))


# ---------------------------------------------------------------------------
# the whole train step
# ---------------------------------------------------------------------------


def _kw(graph_type, task):
    return dict(graph_type=graph_type, task=task,
                num_classes=1 if task == "detection" else 4, max_seq_len=T,
                num_rnn_layers=2, rnn_units=H, max_diffusion_step=2,
                input_dim=D, num_epochs=EPOCHS)


def _batch(task):
    rng = np.random.RandomState(0)
    adj = np.abs(rng.rand(B, N, N)).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    for a in adj:
        np.fill_diagonal(a, 1.0)
    y = (rng.randint(0, 2, size=B).astype(np.float32) if task == "detection"
         else rng.randint(0, 4, size=B))
    return {"x": rng.randn(B, T, N, D).astype(np.float32), "y": y,
            "seq_lengths": rng.randint(1, T + 1, size=B), "adjacency": adj,
            "valid": VALID}


@functools.lru_cache(maxsize=None)
def _jax_run(graph_type, task):
    """JAX: initial params, step-1 loss and gradients, and the losses and
    params of 3 ``make_train_step`` steps (stacked recurrence on the
    CPU)."""
    jcfg = JaxConfig(do_train=True, **_kw(graph_type, task)).finalize()
    bundle = jax_build_model(jcfg)
    params, state = bundle.init(jax.random.PRNGKey(0))
    b = _batch(task)
    jb = {"x": jnp.asarray(b["x"]), "y": jnp.asarray(b["y"]),
          "seq_lengths": jnp.asarray(b["seq_lengths"]),
          "supports": compute_supports_jnp(jnp.asarray(b["adjacency"]),
                                           jcfg.filter_type),
          "valid": jnp.asarray(VALID, jnp.int32)}
    key = jax.random.PRNGKey(1)
    loss_fn = supervised_loss_fn(bundle, task)
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


@pytest.mark.parametrize("input_fusion", [True, False])
@pytest.mark.parametrize("graph_type", ["combined", "individual"])
def test_train_step_matches_jax(graph_type, input_fusion):
    """The slice as a whole (detection, B=5 with valid=4): losses of 3
    steps, step-1 gradients, and the parameters after 3 steps."""
    params, grads, losses, final = _jax_run(graph_type, "detection")
    cfg = ExperimentConfig(**_kw(graph_type, "detection"),
                           input_fusion=input_fusion).finalize()
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(params))
    step = TrainStep(cfg, model, STEPS_PER_EPOCH, device="cpu")
    batch = _batch("detection")
    got = [float(step.loss_and_grads(batch))]
    for name, want in params_from_jax(grads).items():
        g = dict(step.model.named_parameters())[name].grad
        np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    step.update()
    got += [float(step(batch)) for _ in range(2)]
    np.testing.assert_allclose(got, losses, rtol=1e-4, atol=1e-5)
    sd = step.model.state_dict()
    for name, want in params_from_jax(final).items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_classification_step_matches_jax():
    """The CE path: 4 classes, valid=4, combined graph."""
    params, grads, losses, final = _jax_run("combined", "classification")
    cfg = ExperimentConfig(**_kw("combined", "classification")).finalize()
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(params))
    step = TrainStep(cfg, model, STEPS_PER_EPOCH, device="cpu")
    got = [float(step(_batch("classification"))) for _ in range(3)]
    np.testing.assert_allclose(got, losses, rtol=1e-4, atol=1e-5)
    for name, want in params_from_jax(final).items():
        np.testing.assert_allclose(step.model.state_dict()[name].numpy(),
                                   want.numpy(), rtol=0, atol=1e-5,
                                   err_msg=name)


def test_train_step_supports_argument_and_row_mask():
    """Precomputed ``supports`` and ``valid`` as a row mask give the step
    that ``adjacency`` and the equal count give."""
    from eeg_gnn_tpu_torch.graphs import compute_supports_torch

    cfg = ExperimentConfig(**_kw("individual", "detection")).finalize()
    batch = _batch("detection")
    sup = compute_supports_torch(torch.from_numpy(batch["adjacency"]),
                                 cfg.filter_type)
    alt = {k: v for k, v in batch.items() if k != "adjacency"}
    alt.update(supports=sup.numpy(), valid=np.arange(B) < VALID)
    losses = []
    for b in (batch, alt):
        step = TrainStep(cfg, build_model(cfg, torch.Generator().manual_seed(
            3)), STEPS_PER_EPOCH, device="cpu")
        losses.append([float(step(b)) for _ in range(2)])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)


# ---------------------------------------------------------------------------
# device rule, unported variants, dropout, serving
# ---------------------------------------------------------------------------


def test_train_step_without_device_needs_cuda(monkeypatch):
    cfg = ExperimentConfig(**_kw("combined", "detection")).finalize()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="TrainStep: no CUDA device"):
            TrainStep(cfg, build_model(cfg), 1, device=device)


def test_unported_step_variants_raise():
    """The mesh cached step is ported and refuses a step without a mesh;
    the SSL task refuses the supervised loss."""
    cfg = ExperimentConfig(**_kw("combined", "detection")).finalize()
    step = TrainStep(cfg, build_model(cfg), 1, device="cpu")
    with pytest.raises(ValueError, match="no mesh"):
        tstep.make_mesh_cached_train_step(step, T, B)
    model = build_model(ExperimentConfig().finalize())
    with pytest.raises(ValueError, match="ssl_loss_fn"):
        tstep.supervised_loss_fn(model, "SS pre-training")


def test_dropout_draws_from_the_generator():
    x = torch.ones(4, N, H)
    a = dropout(x, 0.5, True, torch.Generator().manual_seed(5))
    b = dropout(x, 0.5, True, torch.Generator().manual_seed(5))
    torch.testing.assert_close(a, b)
    assert set(a.unique().tolist()) == {0.0, 2.0}
    assert dropout(x, 0.5, False) is x and dropout(x, 0.0, True) is x


def test_dropout_step_is_reproducible():
    cfg = dataclasses.replace(
        ExperimentConfig(**_kw("combined", "detection")), dropout=0.3
    ).finalize()
    runs = []
    for _ in range(2):
        step = TrainStep(cfg, build_model(cfg, torch.Generator().manual_seed(
            0)), STEPS_PER_EPOCH, device="cpu",
            generator=torch.Generator().manual_seed(9))
        runs.append([float(step(_batch("detection"))) for _ in range(2)])
    assert runs[0] == runs[1]


@pytest.mark.parametrize("input_fusion", [True, False])
def test_predictor_records_no_autograd_residuals(monkeypatch, input_fusion):
    """Serving runs under inference mode: the forward wrappers are called
    without residuals and the autograd Functions are never entered."""
    calls = []

    def spy(kernel):
        def wrapped(*args, **kwargs):
            calls.append(kwargs.get("residuals", False))
            return kernel(*args, **kwargs)
        return wrapped

    def refuse(*args, **kwargs):
        raise AssertionError("serving entered an autograd Function")

    for name in ("dcgru_recurrence_xin_fwd", "dcgru_recurrence_fwd"):
        monkeypatch.setattr(tdcgru, name, spy(getattr(cr, name)))
    for name in ("dcgru_layer_recurrence_xin", "dcgru_layer_recurrence_fused"):
        monkeypatch.setattr(tdcgru, name, refuse)
    cfg = ExperimentConfig(**_kw("combined", "detection"),
                           input_fusion=input_fusion,
                           test_batch_size=4).finalize()
    pred = Predictor(cfg, build_model(
        cfg, torch.Generator().manual_seed(0)).state_dict(), device="cpu")
    b = _batch("detection")
    probs = pred.predict_proba(b["x"], b["seq_lengths"],
                               adjacency=b["adjacency"])
    assert probs.shape == (B,) and np.all(np.isfinite(probs))
    assert calls == [False] * 4  # 2 batches x 2 layers, no residuals
