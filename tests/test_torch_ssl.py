"""The port's SSL pre-training slice against the JAX package on the CPU:
the masked regression losses, the curriculum ratio, the next-window
model's forward (``DCRNNNextTimePred`` vs ``next_time_pred_apply``), the
whole SSL train step (``TrainStep`` vs ``make_train_step(ssl_loss_fn(...),
has_batches_seen=True)``) over 3 steps, the weights carried across, and
the entry points' rules.

float32 criterion: rtol 1e-4, atol 1e-5 (tests/test_recurrent.py:316);
parameters after 3 steps atol 1e-5, about 1/30 of one Adam step at lr
3e-4.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_gnn_tpu.config import ExperimentConfig as JaxConfig
from eeg_gnn_tpu.graphs import compute_supports_jnp
from eeg_gnn_tpu.models.dcrnn import compute_sampling_threshold as jax_cst
from eeg_gnn_tpu.models.dcrnn import (
    init_next_time_pred_model,
    next_time_pred_apply,
)
from eeg_gnn_tpu.train import losses as jlosses
from eeg_gnn_tpu.train.checkpoint import save_params
from eeg_gnn_tpu.train.optim import make_optimizer as jax_make_optimizer
from eeg_gnn_tpu.train.step import make_train_step, ssl_loss_fn
from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.graphs import compute_supports_torch
from eeg_gnn_tpu_torch.io import load_jax_npz, params_from_jax
from eeg_gnn_tpu_torch.models.dcgru import (
    decoder_apply,
    draw_force,
    encoder_apply,
)
from eeg_gnn_tpu_torch.models.dcrnn import (
    DCRNNNextTimePred,
    compute_sampling_threshold,
)
from eeg_gnn_tpu_torch.models.registry import build_model
from eeg_gnn_tpu_torch.serve import Predictor
from eeg_gnn_tpu_torch.train import (
    TrainStep,
    compute_regression_loss,
    masked_mae_loss,
    masked_mse_loss,
)

T_IN, T_OUT, N, D, H, B, L, VALID = 5, 3, 19, 12, 16, 4, 3, 3
STEPS_PER_EPOCH, EPOCHS = 2, 3  # the cosine LR moves at step 2
MEAN, STD = 0.25, 1.5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# losses and the curriculum
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("valid", [None, 3, "mask"])
@pytest.mark.parametrize("kind", ["mae", "mse", "regression MAE",
                                  "regression mae"])
def test_ssl_losses_match_jax(rng, kind, valid):
    """Zeros in y are masked out; 'MAE' selects the RMSE branch (the
    reference's case-sensitive dispatch), 'mae' the MAE."""
    if valid == "mask":
        valid = np.array([1, 0, 1, 1, 0], bool)
    y = rng.randn(5, T_OUT, N, D).astype(np.float32)
    y[rng.rand(*y.shape) < 0.2] = 0.0
    pred = rng.randn(*y.shape).astype(np.float32)
    jy, jp = jnp.asarray(y), jnp.asarray(pred)
    ty, tp = torch.from_numpy(y), torch.from_numpy(pred)
    if kind == "mae":
        want = jlosses.masked_mae_loss(jp, jy, valid=valid)
        got = masked_mae_loss(tp, ty, valid=valid)
    elif kind == "mse":
        want = jlosses.masked_mse_loss(jp, jy, valid=valid)
        got = masked_mse_loss(tp, ty, valid=valid)
    else:
        name = kind.split()[1]
        want = jlosses.compute_regression_loss(jy, jp, MEAN, STD, name,
                                               valid=valid)
        got = compute_regression_loss(ty, tp, MEAN, STD, name, valid=valid)
    # f32 means of ~5,700 entries, summed in another order
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_regression_loss_dispatch_quirk(rng):
    y = rng.randn(3, T_OUT, N, D).astype(np.float32)
    pred = torch.from_numpy(y + 0.5)
    y = torch.from_numpy(y)
    assert float(compute_regression_loss(y, pred, loss_fn="MAE")) == \
        pytest.approx(float(masked_mse_loss(pred, y)))
    assert float(compute_regression_loss(y, pred, loss_fn="mae")) == \
        pytest.approx(float(masked_mae_loss(pred, y)))


@pytest.mark.parametrize("step", [0, 3000, 24000])
def test_sampling_threshold_matches_jax(step):
    want = float(jax_cst(3000, jnp.int32(step)))
    assert compute_sampling_threshold(3000, step) == pytest.approx(
        want, rel=1e-6)
    got = compute_sampling_threshold(3000, torch.tensor(step))
    assert float(got) == pytest.approx(want, rel=1e-6)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _kw(graph_type, **kw):
    return dict(task="SS pre-training", graph_type=graph_type,
                max_seq_len=T_IN, num_rnn_layers=L, rnn_units=H,
                max_diffusion_step=2, input_dim=D, output_dim=D,
                num_epochs=EPOCHS, **kw)


def _batch():
    rng = np.random.RandomState(0)
    adj = np.abs(rng.rand(B, N, N)).astype(np.float32)
    adj = (adj + adj.transpose(0, 2, 1)) / 2
    for a in adj:
        np.fill_diagonal(a, 1.0)
    y = rng.randn(B, T_OUT, N, D).astype(np.float32)
    y[rng.rand(*y.shape) < 0.1] = 0.0  # masked entries
    return {"x": rng.randn(B, T_IN, N, D).astype(np.float32), "y": y,
            "adjacency": adj, "valid": VALID}


def _jax_batch(b, filter_type):
    return {"x": jnp.asarray(b["x"]), "y": jnp.asarray(b["y"]),
            "supports": compute_supports_jnp(jnp.asarray(b["adjacency"]),
                                             filter_type),
            "valid": jnp.asarray(VALID, jnp.int32)}


@functools.lru_cache(maxsize=None)
def _jax_params(graph_type):
    jcfg = JaxConfig(do_train=True, **_kw(graph_type)).finalize()
    return jcfg, init_next_time_pred_model(jax.random.PRNGKey(0),
                                           jcfg.dcrnn_config())


@functools.lru_cache(maxsize=None)
def _jax_forward(graph_type):
    jcfg, params = _jax_params(graph_type)
    jb = _jax_batch(_batch(), jcfg.filter_type)
    return np.asarray(next_time_pred_apply(
        jcfg.dcrnn_config(), params, jb["x"], jb["y"], jb["supports"]))


@pytest.mark.parametrize("recurrence", ["pallas", "stacked"])
@pytest.mark.parametrize("input_fusion", [True, False])
@pytest.mark.parametrize("graph_type", ["combined", "individual"])
def test_model_forward_matches_jax(graph_type, input_fusion, recurrence):
    """``DCRNNNextTimePred`` (curriculum off: no teacher forcing) vs
    ``next_time_pred_apply``; "pallas" runs the kernels' plain versions
    here."""
    _, params = _jax_params(graph_type)
    cfg = ExperimentConfig(**_kw(graph_type), input_fusion=input_fusion,
                           recurrence=recurrence).finalize()
    model = build_model(cfg)
    assert isinstance(model, DCRNNNextTimePred)
    model.load_state_dict(params_from_jax(_np(params)))
    b = _batch()
    sup = compute_supports_torch(torch.from_numpy(b["adjacency"]),
                                 cfg.filter_type)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(b["x"]), torch.from_numpy(b["y"]),
                           sup)
    assert got.shape == (B, T_OUT, N, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_forward(graph_type),
                               rtol=1e-4, atol=1e-5)


def test_curriculum_force_comes_from_the_generator():
    """With ``use_curriculum_learning`` in training, the force vector is
    drawn from the generator at the ratio of ``batches_seen``, once per
    call: the same as feeding that draw to ``decoder_apply`` explicitly."""
    cfg = ExperimentConfig(**_kw("combined"),
                           use_curriculum_learning=True).finalize()
    model = build_model(cfg, torch.Generator().manual_seed(0)).train()
    b = _batch()
    x, y = torch.from_numpy(b["x"]), torch.from_numpy(b["y"])
    sup = compute_supports_torch(torch.from_numpy(b["adjacency"]),
                                 cfg.filter_type)
    ratio = compute_sampling_threshold(3000, 24000)
    force = draw_force(T_OUT, ratio, torch.Generator().manual_seed(2), "cpu")
    with torch.no_grad():
        drawn = model(x, y, sup, batches_seen=24000,
                      generator=torch.Generator().manual_seed(2))
        h0, _ = encoder_apply(model.cell_cfgs,
                              [c.params() for c in model.encoder], sup,
                              x.transpose(0, 1))
        given = decoder_apply(model.dec_cfgs, model.decoder.params(), sup,
                              y.transpose(0, 1), h0, L, force=force,
                              training=True).transpose(0, 1)
        unforced = model(x, y, sup)
    torch.testing.assert_close(drawn, given, rtol=0, atol=0)
    # a step before the last is forced, so the feedback changed
    assert force[:-1].sum() > 0 and not torch.equal(drawn, unforced)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_run(graph_type):
    """JAX: step-1 loss and gradients, and the losses and params of 3
    ``make_train_step(ssl_loss_fn(...), has_batches_seen=True)`` steps
    (stacked recurrence on the CPU; curriculum off)."""
    jcfg, params = _jax_params(graph_type)
    jb = _jax_batch(_batch(), jcfg.filter_type)
    mcfg = jcfg.dcrnn_config()
    loss_fn = ssl_loss_fn(mcfg, jnp.float32(MEAN), jnp.float32(STD))
    key = jax.random.PRNGKey(1)
    (_, _), grads = jax.value_and_grad(
        lambda p: loss_fn(p, {}, jb, key, True, jnp.int32(0)),
        has_aux=True)(params)
    opt = jax_make_optimizer(jcfg.lr_init, jcfg.l2_wd, jcfg.max_grad_norm,
                             jcfg.num_epochs, STEPS_PER_EPOCH)
    train_step = make_train_step(loss_fn, opt, has_batches_seen=True,
                                 donate=False)
    p, o, losses = params, opt.init(params), []
    for i in range(3):
        p, _, o, loss = train_step(p, {}, o, jb, key, jnp.int32(i * B))
        losses.append(float(loss))
    return _np(grads), losses, _np(p)


@pytest.mark.parametrize("graph_type", ["combined", "individual"])
def test_ssl_train_step_matches_jax(graph_type):
    """The slice as a whole (3 layers, B=4 with valid=3, mean/std given):
    step-1 gradients, the losses of 3 steps, and the parameters after
    them."""
    _, params = _jax_params(graph_type)
    grads, losses, final = _jax_run(graph_type)
    cfg = ExperimentConfig(**_kw(graph_type)).finalize()
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(_np(params)))
    step = TrainStep(cfg, model, STEPS_PER_EPOCH, device="cpu", mean=MEAN,
                     std=STD)
    batch = _batch()
    got = [float(step.loss_and_grads(batch, batches_seen=0))]
    named = dict(step.model.named_parameters())
    want_grads = params_from_jax(grads)
    assert set(want_grads) == set(named)
    for name, want in want_grads.items():
        np.testing.assert_allclose(named[name].grad.numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    step.update()
    got += [float(step(batch, batches_seen=(i + 1) * B)) for i in range(2)]
    np.testing.assert_allclose(got, losses, rtol=1e-4, atol=1e-5)
    sd = step.model.state_dict()
    for name, want in params_from_jax(final).items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_ssl_step_supports_argument_and_row_mask():
    """Precomputed ``supports`` and ``valid`` as a row mask give the step
    that ``adjacency`` and the equal count give; with the curriculum on,
    steps from one generator seed repeat."""
    cfg = ExperimentConfig(**_kw("individual"),
                           use_curriculum_learning=True).finalize()
    batch = _batch()
    sup = compute_supports_torch(torch.from_numpy(batch["adjacency"]),
                                 cfg.filter_type)
    alt = {k: v for k, v in batch.items() if k != "adjacency"}
    alt.update(supports=sup.numpy(), valid=np.arange(B) < VALID)
    losses = []
    for b in (batch, alt):
        step = TrainStep(cfg, build_model(cfg, torch.Generator().manual_seed(
            3)), STEPS_PER_EPOCH, device="cpu",
            generator=torch.Generator().manual_seed(2))
        losses.append([float(step(b, batches_seen=24000)) for _ in range(2)])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)


# ---------------------------------------------------------------------------
# weights carried across, entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_layers", [1, 3])
def test_ssl_npz_round_trip(tmp_path, num_layers):
    """A JAX SSL tree saved with ``save_params`` loads key for key (no
    shared cell with one layer)."""
    jcfg = JaxConfig(do_train=True,
                     **_kw("combined") | {"num_rnn_layers": num_layers}
                     ).finalize()
    params = init_next_time_pred_model(jax.random.PRNGKey(3),
                                       jcfg.dcrnn_config())
    path = os.path.join(tmp_path, "ssl")
    save_params(path, params)
    cfg = ExperimentConfig(**_kw("combined") | {"num_rnn_layers": num_layers}
                           ).finalize()
    sd = load_jax_npz(path, cfg)
    want = params_from_jax(_np(params))
    assert set(sd) == set(want) == set(build_model(cfg).state_dict())
    assert any(k.startswith("decoder.shared") for k in sd) == \
        (num_layers > 1)
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
    np.testing.assert_array_equal(
        sd["decoder.proj.weight"].numpy(),
        np.asarray(params["decoder"]["proj_w"]))


def test_ssl_init_statistics():
    """The generator's init: xavier-normal cells, zero biases, the
    projection uniform in +-1/sqrt(H), the shared cell drawn once."""
    cfg = ExperimentConfig(**_kw("combined") | {"rnn_units": 64}).finalize()
    sd = build_model(cfg, torch.Generator().manual_seed(0)).state_dict()
    w = sd["decoder.shared.gate_w"]
    std = 1.414 * (2.0 / (w.shape[0] + w.shape[1])) ** 0.5
    assert float(w.std()) == pytest.approx(std, rel=0.05)
    assert float(sd["decoder.layer0.gate_b"].abs().max()) == 0.0
    bound = 1.0 / 64 ** 0.5
    p = sd["decoder.proj.weight"]
    assert p.shape == (D, 64) and float(p.abs().max()) <= bound
    assert float(p.abs().max()) > 0.9 * bound


def test_ssl_entry_points(monkeypatch):
    cfg = ExperimentConfig(**_kw("combined")).finalize()
    assert cfg.dcrnn_config().output_dim == D
    assert cfg.dcrnn_config().cl_decay_steps == 3000
    assert not cfg.dcrnn_config().use_curriculum_learning
    model = build_model(cfg)
    assert isinstance(model, DCRNNNextTimePred)
    assert not any(p.detach().any() for p in model.parameters())
    with pytest.raises(ValueError, match="serves detection"):
        Predictor(cfg, model.state_dict(), device="cpu")
    with pytest.raises(ValueError, match="unknown task"):
        build_model(dataclasses.replace(cfg, task="regression"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="TrainStep: no CUDA device"):
            TrainStep(cfg, build_model(cfg), 1, device=device)
