"""The port's LSTM, CNN-LSTM and Dense-CNN baselines against the JAX
package on the CPU: the models (eval forward, gradients, the Dense-CNN's
BatchNorm in training, the CNN-LSTM's batch-axis scan, dropout), their
``.pth.tar`` importers, the JAX parameter trees and the ``.state.npz``
files, one ``TrainStep`` each against JAX ``make_train_step``, and
``Predictor`` against the JAX ``Predictor``.

Sizes: LSTM 2 layers x 16 units on (B, T=6, N=19, D=100); CNN-LSTM at its
fixed widths (N=19, D=100), B=4, T=6; Dense-CNN 4 classes on a (700, 19)
plane (7 s of FFT bins, the least its fc1 takes: ~16 GFLOP a clip
forward), B=4. Inputs from a seeded numpy stream, weights
from the JAX initialisation carried across (``io.params_from_jax``).
Tolerances: forward 1e-5 (the Dense-CNN's training-mode logits 1e-4:
BatchNorm over 3-4 rows) and gradients 1e-4, each as the normalized
inf-norm error max|port - JAX| / max|JAX|; parameters after one Adam step
at atol 1e-5 (a thirtieth of a step at lr 3e-4). The Dense-CNN's
gradients and train step run in float64 on both sides (B=2 and 3): the
gradients of its max-pools jump at ties, and float32 rounding flips a
near tie's choice (on a (1200, 19) plane, B=4, one window of the last
pool, its two largest values 1.0e-6 apart, moved the port's float32
gradients of every earlier layer by 1-3% against float64; JAX's float32
rounding happened to keep it), which Adam's first step, lr * g / |g|,
turns into whole steps of the other sign.
"""

import functools
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_gnn_tpu.config import ExperimentConfig as JaxConfig
from eeg_gnn_tpu.io import torch_import as jimp
from eeg_gnn_tpu.models import densecnn as jdensecnn
from eeg_gnn_tpu.models.cnnlstm import cnnlstm_apply
from eeg_gnn_tpu.models.lstm import lstm_model_apply
from eeg_gnn_tpu.models.registry import build_model as jax_build_model
from eeg_gnn_tpu.serve import Predictor as JaxPredictor
from eeg_gnn_tpu.train import checkpoint as jck
from eeg_gnn_tpu.train.optim import make_optimizer as jax_make_optimizer
from eeg_gnn_tpu.train.step import make_train_step, supervised_loss_fn
from eeg_gnn_tpu.train.trainer import _pad_batch as jax_pad_batch
from eeg_gnn_tpu.data.loader import Batch as JaxBatch
from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.io import (
    import_params_for,
    load_params_like,
    load_torch_state_dict,
    params_from_jax,
    params_to_jax,
    save_torch_checkpoint,
    state_to_jax,
)
from eeg_gnn_tpu_torch.models import densecnn as tdensecnn
from eeg_gnn_tpu_torch.models.dcrnn import last_relevant
from eeg_gnn_tpu_torch.models.registry import build_model
from eeg_gnn_tpu_torch.serve import Predictor
from eeg_gnn_tpu_torch.train import TrainStep
from eeg_gnn_tpu_torch.train.checkpoint import CheckpointSaver
from eeg_gnn_tpu_torch.train.trainer import pad_batch

T, N, D, H, B = 6, 19, 100, 16, 4
DC_TIME, DC_CLASSES = 700, 4   # the Dense-CNN's (time, 19) plane
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
# training-mode Dense-CNN logits: the batch statistics of 3-4 rows subtract
# nearly equal values, which scales fc1's float32 rounding by max|h| / std
BN_TOL = 1e-4
FAMILIES = ("lstm", "cnnlstm", "densecnn")


def _kw(name):
    kw = dict(model_name=name, use_fft=True, do_train=True, max_seq_len=T,
              input_dim=D, num_epochs=3, test_batch_size=B)
    if name == "lstm":
        kw.update(rnn_units=H, num_rnn_layers=2)
    if name == "densecnn":
        kw.update(task="classification", num_classes=DC_CLASSES,
                  max_seq_len=DC_TIME // 100, metric_name="F1")
    return kw


def _cfgs(name):
    return (JaxConfig(**_kw(name)).finalize(),
            ExperimentConfig(**_kw(name)).finalize())


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _init(name):
    """The initial (params, model state) as JAX-layout numpy trees: the
    JAX initialisation, but the Dense-CNN's drawn by the port from a
    seeded generator (JAX draws its ~5M weights in 20-40 s on the CPU)."""
    if name == "densecnn":
        sd = build_model(_cfgs(name)[1],
                         torch.Generator().manual_seed(0)).state_dict()
        return params_to_jax(sd), state_to_jax(sd)
    params, state = jax_build_model(_cfgs(name)[0]).init(
        jax.random.PRNGKey(0))
    return _np(params), _np(state)


def _batch(name, n=B, seed=0):
    rng = np.random.RandomState(seed)
    shape = (n, DC_TIME, N) if name == "densecnn" else (n, T, N, D)
    y = (rng.randint(0, DC_CLASSES, size=n) if name == "densecnn"
         else rng.randint(0, 2, size=n).astype(np.float32))
    lens = rng.randint(1, T + 1, size=n)
    lens[0] = T
    return {"x": rng.randn(*shape).astype(np.float32), "y": y,
            "seq_lengths": lens}


def _model(name, params=None, state=None):
    tcfg = _cfgs(name)[1]
    p, s = _init(name)
    model = build_model(tcfg)
    model.load_state_dict(params_from_jax(p if params is None else params,
                                          s if state is None else state))
    return model


def _norm_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


@functools.partial(jax.jit, static_argnums=(0,),
                   static_argnames=("training",))
def _jax_logits(name, params, state, x, lens, training=False):
    """The JAX forward named in the module docstring (dropout 0)."""
    if name == "lstm":
        return lstm_model_apply(params, x, lens, num_layers=2,
                                hidden_size=H, training=training), state
    if name == "cnnlstm":
        return cnnlstm_apply(params, x, lens, training=training), state
    x = jnp.swapaxes(x, -1, -2).reshape(x.shape[0], -1, N)  # the scramble
    return jdensecnn.densecnn_apply(params, state, x,
                                    num_classes=DC_CLASSES,
                                    training=training, dropout_rate=0.0)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_eval_forward_matches_jax(name):
    """Eval mode; the Dense-CNN through the JAX registry bundle (the
    reference's train.py scramble and the one-class squeeze included)."""
    p, s = _init(name)
    b = _batch(name)
    if name == "densecnn":
        want, _ = jax.jit(functools.partial(
            jax_build_model(_cfgs(name)[0]).apply, training=False))(
            p, s, {"x": jnp.asarray(b["x"])})
    else:
        want, _ = _jax_logits(name, p, s, b["x"], b["seq_lengths"])
    model = _model(name).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(b["x"]),
                    torch.from_numpy(b["seq_lengths"]), None)
    assert got.shape == want.shape
    assert _norm_err(got, want) <= FWD_TOL


@pytest.mark.parametrize("name", FAMILIES)
def test_gradients_match_jax(name, monkeypatch):
    """Training mode at dropout 0 (the Dense-CNN's BatchNorm on batch
    statistics, both packages in float64): the gradient of sum(logits *
    a seeded cotangent) with respect to every parameter, against
    ``jax.grad``."""
    monkeypatch.setattr(tdensecnn, "DROPOUT_RATE", 0.0)
    f64 = name == "densecnn"
    dtype = np.float64 if f64 else np.float32
    p, s = jax.tree_util.tree_map(lambda a: a.astype(dtype), _init(name))
    b = _batch(name, 2 if f64 else B)
    x = b["x"].astype(dtype)
    cot = np.random.RandomState(7).randn(
        len(x), DC_CLASSES if name == "densecnn" else 1).astype(dtype)

    def loss(params):
        logits, _ = _jax_logits(name, params, s, x, b["seq_lengths"],
                                training=True)
        return jnp.sum(logits * cot)

    with jax.enable_x64(f64):
        want = params_from_jax(_np(jax.jit(jax.grad(loss))(p)), s)
    model = _model(name).train().to(torch.float64 if f64 else torch.float32)
    out = model(torch.from_numpy(x), torch.from_numpy(b["seq_lengths"]),
                None)
    (out * torch.from_numpy(cot)).sum().backward()
    named = dict(model.named_parameters())
    for key, g in named.items():
        if g.grad is None:  # the Dense-CNN's never-called stages
            assert not np.any(want[key].numpy()), key
        elif key == "dense_inception.fc1.bias":  # BatchNorm follows: 0
            scale = float(named[key[:-4] + "weight"].grad.abs().max())
            assert float(g.grad.abs().max()) <= 1e-10 * scale
            assert float(want[key].abs().max()) <= 1e-10 * scale
        else:
            assert _norm_err(g.grad, want[key]) <= GRAD_TOL, key
    assert named.keys() <= want.keys()


@pytest.mark.parametrize("rows", [B, B - 1])
def test_densecnn_training_batchnorm_matches_jax(rows, monkeypatch):
    """Training mode, dropout 0 on both sides: logits and the new running
    statistics against JAX's ``new_state``; a partial batch of 3 padded
    to 4 by ``trainer.pad_batch`` as JAX ``_pad_batch`` pads it (row 0
    repeated), so the statistics see the repeated row."""
    monkeypatch.setattr(tdensecnn, "DROPOUT_RATE", 0.0)
    p, s = _init("densecnn")
    b = _batch("densecnn", rows)
    host = pad_batch(dict(b, supports=None), B)
    jb, valid = jax_pad_batch(JaxBatch(b["x"], b["y"], b["seq_lengths"],
                                       None, None, ["c"] * rows), B)
    assert valid == rows and host.get("valid", B) == rows
    for k in ("x", "y", "seq_lengths"):
        np.testing.assert_array_equal(host[k], getattr(jb, k))
    want, new_state = _jax_logits("densecnn", p, s, jb.x, None,
                                  training=True)
    model = _model("densecnn").train()
    with torch.no_grad():
        got = model(torch.from_numpy(host["x"]), None, None)
    assert _norm_err(got, want) <= BN_TOL
    got_state = state_to_jax(model.state_dict())["fcbn1"]
    for k in ("mean", "var"):
        assert _norm_err(got_state[k], new_state["fcbn1"][k]) <= FWD_TOL, k
    assert not np.allclose(got_state["mean"], s["fcbn1"]["mean"])


def test_cnnlstm_scans_the_batch_axis_as_jax_does():
    """Permuting a batch's rows changes the outputs beyond a permutation
    (clip i sees clips 0..i-1), identically in both packages; rows
    appended at the end change no earlier row."""
    p, s = _init("cnnlstm")
    b = _batch("cnnlstm")
    perm = np.array([2, 0, 3, 1])
    model = _model("cnnlstm").eval()

    def port(x, lens):
        with torch.no_grad():
            return model(torch.from_numpy(x), torch.from_numpy(lens),
                         None).numpy()

    base = port(b["x"], b["seq_lengths"])
    permuted = port(b["x"][perm], b["seq_lengths"][perm])
    assert np.abs(permuted - base[perm]).max() > 1e-4
    want, _ = _jax_logits("cnnlstm", p, s, b["x"][perm],
                          b["seq_lengths"][perm])
    assert _norm_err(permuted, want) <= FWD_TOL
    padded = port(np.concatenate([b["x"], b["x"][:2] * 0]),
                  np.concatenate([b["seq_lengths"], [1, 1]]))
    assert _norm_err(padded[:B], base) <= FWD_TOL


@pytest.mark.parametrize("name", ["lstm", "densecnn"])
def test_dropout_draws_from_the_step_generator(name, monkeypatch):
    """Rate 0.2 (the LSTM's ``--dropout``; the Dense-CNN's hardcoded
    ``DROPOUT_RATE``, read at each call) and scale 1/0.8: the input of
    the head is the ReLU'd features masked by ``torch.rand(...,
    generator) < 0.8`` and divided by 0.8, the generator the one the
    forward is given."""
    cfg = ExperimentConfig(**dict(_kw(name), dropout=0.2)).finalize()
    model = build_model(cfg, torch.Generator().manual_seed(3)).train()
    head = model.fc if name == "lstm" else model.dense_inception.fc2
    seen = {}
    head.register_forward_pre_hook(lambda m, a: seen.update(head=a[0]))
    if name == "lstm":
        model.lstm.register_forward_hook(
            lambda m, a, out: seen.update(feat=out[0]))
    else:
        model.dense_inception.fcbn1.register_forward_hook(
            lambda m, a, out: seen.update(feat=out))
    b = _batch(name, 16 if name == "densecnn" else 64)
    x, lens = torch.from_numpy(b["x"]), torch.from_numpy(b["seq_lengths"])
    with torch.no_grad():
        model(x, lens, None, torch.Generator().manual_seed(11))
    feat = seen["feat"]
    if name == "lstm":
        feat = last_relevant(feat, lens)
    mask = torch.rand(feat.shape,
                      generator=torch.Generator().manual_seed(11)) < 0.8
    # the LSTM drops out, then ReLUs; the Dense-CNN the other way round:
    # the same values, as ReLU commutes with the scale and keeps 0
    want = torch.where(mask, torch.relu(feat) / 0.8, torch.zeros_like(feat))
    torch.testing.assert_close(seen["head"], want, rtol=0, atol=0)
    assert 0.74 < float(mask.float().mean()) < 0.86  # ~5 sigma
    if name == "densecnn":
        monkeypatch.setattr(tdensecnn, "DROPOUT_RATE", 0.0)
        with torch.no_grad():
            model(x, lens, None, torch.Generator().manual_seed(11))
        torch.testing.assert_close(seen["head"], torch.relu(seen["feat"]),
                                   rtol=0, atol=0)


# ---------------------------------------------------------------------------
# checkpoints: .pth.tar importers, JAX trees, .state.npz
# ---------------------------------------------------------------------------


def _trained_state(rng):
    """A Dense-CNN model state away from the initial one."""
    return {"fcbn1": {"mean": rng.randn(128).astype(np.float32),
                      "var": (rng.rand(128) + 0.5).astype(np.float32)}}


@pytest.mark.parametrize("name,count", [("lstm", True), ("cnnlstm", True),
                                        ("densecnn", True),
                                        ("densecnn", False)])
def test_pth_tar_importers_match_jax(name, count, tmp_path, rng):
    """A reference-keyed state dict written with ``torch.save`` as a
    ``.pth.tar`` (the Dense-CNN's with trained running statistics, with
    and without ``num_batches_tracked``), read by the port's importer and
    by the JAX one (``import_densecnn_params(state, init_densecnn_params
    (...))`` called directly)."""
    p, s = _init(name)
    if name == "densecnn":
        s = _trained_state(rng)
    sd = params_from_jax(p, s)
    if not count:
        del sd["dense_inception.fcbn1.num_batches_tracked"]
    path = str(tmp_path / "ref.pth.tar")
    torch.save({"epoch": 3, "model_state": sd, "optimizer_state": {}}, path)
    got = import_params_for(_cfgs(name)[1], load_torch_state_dict(path))
    ref = jimp.load_torch_state_dict(path)
    if name == "lstm":
        want = params_from_jax(jimp.import_lstm_params(ref, 2))
    elif name == "cnnlstm":
        want = params_from_jax(jimp.import_cnnlstm_params(ref))
    else:
        template = jax.eval_shape(  # its tree; the importer reads its keys
            lambda: jdensecnn.init_densecnn_params(
                jax.random.PRNGKey(0), (DC_TIME, N), DC_CLASSES))
        jp, js = jimp.import_densecnn_params(ref, template)
        want = params_from_jax(_np(jp), _np(js))
    assert got.keys() == want.keys() == build_model(
        _cfgs(name)[1]).state_dict().keys()
    for k in want:
        torch.testing.assert_close(got[k].to(want[k].dtype), want[k],
                                   rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("name", FAMILIES)
def test_jax_trees_and_state_files_round_trip(name, tmp_path, rng):
    """``params_to_jax(params_from_jax(t)) == t`` (and the model state);
    ``CheckpointSaver`` writes the JAX file set (``.state.npz`` for the
    Dense-CNN only), which both packages read back."""
    p, s = _init(name)
    if name == "densecnn":
        s = _trained_state(rng)
    sd = params_from_jax(p, s)
    tree, state = params_to_jax(sd), state_to_jax(sd)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(p)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree_util.tree_structure(state) == \
        jax.tree_util.tree_structure(s)
    model = build_model(_cfgs(name)[1])
    model.load_state_dict(sd)
    opt = TrainStep(_cfgs(name)[1], model, 1, device="cpu").optimizer
    saver = CheckpointSaver(str(tmp_path), "F1", True)
    saver.save(1, model.state_dict(), opt, 0.5)
    files = sorted(f.name for f in tmp_path.iterdir())
    want_files = ["best.npz", "best.opt.npz", "last.json", "last.npz",
                  "last.opt.npz"]
    if name == "densecnn":
        want_files += ["best.state.npz", "last.state.npz"]
    assert files == sorted(want_files)
    back = load_params_like(saver.best_path, build_model(_cfgs(name)[1])
                            .state_dict(), with_state=True)
    for k, v in sd.items():
        torch.testing.assert_close(back[k].to(v.dtype), v, rtol=0, atol=0)
    jax_params = jck.load_params_like(saver.best_path, p)
    for a, b in zip(jax.tree_util.tree_leaves(jax_params),
                    jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(a, b)
    if name == "densecnn":
        js = jck.load_params_like(str(tmp_path / "best.state.npz"),
                                  _init(name)[1])
        np.testing.assert_array_equal(js["fcbn1"]["var"], s["fcbn1"]["var"])
        # without with_state the template's (initial) statistics stay
        plain = load_params_like(saver.best_path,
                                 build_model(_cfgs(name)[1]).state_dict())
        assert not torch.any(plain["dense_inception.fcbn1.running_mean"])


# ---------------------------------------------------------------------------
# the train step and the Predictor
# ---------------------------------------------------------------------------


def _step_batch(name):
    """The family's train batch: the Dense-CNN's 2 rows padded to 3 (its
    train batch size here) by ``trainer.pad_batch``, valid=2, in
    float64."""
    if name != "densecnn":
        return _batch(name)
    b = pad_batch(_batch(name, 2), 3)
    return dict(b, x=b["x"].astype(np.float64))


def _jax_step(name):
    """JAX ``make_train_step`` once on ``_step_batch`` (the Dense-CNN's
    padded as JAX ``_pad_batch`` pads it, dropout 0, float64): (loss,
    params, model state)."""
    jcfg = _cfgs(name)[0]
    b = _step_batch(name)
    f64 = name == "densecnn"
    if f64:
        raw = _batch(name, 2)
        jb, valid = jax_pad_batch(JaxBatch(raw["x"], raw["y"],
                                           raw["seq_lengths"], None, None,
                                           ["c", "c"]), 3)
        np.testing.assert_array_equal(jb.x, b["x"])
        np.testing.assert_array_equal(jb.y, b["y"])
        assert valid == b["valid"] == 2
    apply = jdensecnn.densecnn_apply
    with mock.patch.object(jdensecnn, "densecnn_apply",
                           lambda *a, **k: apply(*a, **dict(
                               k, dropout_rate=0.0))), jax.enable_x64(f64):
        bundle = jax_build_model(jcfg)
        p, s = jax.tree_util.tree_map(
            lambda a: a.astype(np.float64 if f64 else np.float32),
            _init(name))
        opt = jax_make_optimizer(jcfg.lr_init, jcfg.l2_wd,
                                 jcfg.max_grad_norm, jcfg.num_epochs, 2)
        step = make_train_step(supervised_loss_fn(bundle, jcfg.task), opt,
                               donate=False)
        jb = {k: jnp.asarray(b[k]) for k in ("x", "y", "seq_lengths")}
        jb.update(supports=None,
                  valid=jnp.asarray(b.get("valid", len(b["x"])), jnp.int32))
        p, s, _, loss = step(p, s, opt.init(p), jb, jax.random.PRNGKey(1))
        return float(loss), _np(p), _np(s)


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_jax(name, monkeypatch):
    """One ``TrainStep`` (BCE for LSTM and CNN-LSTM detection; CE for the
    Dense-CNN's 4 classes on a padded partial batch, valid=2, in float64)
    against JAX ``make_train_step``: the loss, every parameter after the
    Adam step (the never-called stages decayed by L2, as optax decays
    them) and the running statistics."""
    monkeypatch.setattr(tdensecnn, "DROPOUT_RATE", 0.0)
    loss, want_p, want_s = _jax_step(name)
    model = _model(name)
    if name == "densecnn":
        model = model.double()
    step = TrainStep(_cfgs(name)[1], model, 2, device="cpu")
    got = float(step(_step_batch(name)))
    np.testing.assert_allclose(got, loss, rtol=1e-5)
    sd = step.model.state_dict()
    for k, v in params_from_jax(want_p, want_s).items():
        if k.endswith("num_batches_tracked"):  # no JAX counterpart
            continue
        np.testing.assert_allclose(sd[k].float().numpy(), v.numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    p0 = params_from_jax(*_init(name))
    assert all(not torch.equal(p0[k], sd[k].float())
               for k, _ in step.model.named_parameters()
               if not k.endswith("fc1.bias"))  # 0 gradient: BatchNorm


@pytest.mark.parametrize("name", FAMILIES)
def test_predictor_matches_jax(name, tmp_path, rng):
    """5 clips at batch 4 (one padded chunk), supports passed (which the
    baselines ignore): probabilities against the JAX ``Predictor`` given
    the same weights and model state; the Dense-CNN's from a ``.npz``
    with its ``.state.npz`` and from a ``.pth.tar``, bitwise equal, and
    served with the trained running statistics."""
    p, s = _init(name)
    if name == "densecnn":
        s = _trained_state(rng)
    jcfg, tcfg = _cfgs(name)
    b = _batch(name, 5, seed=3)
    sup = np.abs(rng.rand(2, 5, N, N)).astype(np.float32)
    want = JaxPredictor(jcfg, p, s, batch_size=B).predict_proba(
        b["x"], b["seq_lengths"], supports=sup)
    pred = Predictor(tcfg, params_from_jax(p, s), batch_size=B,
                     device="cpu")
    got = pred.predict_proba(b["x"], b["seq_lengths"], supports=sup)
    assert got.shape == want.shape
    assert _norm_err(got, want) <= FWD_TOL
    with pytest.raises(ValueError, match="supports required"):
        pred.predict_proba(b["x"], b["seq_lengths"])
    model = build_model(tcfg)
    model.load_state_dict(params_from_jax(p, s))
    saver = CheckpointSaver(str(tmp_path), "F1", True)
    saver.save(1, model.state_dict(),
               TrainStep(tcfg, build_model(tcfg), 1, device="cpu").optimizer,
               0.5)
    save_torch_checkpoint(str(tmp_path / "w.pth.tar"), model.state_dict())
    probs = [Predictor.from_checkpoint(str(tmp_path / f), tcfg, batch_size=B,
                                       device="cpu").predict_proba(
        b["x"], b["seq_lengths"], supports=sup)
        for f in ("best.npz", "w.pth.tar")]
    np.testing.assert_array_equal(probs[0], got)
    np.testing.assert_array_equal(probs[1], got)
    if name == "densecnn":  # the initial statistics serve other values
        initial = Predictor(tcfg, params_from_jax(p), batch_size=B,
                            device="cpu").predict_proba(
            b["x"], b["seq_lengths"], supports=sup)
        assert _norm_err(got, initial) > 1e-3
