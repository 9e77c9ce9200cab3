"""Reference ``.pth.tar`` checkpoints in and out of the port, against the
JAX package's ``io/torch_import.py`` and ``io/torch_export.py`` on the
CPU. Every file is written inside the test (the reference's published
checkpoints are not in the repository).

- A file the JAX package writes (``export_*_state`` +
  ``save_torch_checkpoint``) loads into the port bitwise, and the
  classifier then gives JAX ``classification_apply``'s logits (1e-5 of
  their largest magnitude: float32 summed in another order).
- A file the port writes loads through JAX ``import_*_params`` to the
  port's arrays, bitwise, under the same reference names.
- ``Predictor.from_checkpoint`` on a ``.pth.tar`` gives the probabilities
  of the same weights from a ``.npz``, bitwise; other models raise.
- ``--fine_tune`` from a ``.pth.tar`` transplants the parameters that the
  same fine-tune from a ``.npz`` does, bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from eeg_gnn_tpu.graphs import compute_supports_jnp
from eeg_gnn_tpu.io import torch_export as jexp
from eeg_gnn_tpu.io import torch_import as jimp
from eeg_gnn_tpu.models import dcrnn as jdcrnn
from eeg_gnn_tpu.train import checkpoint as jck
from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.graphs import compute_supports_torch
from eeg_gnn_tpu_torch.io import (
    export_classification_state,
    export_next_time_pred_state,
    import_classification_params,
    import_next_time_pred_params,
    load_torch_state_dict,
    params_from_jax,
    save_torch_checkpoint,
)
from eeg_gnn_tpu_torch.models.registry import build_model
from eeg_gnn_tpu_torch.serve import Predictor
from eeg_gnn_tpu_torch.train.checkpoint import save_params
from eeg_gnn_tpu_torch.train.trainer import warm_start

T, N, D, H, B, C = 6, 19, 12, 8, 5, 4
LOGIT_TOL = 1e-5
SSL = "SS pre-training"


def _cfg(task, layers, **kw):
    return ExperimentConfig(
        task=task, graph_type="combined", num_classes=C, max_seq_len=T,
        output_seq_len=3, num_rnn_layers=layers, rnn_units=H,
        max_diffusion_step=2, input_dim=D, output_dim=D, **kw).finalize()


def _jax_params(task, layers, seed=0):
    cfg = jdcrnn.DCRNNConfig(input_dim=D, output_dim=D, rnn_units=H,
                             num_rnn_layers=layers, max_diffusion_step=2,
                             num_nodes=N, num_supports=1, num_classes=C)
    init = (jdcrnn.init_next_time_pred_model if task == SSL
            else jdcrnn.init_classification_model)
    params = jax.tree_util.tree_map(
        np.asarray, init(jax.random.PRNGKey(seed), cfg))
    return cfg, params


def _assert_state_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("task,layers", [
    ("classification", 1), ("classification", 2), (SSL, 1), (SSL, 2),
    (SSL, 3)])
def test_jax_file_loads_into_the_port(tmp_path, task, layers):
    cfg, params = _jax_params(task, layers)
    path = str(tmp_path / "ckpt.pth.tar")
    if task == SSL:
        jexp.save_torch_checkpoint(
            path, jexp.export_next_time_pred_state(params, layers), epoch=3)
        got = import_next_time_pred_params(load_torch_state_dict(path),
                                           layers)
    else:
        jexp.save_torch_checkpoint(
            path, jexp.export_classification_state(params), epoch=3)
        got = import_classification_params(load_torch_state_dict(path),
                                           layers)
    want = params_from_jax(params)
    _assert_state_equal(got, want)
    model = build_model(_cfg(task, layers))
    model.load_state_dict(got)  # the port's keys and shapes
    if task == SSL:
        return
    rng = np.random.RandomState(1)
    x = rng.randn(B, T, N, D).astype(np.float32)
    lens = np.array([1, T, 2, 4, T])
    adj = np.abs(rng.rand(B, N, N)).astype(np.float32)
    jlogits = np.asarray(jdcrnn.classification_apply(
        cfg, jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(lens), compute_supports_jnp(jnp.asarray(adj),
                                                "laplacian")))
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(x), torch.from_numpy(lens),
                              compute_supports_torch(torch.from_numpy(adj),
                                                     "laplacian")).numpy()
    assert np.abs(logits - jlogits).max() <= \
        LOGIT_TOL * np.abs(jlogits).max()


@pytest.mark.parametrize("task,layers", [
    ("classification", 1), ("classification", 2), (SSL, 1), (SSL, 2),
    (SSL, 3)])
def test_port_file_loads_into_jax(tmp_path, task, layers):
    model = build_model(_cfg(task, layers),
                        torch.Generator().manual_seed(layers))
    state = model.state_dict()
    path = str(tmp_path / "ckpt.pth.tar")
    if task == SSL:
        ref = export_next_time_pred_state(state, layers)
        want_names = jexp.export_next_time_pred_state(
            _jax_params(task, layers)[1], layers)
    else:
        ref = export_classification_state(state)
        want_names = jexp.export_classification_state(
            _jax_params(task, layers)[1])
    assert sorted(ref) == sorted(want_names)
    save_torch_checkpoint(path, ref, epoch=2)
    ckpt = torch.load(path, weights_only=True)
    assert sorted(ckpt) == ["epoch", "model_state", "optimizer_state"]
    assert ckpt["epoch"] == 2
    loaded = jimp.load_torch_state_dict(path)
    tree = (jimp.import_next_time_pred_params(loaded, layers) if task == SSL
            else jimp.import_classification_params(loaded, layers))
    got = params_from_jax(jax.tree_util.tree_map(np.asarray, tree))
    _assert_state_equal(got, {k: v.float() for k, v in state.items()})


def test_bare_state_dict_files_load(tmp_path):
    """A file holding the state dict alone, as some reference checkpoints
    do, reads like ``{'model_state': ...}``."""
    _, params = _jax_params("classification", 2)
    state = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
             jexp.export_classification_state(params).items()}
    torch.save(state, tmp_path / "bare.pth")
    _assert_state_equal(
        import_classification_params(
            load_torch_state_dict(str(tmp_path / "bare.pth")), 2),
        params_from_jax(params))


def test_predictor_from_pth_tar_equals_npz(tmp_path):
    cfg, params = _jax_params("classification", 2)
    jck.save_params(str(tmp_path / "w"), params)
    jexp.save_torch_checkpoint(str(tmp_path / "w.pth.tar"),
                               jexp.export_classification_state(params))
    tcfg = _cfg("classification", 2, test_batch_size=4)
    rng = np.random.RandomState(2)
    x = rng.randn(7, T, N, D).astype(np.float32)
    lens = rng.randint(1, T + 1, size=7)
    adj = np.abs(rng.rand(7, N, N)).astype(np.float32)
    probs = [Predictor.from_checkpoint(str(tmp_path / name), tcfg,
                                       device="cpu").predict_proba(
        x, lens, adjacency=adj) for name in ("w.npz", "w.pth.tar")]
    assert probs[0].shape == (7, C)
    np.testing.assert_array_equal(probs[1], probs[0])
    # a baseline's .pth.tar (the LSTM at this test's widths, whose state
    # dict carries the reference's names) serves as its .npz does
    lcfg = dataclasses.replace(tcfg, model_name="lstm")
    lstm = build_model(lcfg, torch.Generator().manual_seed(5)).state_dict()
    save_torch_checkpoint(str(tmp_path / "lstm.pth.tar"), lstm)
    save_params(str(tmp_path / "lstm"), lstm)
    lprobs = [Predictor.from_checkpoint(str(tmp_path / name), lcfg,
                                        device="cpu").predict_proba(
        x, lens, adjacency=adj) for name in ("lstm.npz", "lstm.pth.tar")]
    assert lprobs[0].shape == (7, C) and np.all(np.isfinite(lprobs[0]))
    np.testing.assert_array_equal(lprobs[1], lprobs[0])


@pytest.mark.parametrize("task,layers,pre_layers", [
    ("classification", 2, 3), ("classification", 1, 2), ("detection", 2, 2)])
def test_fine_tune_from_pth_tar_equals_npz(tmp_path, task, layers,
                                           pre_layers):
    """The transplant of an SSL checkpoint with ``pre_layers`` layers into
    a fresh model's first ``layers`` encoder cells, from the two files of
    the same weights."""
    _, pre = _jax_params(SSL, pre_layers, seed=5)
    jck.save_params(str(tmp_path / "ssl"), pre)
    jexp.save_torch_checkpoint(
        str(tmp_path / "ssl.pth.tar"),
        jexp.export_next_time_pred_state(pre, pre_layers))
    fresh = build_model(_cfg(task, layers),
                        torch.Generator().manual_seed(0)).state_dict()
    got = []
    for name in ("ssl.npz", "ssl.pth.tar"):
        cfg = _cfg(task, layers, fine_tune=True,
                   pretrained_num_rnn_layers=pre_layers,
                   load_model_path=str(tmp_path / name))
        got.append(warm_start(cfg, fresh))
    _assert_state_equal(got[1], got[0])
    pre_sd = params_from_jax(pre)
    for k, v in got[0].items():
        assert torch.equal(v, pre_sd[k] if k.split(".")[0] == "encoder"
                           else fresh[k]), k
