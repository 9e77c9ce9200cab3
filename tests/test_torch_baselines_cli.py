"""The baselines' runs against the JAX package on the CPU: ``run_experiment``
in both packages (``test_torch_cli._run_both`` / ``_assert_runs_agree``:
the same steps' losses, dev/test results, ``best.npz`` and the run's
file set) for LSTM and CNN-LSTM detection on the 4 x 96 s corpus, 12 s
clips, batches of 4 and 8, 2 epochs, and for the Dense-CNN's 4-class
classification on the flat-clip dataset of an 8 x 56 s corpus of 7 s
clips (a (700, 19) plane, the least its fc1 takes); then
``cli.train.main`` once end to end for each family.

``best.npz`` at atol 3e-5, a tenth of one Adam step at lr 3e-4: Adam
turns float32 summation-order noise in near-zero gradients into weight
differences (in these runs at most 2.6e-5, in 4 of the LSTM's 121,600
input weights, and 8.2e-6 in 48 of the CNN-LSTM's 5.5M fc1 weights).

JAX hardcodes the Dense-CNN's dropout at 0.2, whose masks the two
packages draw from different generators, so its run sets the rate to 0 on
both sides (JAX's ``densecnn_apply``, which its registry imports at call
time; the port's ``models.densecnn.DROPOUT_RATE``). It also draws its
initial weights from the port's seeded generator in both packages (JAX's
``init_densecnn_params`` takes 20-40 s on the CPU), and trains at lr 1e-7:
the Dense-CNN's float32 gradients are not reproducible across
implementations (its max-pools' gradients jump at near ties, and
BatchNorm zeroes fc1's bias gradient up to rounding), and Adam's first
steps, lr * g / |g|, turn that into whole steps of either sign; at lr
1e-7 those stay below the atol, while the losses, the BatchNorm running
statistics (momentum 0.1, whatever the lr), the checkpoints and the dev
and test results are compared as for the other runs. Its Adam step is
held to JAX in float64 in ``test_torch_baselines.py``.
"""

import json
import os

import numpy as np
import pytest

import torch

from eeg_gnn_tpu.models import densecnn as jdensecnn
from eeg_gnn_tpu.data.synthetic import make_synthetic_corpus
from eeg_gnn_tpu_torch.cli import train as cli
from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.io import params_to_jax, state_to_jax
from eeg_gnn_tpu_torch.models import densecnn as tdensecnn
from eeg_gnn_tpu_torch.models.registry import build_model

from test_torch_cli import CLIP, _assert_runs_agree, _kw, _metrics, _run_both

DC_CLIP = 7      # seconds: the Dense-CNN's (700, 19) plane
PARAM_ATOL = 3e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    return make_synthetic_corpus(root, num_files=4, file_seconds=96,
                                 clip_len=CLIP, seed=0)


@pytest.fixture(scope="module")
def dc_corpus(tmp_path_factory):
    """7 train seizures (one partial batch of 3 at B=4), 2 dev, 3 test."""
    root = str(tmp_path_factory.mktemp("dc_corpus"))
    return make_synthetic_corpus(root, num_files=8, file_seconds=56,
                                 clip_len=DC_CLIP, seed=1)


@pytest.mark.parametrize("model_name", ["lstm", "cnnlstm"])
def test_detection_run_matches_jax(corpus, tmp_path, model_name):
    """LSTM (1 layer x 16 units) and CNN-LSTM detection, combined graph
    (the loaders still build supports, which the baselines ignore)."""
    jres, tres, jdir, tdir, cfg, _ = _run_both(
        corpus, tmp_path, _kw(corpus, "detection", "combined",
                              model_name=model_name))
    assert "best.state.npz" not in os.listdir(tdir)
    _assert_runs_agree(corpus, jres, tres, jdir, tdir, cfg,
                       param_atol=PARAM_ATOL)


def test_densecnn_classification_run_matches_jax(dc_corpus, tmp_path,
                                                 monkeypatch):
    """The flat (700, 19) clips, 4 classes, B=4 (the last train batch
    padded to 4 in both packages), lr 1e-7; ``best.state.npz`` (the
    running statistics) against JAX's."""
    kw = _kw(dc_corpus, "classification", "combined", model_name="densecnn",
             max_seq_len=DC_CLIP, lr_init=1e-7)
    sd = build_model(ExperimentConfig(**kw).finalize(),
                     torch.Generator().manual_seed(0)).state_dict()
    init = (params_to_jax(sd), state_to_jax(sd))
    monkeypatch.setattr(jdensecnn, "init_densecnn_params",
                        lambda *a, **k: init)
    apply = jdensecnn.densecnn_apply
    monkeypatch.setattr(jdensecnn, "densecnn_apply",
                        lambda *a, **k: apply(*a, **dict(k,
                                                         dropout_rate=0.0)))
    monkeypatch.setattr(tdensecnn, "DROPOUT_RATE", 0.0)
    jres, tres, jdir, tdir, cfg, _ = _run_both(dc_corpus, tmp_path, kw)
    _assert_runs_agree(dc_corpus, jres, tres, jdir, tdir, cfg)
    with np.load(os.path.join(jdir, "best.state.npz")) as a, \
            np.load(os.path.join(tdir, "best.state.npz")) as b:
        assert sorted(a.files) == sorted(b.files) == ["fcbn1/mean",
                                                      "fcbn1/var"]
        for k in a.files:
            assert not np.allclose(a[k], init[1]["fcbn1"][k.split("/")[1]])
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("model_name,task", [
    ("lstm", "detection"), ("cnnlstm", "detection"),
    ("densecnn", "classification")])
def test_cli_main_runs_a_baseline(corpus, dc_corpus, tmp_path, model_name,
                                  task):
    """``cli.train.main --model_name ...`` end to end on the CPU, with
    ``--device_pipeline`` and ``--hbm_cache`` accepted and unused (they
    serve DCRNN only, as in the JAX CLI); the Dense-CNN's classification
    reads the flat-clip dataset."""
    p = dc_corpus if task == "classification" else corpus
    clip = DC_CLIP if task == "classification" else CLIP
    argv = ["--task", task, "--model_name", model_name, "--do_train",
            "--max_seq_len", str(clip), "--use_fft", "--rnn_units", "16",
            "--num_rnn_layers", "1", "--train_batch_size", "4",
            "--test_batch_size", "8", "--num_epochs", "1",
            "--num_workers", "1", "--device_pipeline", "--hbm_cache",
            "--input_dir", p["input_dir"], "--raw_data_dir",
            p["raw_data_dir"], "--marker_dir", p["marker_dir"],
            "--adj_mat_dir", p["adj_mat_dir"],
            "--save_dir", str(tmp_path / "save")]
    if task == "classification":
        argv += ["--num_classes", "4", "--metric_name", "F1"]
    res = cli.main(argv, device="cpu")
    run_dir = tmp_path / "save" / "train" / "train-01"
    names = {"args.json", "metrics.jsonl", "best.npz", "last.npz",
             "results.json"}
    if model_name == "densecnn":
        names |= {"best.state.npz", "last.state.npz"}
    assert names <= set(os.listdir(run_dir))
    with open(run_dir / "results.json") as f:
        assert json.load(f) == pytest.approx(
            {k: float(v) for k, v in res.items()})
    assert np.isfinite(res["loss"])
    losses = [r["value"] for r in _metrics(str(run_dir))
              if r["tag"] == "train/Loss"]
    assert losses and np.all(np.isfinite(losses))
