"""The port's training CLI slice against the JAX package on the CPU.

``run_experiment`` in both packages on a synthetic corpus (4 files x 96 s,
12 s clips; 1 DCGRU layer x 16 units, K=1, batches of 4 and 8, 2 epochs,
float32), the port starting from the JAX initial parameters through
``params_from_jax``: detection on both graph types, SSL pre-training
(curriculum off: the two packages draw the force vectors from different
generators) and fine-tuning from an SSL checkpoint; then the on-device input path
(augmentation off): the dataset caches (``--hbm_cache``, resident and,
past a tiny ``--hbm_budget_gb``, rotating), the raw-clip pipeline
(``--device_pipeline``) and ``--fused_steps 4`` (which the port accepts
and ignores: JAX's fused program has the numerics of single steps),
detection and SSL, each
package building its pipeline and caches as its CLI does. Seizure-type
classification (4 classes, weighted F1) runs on a corpus of 12 files x 96
s (4 files hold 3 training clips): streaming on both graphs,
``--hbm_cache`` resident on both graphs and rotating, and fine-tuned
from a reference ``.pth.tar`` that the JAX package wrote.

Tolerances: the ``train/Loss`` sequence (same steps), the dev/test loss
and dev-tuned threshold at rtol 1e-4; accuracy, F1, precision, recall
and AUROC exactly, unless a test probability lies within 1e-5 of the
threshold; ``best.npz`` at rtol 1e-4, atol 1e-6 (parameters near 0).
Then ``cli.train.main(argv, device="cpu")`` once end to end, the flag
surface against the JAX CLI's, and the flags whose features are not
ported.
"""

import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

from eeg_gnn_tpu.config import ExperimentConfig as JaxConfig
from eeg_gnn_tpu.config import build_parser as jax_build_parser
from eeg_gnn_tpu.data import datasets as jds
from eeg_gnn_tpu.data.synthetic import make_synthetic_corpus
from eeg_gnn_tpu.models.dcrnn import init_next_time_pred_model
from eeg_gnn_tpu.models.registry import build_model as jax_build_model
from eeg_gnn_tpu.train import checkpoint as jck
from eeg_gnn_tpu.train.trainer import run_experiment as jax_run
from eeg_gnn_tpu.utils.logging import MetricsWriter as JaxWriter
from eeg_gnn_tpu_torch.cli import train as cli
from eeg_gnn_tpu_torch.config import ExperimentConfig, build_parser
from eeg_gnn_tpu_torch.data import datasets as tds
from eeg_gnn_tpu_torch.data.rotating_cache import RotatingDeviceCache
from eeg_gnn_tpu_torch.io import params_from_jax
from eeg_gnn_tpu_torch.serve import Predictor
from eeg_gnn_tpu_torch.train import trainer as ttrainer
from eeg_gnn_tpu_torch.utils.logging import MetricsWriter

SSL = "SS pre-training"
CLIP = 12
RTOL = 1e-4
NEAR = 1e-5  # a test probability this close to the threshold may flip


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    return make_synthetic_corpus(root, num_files=4, file_seconds=96,
                                 clip_len=CLIP, seed=0)


def _kw(p, task, graph_type, **extra):
    kw = dict(task=task, graph_type=graph_type, max_seq_len=CLIP,
              use_fft=True, num_rnn_layers=1, rnn_units=16,
              max_diffusion_step=1, train_batch_size=4, test_batch_size=8,
              num_epochs=2, do_train=True, num_workers=1,
              input_dir=p["input_dir"], raw_data_dir=p["raw_data_dir"])
    if task == SSL:
        kw.update(metric_name="loss", output_seq_len=CLIP)
    if task == "classification":
        kw.update(num_classes=4, metric_name="F1")
    kw.update(extra)
    return kw


def _loaders(ds_module, p, cfg, raw_mode=False):
    common = dict(raw_mode=raw_mode,
        input_dir=p["input_dir"], raw_data_dir=p["raw_data_dir"],
        train_batch_size=cfg.train_batch_size,
        test_batch_size=cfg.test_batch_size, time_step_size=1,
        standardize=True, num_workers=1, augmentation=False,
        adj_mat_dir=p["adj_mat_dir"], graph_type=cfg.graph_type, top_k=3,
        filter_type=cfg.filter_type, use_fft=True,
        marker_dir=p["marker_dir"])
    if cfg.task == SSL:
        return ds_module.load_dataset_ssl(input_len=CLIP,
                                          output_len=cfg.output_seq_len,
                                          **common)
    if cfg.task == "classification" and cfg.model_name == "densecnn":
        return ds_module.load_dataset_densecnn_classification(
            max_seq_len=cfg.max_seq_len, **{k: common[k] for k in (
                "input_dir", "raw_data_dir", "train_batch_size",
                "test_batch_size", "standardize", "num_workers",
                "augmentation", "use_fft", "marker_dir")})
    if cfg.task == "classification":
        common.pop("raw_mode")
        return ds_module.load_dataset_classification(max_seq_len=CLIP,
                                                     **common)
    return ds_module.load_dataset_detection(max_seq_len=CLIP, seed=123,
                                            **common)


def _log():
    log = logging.getLogger("test_torch_cli")
    log.addHandler(logging.NullHandler())
    return log


def _metrics(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if not r["tag"].startswith("time/")]


def _jax_input_path(cfg, p, scaler):
    """The JAX CLI's pipeline and caches (cli/train.py:91-240, one
    device)."""
    from eeg_gnn_tpu.data import device_cache as jdc
    from eeg_gnn_tpu.data.device_pipeline import make_device_pipeline
    from eeg_gnn_tpu.data.rotating_cache import build_rotating_cache

    if not ((cfg.device_pipeline and cfg.task != "classification")
            or cfg.hbm_cache):
        return None, None
    pipe = make_device_pipeline(
        graph_type=cfg.graph_type, filter_type=cfg.filter_type,
        top_k=cfg.top_k, use_fft=cfg.use_fft,
        time_step_size=cfg.time_step_size, scaler=scaler,
        augment=cfg.data_augment, adj_mat_dir=p["adj_mat_dir"],
        num_nodes=cfg.num_nodes, reflect_invariant=cfg.reflect_invariant)
    if not cfg.hbm_cache:
        return pipe, None
    plain_kw = dict(input_dir=p["input_dir"], raw_data_dir=p["raw_data_dir"],
                    train_batch_size=cfg.train_batch_size,
                    test_batch_size=cfg.test_batch_size, time_step_size=1,
                    standardize=False, num_workers=1, augmentation=False,
                    adj_mat_dir=None, graph_type=None, use_fft=True,
                    marker_dir=p["marker_dir"], build_loaders=False)
    if cfg.task == SSL:
        _, plain, _ = jds.load_dataset_ssl(input_len=CLIP,
                                           output_len=cfg.output_seq_len,
                                           **plain_kw)
        build = lambda ds: jdc.build_ssl_cache(ds, CLIP)
        t_out, kind = cfg.output_seq_len, "ssl"
    elif cfg.task == "classification":
        _, plain, _ = jds.load_dataset_classification(max_seq_len=CLIP,
                                                      **plain_kw)
        build = lambda ds: jdc.build_classification_cache(ds, CLIP)
        t_out, kind = 0, "classification"
    else:
        _, plain, _ = jds.load_dataset_detection(max_seq_len=CLIP, seed=123,
                                                 **plain_kw)
        build = lambda ds: jdc.build_detection_cache(ds, CLIP)
        t_out, kind = 0, "detection"
    budget = int(cfg.hbm_budget_gb * 2 ** 30)
    if jdc.fits_in_hbm(sum(len(ds) for ds in plain.values()), CLIP, 19,
                       cfg.input_dim, "float32", t_out=t_out,
                       budget_bytes=budget):
        return pipe, {s: build(ds) for s, ds in plain.items()}
    return pipe, {s: build_rotating_cache(ds, CLIP, kind,
                                          budget_bytes=budget)
                  for s, ds in plain.items()}


def _run_both(p, tmp_path, kw):
    """run_experiment in each package from the JAX initial parameters (a
    model with state, the Dense-CNN: the JAX run draws them itself from
    the same key, as its ``init_params`` carries no state)."""
    jcfg, tcfg = JaxConfig(**kw).finalize(), ExperimentConfig(**kw).finalize()
    key = jax.random.PRNGKey(jcfg.rand_seed)
    state = {}
    if jcfg.task == SSL:
        init = init_next_time_pred_model(key, jcfg.dcrnn_config())
    else:
        init, state = jax_build_model(jcfg).init(key)
    init_np = jax.tree_util.tree_map(np.asarray, init)
    state_np = jax.tree_util.tree_map(np.asarray, state)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    os.makedirs(jdir)
    os.makedirs(tdir)
    loaders, _, scaler = _loaders(jds, p, jcfg, jcfg.device_pipeline)
    pipe, caches = _jax_input_path(jcfg, p, scaler)
    jres = jax_run(jcfg, loaders, scaler, jdir, _log(), JaxWriter(jdir),
                   init_params=None if state else init, input_pipeline=pipe,
                   device_caches=caches)
    loaders, _, scaler = _loaders(tds, p, tcfg, tcfg.device_pipeline)
    pipe, caches = cli.input_path(
        tcfg, scaler, adj_mat_dir=p["adj_mat_dir"],
        marker_dir=p["marker_dir"], device="cpu")
    if tcfg.hbm_cache:
        rotating = tcfg.hbm_budget_gb < 0.01
        assert all(isinstance(c, RotatingDeviceCache) == rotating
                   for c in caches.values())
        assert not rotating or caches["train"].num_shards > 2
    tres = ttrainer.run_experiment(tcfg, loaders, scaler, tdir, _log(),
                                   MetricsWriter(tdir),
                                   init_params=params_from_jax(init_np,
                                                               state_np),
                                   device="cpu", input_pipeline=pipe,
                                   device_caches=caches)
    return jres, tres, jdir, tdir, tcfg, caches


def _test_probs(p, cfg, run_dir):
    """The port's test-split probabilities from its best.npz."""
    loaders, _, _ = _loaders(tds, p, cfg)
    pred = Predictor.from_checkpoint(os.path.join(run_dir, "best.npz"), cfg,
                                     batch_size=cfg.test_batch_size,
                                     device="cpu")
    return np.concatenate([pred.predict_proba(b.x, b.seq_lengths,
                                              supports=b.supports)
                           for b in loaders["test"]])


def _steps_per_epoch(p, cfg, caches):
    """A rotating train split steps shard by shard."""
    bsz = cfg.train_batch_size
    train = (caches or {}).get("train")
    if isinstance(train, RotatingDeviceCache):
        return sum(-(-train.shard_real_rows(s) // bsz)
                   for s in range(train.num_shards))
    return -(-len(_loaders(tds, p, cfg)[1]["train"]) // bsz)


def _assert_runs_agree(p, jres, tres, jdir, tdir, cfg, caches=None,
                       param_atol=1e-6):
    jm, tm = _metrics(jdir), _metrics(tdir)
    assert [(r["tag"], r["step"]) for r in tm] == \
        [(r["tag"], r["step"]) for r in jm]
    steps = [r for r in tm if r["tag"] == "train/Loss"]
    assert len(steps) == 2 * _steps_per_epoch(p, cfg, caches)
    for a, b in zip(tm, jm):
        if a["tag"] in ("train/Loss", "eval/loss", "eval/best_thresh"):
            np.testing.assert_allclose(a["value"], b["value"], rtol=RTOL)
    assert sorted(tres) == sorted(jres)
    np.testing.assert_allclose(tres["loss"], jres["loss"], rtol=RTOL)
    if cfg.task == "classification":
        for k in ("acc", "F1", "precision", "recall", "best_thresh"):
            assert tres[k] == jres[k], (k, tres[k], jres[k])
    elif cfg.task != SSL:
        np.testing.assert_allclose(tres["best_thresh"], jres["best_thresh"],
                                   rtol=RTOL)
        probs = _test_probs(p, cfg, tdir)
        if not np.any(np.abs(probs - tres["best_thresh"]) < NEAR):
            for k in ("acc", "F1", "precision", "recall", "auroc"):
                assert tres[k] == jres[k], (k, tres[k], jres[k])
    with np.load(os.path.join(jdir, "best.npz")) as a, \
            np.load(os.path.join(tdir, "best.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_allclose(b[k], a[k], rtol=RTOL,
                                       atol=param_atol)
    # the same files, but the JAX package's optional TensorBoard events
    assert sorted(os.listdir(tdir)) == sorted(
        f for f in os.listdir(jdir) if not f.startswith("events.out."))


@pytest.mark.parametrize("task,graph_type,flags", [
    pytest.param("detection", "combined", {}, id="detection-combined"),
    pytest.param("detection", "individual", {}, id="detection-individual"),
    pytest.param(SSL, "combined", {}, id="SS pre-training-combined"),
    pytest.param("detection", "combined", {"hbm_cache": True},
                 id="detection-combined-hbm_cache"),
    pytest.param("detection", "combined",
                 {"hbm_cache": True, "hbm_budget_gb": 0.001},
                 id="detection-combined-hbm_cache-rotating"),
    pytest.param("detection", "combined",
                 {"hbm_cache": True, "fused_steps": 4},
                 id="detection-combined-hbm_cache-fused_steps"),
    pytest.param("detection", "individual", {"device_pipeline": True},
                 id="detection-individual-device_pipeline"),
    pytest.param(SSL, "combined", {"hbm_cache": True},
                 id="SS pre-training-combined-hbm_cache"),
    pytest.param(SSL, "individual", {"device_pipeline": True},
                 id="SS pre-training-individual-device_pipeline"),
    pytest.param(SSL, "combined", {"fused_steps": 4},
                 id="SS pre-training-combined-fused_steps"),
])
def test_run_experiment_matches_jax(corpus, tmp_path, task, graph_type,
                                    flags):
    jres, tres, jdir, tdir, cfg, caches = _run_both(
        corpus, tmp_path, _kw(corpus, task, graph_type, **flags))
    _assert_runs_agree(corpus, jres, tres, jdir, tdir, cfg, caches)


@pytest.fixture(scope="module")
def cls_corpus(tmp_path_factory):
    """Enough seizures for a classification run: 12 files, 1-2 each."""
    root = str(tmp_path_factory.mktemp("cls_corpus"))
    return make_synthetic_corpus(root, num_files=12, file_seconds=96,
                                 clip_len=CLIP, seed=1)


@pytest.mark.parametrize("graph_type,flags", [
    pytest.param("combined", {}, id="combined"),
    pytest.param("individual", {}, id="individual"),
    pytest.param("combined", {"hbm_cache": True}, id="combined-hbm_cache"),
    pytest.param("individual", {"hbm_cache": True},
                 id="individual-hbm_cache"),
    pytest.param("combined", {"hbm_cache": True, "hbm_budget_gb": 0.0001},
                 id="combined-hbm_cache-rotating"),
    pytest.param("combined", {"device_pipeline": True},
                 id="combined-device_pipeline"),
])
def test_classification_run_matches_jax(cls_corpus, tmp_path, graph_type,
                                        flags):
    """4-class seizure types: padded clips of mixed lengths, CE loss,
    softmax and weighted F1; ``--device_pipeline`` serves detection and
    SSL only, in both packages, so classification streams host features
    under it."""
    jres, tres, jdir, tdir, cfg, caches = _run_both(
        cls_corpus, tmp_path, _kw(cls_corpus, "classification", graph_type,
                                  **flags))
    lens = _loaders(tds, cls_corpus, cfg)[1]["train"]
    assert len({int(lens[i][2]) for i in range(len(lens))}) > 1
    assert sorted(jres) == ["F1", "acc", "best_thresh", "loss", "precision",
                            "recall"]
    _assert_runs_agree(cls_corpus, jres, tres, jdir, tdir, cfg, caches)


def test_classification_fine_tune_from_pth_tar_matches_jax(cls_corpus,
                                                           tmp_path):
    """Classification fine-tuned from a reference-layout SSL ``.pth.tar``
    (2 layers; the tied decoder cell under layer 1) that the JAX package
    wrote: both packages read the same file. ``best.npz`` at atol 1e-5,
    about 1/30 of one Adam step at lr 3e-4 (tests/test_torch_train.py):
    from this start Adam turns float32 summation-order noise in a
    near-zero gradient into a 1.5e-6 weight difference, the same whether
    the start comes from the ``.pth.tar`` or the ``.npz`` (the transplants
    are equal: tests/test_torch_pth_io.py)."""
    from eeg_gnn_tpu.io.torch_export import (
        export_next_time_pred_state,
        save_torch_checkpoint,
    )

    pre_cfg = JaxConfig(**_kw(cls_corpus, SSL, "combined",
                              num_rnn_layers=2)).finalize()
    pre = init_next_time_pred_model(jax.random.PRNGKey(9),
                                    pre_cfg.dcrnn_config())
    path = str(tmp_path / "ssl_best.pth.tar")
    save_torch_checkpoint(path, export_next_time_pred_state(pre, 2))
    kw = _kw(cls_corpus, "classification", "combined", fine_tune=True,
             pretrained_num_rnn_layers=2, load_model_path=path)
    jres, tres, jdir, tdir, cfg, _ = _run_both(cls_corpus, tmp_path, kw)
    _assert_runs_agree(cls_corpus, jres, tres, jdir, tdir, cfg,
                       param_atol=1e-5)


def test_fine_tune_matches_jax(corpus, tmp_path):
    """Detection fine-tuned from an SSL checkpoint with more layers."""
    pre_cfg = JaxConfig(**_kw(corpus, SSL, "combined",
                              num_rnn_layers=2)).finalize()
    pre = init_next_time_pred_model(jax.random.PRNGKey(9),
                                    pre_cfg.dcrnn_config())
    jck.save_params(str(tmp_path / "ssl_best"), pre)
    kw = _kw(corpus, "detection", "combined", fine_tune=True,
             pretrained_num_rnn_layers=2,
             load_model_path=str(tmp_path / "ssl_best.npz"))
    jres, tres, jdir, tdir, cfg, _ = _run_both(corpus, tmp_path, kw)
    _assert_runs_agree(corpus, jres, tres, jdir, tdir, cfg)


def test_cli_main_runs_end_to_end_on_the_cpu(corpus, tmp_path):
    argv = ["--task", "detection", "--do_train", "--graph_type", "combined",
            "--max_seq_len", str(CLIP), "--use_fft", "--num_rnn_layers", "1",
            "--rnn_units", "16", "--max_diffusion_step", "1",
            "--train_batch_size", "4", "--test_batch_size", "8",
            "--num_epochs", "2", "--num_workers", "2",
            "--input_dir", corpus["input_dir"],
            "--raw_data_dir", corpus["raw_data_dir"],
            "--marker_dir", corpus["marker_dir"],
            "--adj_mat_dir", corpus["adj_mat_dir"],
            "--save_dir", str(tmp_path / "save")]
    res = cli.main(argv, device="cpu")
    run_dir = tmp_path / "save" / "train" / "train-01"
    for name in ("args.json", "metrics.jsonl", "best.npz", "last.npz",
                 "results.json", "info.log"):
        assert (run_dir / name).exists(), name
    with open(run_dir / "results.json") as f:
        assert json.load(f) == pytest.approx(
            {k: float(v) for k, v in res.items()})
    assert np.isfinite(res["loss"]) and 0.0 <= res["auroc"] <= 1.0
    rows = _metrics(str(run_dir))
    n_train = len(tds.load_dataset_detection(
        input_dir=corpus["input_dir"], raw_data_dir=corpus["raw_data_dir"],
        train_batch_size=4, max_seq_len=CLIP, use_fft=True,
        marker_dir=corpus["marker_dir"], build_loaders=False)[1]["train"])
    assert sum(r["tag"] == "train/Loss" for r in rows) == 2 * -(-n_train // 4)
    with open(run_dir / "args.json") as f:
        args = json.load(f)
    assert args["save_dir"] == str(run_dir) and args["filter_type"] == \
        "laplacian"


@pytest.mark.parametrize("argv", [
    [],
    ["--task", "SS pre-training", "--graph_type", "combined",
     "--use_curriculum_learning", "--metric_name", "loss", "--dtype",
     "bfloat16", "--no_input_fusion", "--scan_unroll", "4"],
    ["--fine_tune", "--load_model_path", "x.npz",
     "--pretrained_num_rnn_layers", "2", "--use_pallas", "--recurrence",
     "stacked", "--batch_tile", "12", "--data_augment", "--top_k", "5"],
    ["--device_pipeline", "--hbm_cache", "--reflect_invariant",
     "--fused_steps", "4", "--hbm_budget_gb", "2"],
])
def test_cli_flags_match_jax(argv):
    argv = argv + ["--do_train"]
    got = vars(build_parser().parse_args(argv))
    want = vars(jax_build_parser().parse_args(argv))
    assert got == want
    assert ExperimentConfig(**got).finalize().to_json() == \
        JaxConfig(**want).finalize().to_json()


@pytest.mark.parametrize("flag", [
    # the baselines run (tests/test_torch_baselines_cli.py) but refuse
    # the features still to port, as DCRNN does
    ["--task", "classification", "--model_name", "densecnn",
     "--preproc_dir", "/x"],
    ["--model_name", "lstm", "--mesh_shape", "data:2"],
    ["--preproc_dir", "/x"], ["--mesh_shape", "data:2"]])
def test_unported_flags_raise(tmp_path, flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["--do_train", "--save_dir", str(tmp_path)] + flag,
                 device="cpu")
    assert not os.listdir(tmp_path)  # raised before the run dir existed


def test_eval_only_run_needs_a_checkpoint(tmp_path):
    with pytest.raises(ValueError, match="load_model_path"):
        cli.main(["--save_dir", str(tmp_path)], device="cpu")


def test_entry_points_mean_the_card(monkeypatch, corpus, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--do_train", "--save_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
    cfg = ExperimentConfig(**_kw(corpus, "detection", "combined")).finalize()
    loaders, _, scaler = _loaders(tds, corpus, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrainer.run_experiment(cfg, loaders, scaler, str(tmp_path), _log(),
                                None)


def test_ssl_curriculum_reads_the_samples_seen_before_each_batch(
        corpus, tmp_path, monkeypatch):
    """As the JAX trainer (trainer.py:327-334): step i gets the number of
    samples of steps 0..i-1; the losses stay finite with the curriculum."""
    seen = []
    call = ttrainer.TrainStep.__call__

    def recording(self, batch, batches_seen=None):
        seen.append((batches_seen, len(batch["x"])))
        return call(self, batch, batches_seen)

    monkeypatch.setattr(ttrainer.TrainStep, "__call__", recording)
    cfg = ExperimentConfig(**_kw(corpus, SSL, "individual",
                                 use_curriculum_learning=True,
                                 cl_decay_steps=2)).finalize()
    loaders, _, scaler = _loaders(tds, corpus, cfg)
    res = ttrainer.run_experiment(cfg, loaders, scaler, str(tmp_path), _log(),
                                  MetricsWriter(str(tmp_path)), device="cpu")
    assert [s for s, _ in seen] == list(np.cumsum([0] + [n for _, n in
                                                         seen[:-1]]))
    assert len(seen) == 2 * len(loaders["train"]) and np.isfinite(res["loss"])
