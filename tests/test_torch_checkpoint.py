"""The port's checkpoints against the JAX package's on the CPU: parameter
``.npz`` files keep the JAX flat key layout, so each package reads the
other's (keys and arrays exact); the fine-tune transplant; best/last
semantics and the run directory; the optimizer state file; and
``Predictor.from_checkpoint`` on a file the port wrote.
"""

import os

import jax
import numpy as np
import pytest
import torch

from eeg_gnn_tpu.config import ExperimentConfig as JaxConfig
from eeg_gnn_tpu.models.dcrnn import init_next_time_pred_model
from eeg_gnn_tpu.models.registry import build_model as jax_build_model
from eeg_gnn_tpu.train import checkpoint as jck
from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.io import params_from_jax, params_to_jax
from eeg_gnn_tpu_torch.models.registry import build_model
from eeg_gnn_tpu_torch.serve import Predictor
from eeg_gnn_tpu_torch.train import TrainStep
from eeg_gnn_tpu_torch.train import checkpoint as tck

SSL = "SS pre-training"


def _cfgs(task, layers, graph_type="combined"):
    kw = dict(task=task, graph_type=graph_type, num_rnn_layers=layers,
              rnn_units=16, input_dim=12, output_dim=12, max_diffusion_step=1,
              do_train=True)
    return JaxConfig(**kw).finalize(), ExperimentConfig(**kw).finalize()


def _jax_params(jcfg, seed=0):
    key = jax.random.PRNGKey(seed)
    if jcfg.task == SSL:
        tree = init_next_time_pred_model(key, jcfg.dcrnn_config())
    else:
        tree, _ = jax_build_model(jcfg).init(key)
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return jck._flatten(tree)


CASES = [("detection", 1), ("detection", 2), (SSL, 1), (SSL, 3)]


@pytest.mark.parametrize("task,layers", CASES)
def test_params_to_jax_inverts_params_from_jax(task, layers):
    jcfg, tcfg = _cfgs(task, layers)
    tree = _jax_params(jcfg)
    back = params_to_jax(params_from_jax(tree))
    want, got = _flat(tree), _flat(back)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # and the port's own model's state_dict has exactly these keys
    assert sorted(build_model(tcfg).state_dict()) == \
        sorted(params_from_jax(tree))


@pytest.mark.parametrize("task,layers", CASES)
def test_each_package_reads_the_others_npz(task, layers, tmp_path):
    jcfg, tcfg = _cfgs(task, layers)
    tree = _jax_params(jcfg, seed=1)
    sd = params_from_jax(tree)
    # the port writes, JAX reads
    tck.save_params(str(tmp_path / "port"), sd, metadata={"epoch": 3})
    with np.load(tmp_path / "port.npz") as data:
        assert sorted(data.files) == sorted(_flat(tree))
    got = _flat(jck.load_params_like(str(tmp_path / "port.npz"), tree))
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(got[k], v)
    assert os.path.exists(tmp_path / "port.json")
    # JAX writes, the port reads
    tree2 = _jax_params(jcfg, seed=2)
    jck.save_params(str(tmp_path / "jax"), tree2)
    loaded = tck.load_params_like(str(tmp_path / "jax.npz"),
                                  build_model(tcfg).state_dict())
    want = params_from_jax(tree2)
    assert sorted(loaded) == sorted(want)
    for k in want:
        assert torch.equal(loaded[k], want[k]), k
    build_model(tcfg).load_state_dict(loaded)


def test_load_params_like_checks_shapes(tmp_path):
    jcfg, tcfg = _cfgs("detection", 2)
    tck.save_params(str(tmp_path / "p"), params_from_jax(_jax_params(jcfg)))
    _, wide = _cfgs("detection", 2)
    wide.rnn_units = 8
    with pytest.raises(ValueError, match="shape"):
        tck.load_params_like(str(tmp_path / "p.npz"),
                             build_model(wide).state_dict())


@pytest.mark.parametrize("layers", [1, 2])
def test_build_finetune_params_matches_jax(layers):
    jcfg, tcfg = _cfgs("detection", layers)
    jpre_cfg, _ = _cfgs(SSL, 3)
    new, pre = _jax_params(jcfg, seed=3), _jax_params(jpre_cfg, seed=4)
    want = jck.build_finetune_params(new, pre, layers)
    got = tck.build_finetune_params(params_from_jax(new),
                                    params_from_jax(pre), layers)
    want_sd = params_from_jax(want)
    assert sorted(got) == sorted(want_sd)
    for k in want_sd:
        assert torch.equal(got[k], want_sd[k]), k
    # the encoder came across, the head stayed fresh
    assert torch.equal(got["encoder.0.gate_w"],
                       params_from_jax(pre)["encoder.0.gate_w"])
    assert torch.equal(got["fc.weight"], params_from_jax(new)["fc.weight"])


@pytest.mark.parametrize("maximize", [True, False])
def test_checkpoint_saver_matches_jax(tmp_path, maximize):
    jcfg, tcfg = _cfgs("detection", 1)
    tree = _jax_params(jcfg)
    sd = params_from_jax(tree)
    step = TrainStep(tcfg, build_model(tcfg), steps_per_epoch=1,
                     device="cpu")
    jsave = jck.CheckpointSaver(str(tmp_path / "jax"), "auroc", maximize)
    tsave = tck.CheckpointSaver(str(tmp_path / "port"), "auroc", maximize)
    for epoch, metric in enumerate([0.5, 0.7, 0.6, None, 0.7, 0.4], 1):
        jsave.save(epoch, tree, {"mu": np.zeros(2)}, metric)
        tsave.save(epoch, sd, step.optimizer, metric)
        assert tsave.best_val == jsave.best_val
        assert sorted(os.listdir(tmp_path / "port")) == \
            sorted(os.listdir(tmp_path / "jax"))
        with open(tmp_path / "port" / "last.json") as a, \
                open(tmp_path / "jax" / "last.json") as b:
            assert a.read() == b.read()


def test_optimizer_state_file(rng, tmp_path):
    _, tcfg = _cfgs("detection", 1)
    step = TrainStep(tcfg, build_model(tcfg, torch.Generator().manual_seed(0)),
                     steps_per_epoch=2, device="cpu")
    batch = {"x": rng.randn(3, 5, 19, 12).astype(np.float32),
             "y": np.array([0, 1, 1], np.float32),
             "adjacency": np.abs(rng.rand(3, 19, 19)).astype(np.float32)}
    step(batch)
    step(batch)
    flat = tck.optimizer_arrays(step.optimizer)
    n = len(step.optimizer.params)
    assert sorted(flat) == sorted(
        ["schedule/step"] + [f"adam/{i}/{k}" for i in range(n)
                             for k in ("exp_avg", "exp_avg_sq", "step")])
    assert int(flat["schedule/step"]) == 2 and float(flat["adam/0/step"]) == 2
    saver = tck.CheckpointSaver(str(tmp_path), "loss", False)
    saver.save(1, step.model.state_dict(), step.optimizer, 0.3)
    with np.load(tmp_path / "best.opt.npz") as data:
        np.testing.assert_array_equal(data["adam/0/exp_avg"],
                                      flat["adam/0/exp_avg"])


def test_get_save_dir_matches_jax(tmp_path):
    for training in (True, False, True):
        got = tck.get_save_dir(str(tmp_path / "port"), training)
        want = jck.get_save_dir(str(tmp_path / "jax"), training)
        assert os.path.relpath(got, tmp_path / "port") == \
            os.path.relpath(want, tmp_path / "jax")


def test_predictor_reads_the_ports_checkpoint(rng, tmp_path):
    jcfg, tcfg = _cfgs("detection", 2)
    tcfg.max_seq_len, tcfg.test_batch_size = 5, 4
    sd = build_model(tcfg, torch.Generator().manual_seed(5)).state_dict()
    tck.save_params(str(tmp_path / "best"), sd)
    x = rng.randn(6, 5, 19, 12).astype(np.float32)
    adj = np.abs(rng.rand(6, 19, 19)).astype(np.float32)
    got = Predictor.from_checkpoint(str(tmp_path / "best.npz"), tcfg,
                                    device="cpu").predict_proba(
                                        x, adjacency=adj)
    want = Predictor(tcfg, sd, device="cpu").predict_proba(x, adjacency=adj)
    np.testing.assert_array_equal(got, want)
