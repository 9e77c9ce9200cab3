"""The port's training CLI on two gloo ranks on the CPU (as ``torchrun
--nproc_per_node 2`` runs it: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT in the environment) against the port's one-rank CLI on the
same synthetic corpus, streaming, with ``--hbm_cache`` (the train split
row-sharded) and rotating past a tiny ``--hbm_budget_gb`` (the train split
striped): both ranks compute the same metrics, close to the one-rank
run's at the tolerances of tests/test_multiprocess.py:116-127 (loss rtol
2e-3 and atol 2e-3, acc 1e-6, AUROC 5e-3; with a cache, each rank
shuffles its own block, the JAX package's sharded plans, so the batches
differ from the one-rank run's global shuffle). The one-rank CLI is held
against the JAX package's in tests/test_torch_cli.py; JAX's own
multi-process CLI comparison is tests/test_multiprocess.py (slow). Also
the guard that keeps a mesh run's evaluation off row-sharded caches.
"""

import json
import logging
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from eeg_gnn_tpu_torch.cli import train as cli
from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.data.synthetic import make_synthetic_corpus
from eeg_gnn_tpu_torch.models.registry import build_model
from eeg_gnn_tpu_torch.parallel.mesh import Mesh
from eeg_gnn_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = {"stream": [], "hbm": ["--hbm_cache"],
        "rotating": ["--hbm_cache", "--hbm_budget_gb", "0.0002"]}

WORKER = textwrap.dedent("""
    import json, os, sys
    sys.path.insert(0, %r)
    import torch
    torch.set_num_threads(2)
    from eeg_gnn_tpu_torch.cli.train import main
    root, argv = sys.argv[1], json.loads(sys.argv[2])
    rank = int(os.environ["RANK"])
    out = {}
    for tag, extra in json.loads(sys.argv[3]).items():
        res = main(argv + extra + ["--save_dir",
                                   os.path.join(root, "mp_" + tag)],
                   device="cpu")
        out[tag] = {k: float(v) for k, v in res.items()}
    with open(os.path.join(root, "result_%%d.json" %% rank), "w") as f:
        json.dump(out, f)
""" % (REPO,))


def _argv(p):
    return ["--task", "detection", "--do_train", "--graph_type", "combined",
            "--max_seq_len", "12", "--use_fft", "--num_rnn_layers", "1",
            "--rnn_units", "16", "--max_diffusion_step", "1",
            "--train_batch_size", "4", "--test_batch_size", "4",
            "--num_epochs", "2", "--num_workers", "0",
            "--input_dir", p["input_dir"], "--raw_data_dir",
            p["raw_data_dir"], "--marker_dir", p["marker_dir"],
            "--adj_mat_dir", p["adj_mat_dir"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the two ranks (every run, one process group), run the
    one-rank CLI meanwhile; returns (one-rank results, the ranks')."""
    root = str(tmp_path_factory.mktemp("dp_cli"))
    p = make_synthetic_corpus(root, num_files=4, file_seconds=60,
                              clip_len=12)
    worker = os.path.join(root, "worker.py")
    with open(worker, "w") as f:
        f.write(WORKER)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    procs = []
    for rank in (0, 1):
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        env.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, worker, root, json.dumps(_argv(p)),
             json.dumps(RUNS)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    try:
        single = {tag: cli.main(_argv(p) + extra + [
            "--save_dir", os.path.join(root, "single_" + tag)],
            device="cpu") for tag, extra in RUNS.items()}
        outs = [proc.communicate(timeout=600)[0] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for rank, (proc, out) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    ranks = []
    for rank in (0, 1):
        with open(os.path.join(root, f"result_{rank}.json")) as f:
            ranks.append(json.load(f))
    return root, single, ranks, outs


@pytest.mark.parametrize("tag", list(RUNS))
def test_two_rank_cli_matches_one_rank(runs, tag):
    root, single, ranks, outs = runs
    for k, v in ranks[0][tag].items():
        np.testing.assert_allclose(ranks[1][tag][k], v, rtol=1e-6,
                                   err_msg=k)
    got, want = ranks[0][tag], single[tag]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(got["acc"], want["acc"], atol=1e-6)
    assert np.isfinite(got["auroc"])
    np.testing.assert_allclose(got["auroc"], want["auroc"], atol=5e-3)
    # each rank wrote its own run: rank 0 under --save_dir, rank 1 under
    # --save_dir/rank1
    for sub in ("", "rank1"):
        run = os.path.join(root, "mp_" + tag, sub, "train", "train-01")
        for name in ("best.npz", "last.npz", "results.json",
                     "metrics.jsonl"):
            assert os.path.exists(os.path.join(run, name)), (run, name)
    if tag == "rotating":
        assert all("row-sharded slabs" in out for out in outs)
    assert all("backend gloo" in out for out in outs)


class _NullWriter:
    def add_scalar(self, *args, **kwargs):
        pass


def test_mesh_evaluation_never_reads_a_row_sharded_cache():
    """The stripe-mode evaluation guard: under a mesh the Trainer takes a
    train cache only (dev and test stream from the sharded loaders), so
    no evaluation indexes a rank's rows by global row (the JAX trainer's
    ``trainer.py:509``, ADVICE.md); the striped cache itself refuses
    those reads (tests/test_torch_device_cache.py)."""
    cfg = ExperimentConfig(do_train=True, max_seq_len=4, rnn_units=8,
                           input_dim=4, num_rnn_layers=1).finalize()
    mesh = Mesh(("data",), (2,), 0, 2, torch.device("cpu"), "gloo")
    for split in ("dev", "test"):
        with pytest.raises(ValueError, match="only the train split"):
            Trainer(cfg, {"train": []}, None, logging.getLogger("dp"),
                    _NullWriter(), build_model(cfg), device="cpu",
                    device_caches={"train": None, split: None}, mesh=mesh)
