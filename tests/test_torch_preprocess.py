"""The port's offline preprocessing (``eeg_gnn_tpu_torch/cli/preprocess.py``)
against the JAX package's on the CPU, on a seeded corpus of 3 recordings
x 48 s (12 s clips):

- ``resample_all`` on EDF files at 250 Hz with 4 channels outside the
  montage in shuffled order, one recording missing a montage channel and
  one file that is not EDF: the same h5 files and failed list, existing
  outputs skipped, and its in-memory half (``signals=``) equal to them;
- the ``detection``, ``classification`` and ``ssl`` caches of the two
  ``main``s (FFT features and raw windows), and their in-memory halves
  (``signals=`` in, ``clips=`` out) against the h5 files;
- the ``graph`` pickle from a seeded electrode-distance CSV;
- ``--hbm_cache`` on ``--preproc_dir``: ``cli.input_path``'s caches, built
  through the datasets from the caches alone, against the JAX caches.

Everything bitwise (``assert_array_equal``): the same numpy and scipy
calls on the same inputs.
"""

import os
import pickle

import h5py
import numpy as np
import pytest

from eeg_gnn_tpu.cli import preprocess as jprep
from eeg_gnn_tpu.data import datasets as jds
from eeg_gnn_tpu.data import device_cache as jdc
from eeg_gnn_tpu_torch.cli import preprocess as tprep
from eeg_gnn_tpu_torch.cli import train as tcli
from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.constants import INCLUDED_CHANNELS
from eeg_gnn_tpu_torch.data.clips import read_resampled_h5
from eeg_gnn_tpu_torch.data.edf import write_edf
from eeg_gnn_tpu_torch.data.scaler import StandardScaler
from eeg_gnn_tpu_torch.data.synthetic import make_synthetic_corpus

CLIP = 12
EXTRA = ["EEG A1-REF", "EKG1-REF", "EEG A2-REF", "PHOTIC-REF"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The synthetic corpus (h5 signals, markers, annotations), its
    signals in memory, and its recordings as EDF files at 250 Hz."""
    from scipy.signal import resample

    root = tmp_path_factory.mktemp("corpus")
    p = make_synthetic_corpus(str(root), num_files=3, file_seconds=48,
                              clip_len=CLIP, seed=2)
    p["signals"] = {os.path.join(p["input_dir"], f): read_resampled_h5(
        os.path.join(p["input_dir"], f))
        for f in sorted(os.listdir(p["input_dir"]))}
    edf_dir = root / "edf250"
    edf_dir.mkdir()
    rng = np.random.RandomState(5)
    labels = [ch + "-REF" for ch in INCLUDED_CHANNELS] + EXTRA
    for i, (h5, sig) in enumerate(sorted(p["signals"].items())):
        up = resample(sig, sig.shape[1] * 250 // 200, axis=1)
        full = np.concatenate([up, rng.randn(len(EXTRA), up.shape[1]) * 9])
        order = rng.permutation(len(labels))
        if i == 2:  # a montage channel missing: this file fails
            order = order[[labels[k] != "EEG CZ-REF" for k in order]]
        stem = os.path.basename(h5)[:-3]
        write_edf(str(edf_dir / f"{stem}.edf"), full[order],
                  [labels[k] for k in order], 250)
    (edf_dir / "notes.edf.txt").write_text("not an EDF file")
    p["edf250"] = str(edf_dir)
    return p


def _h5(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f}


def _assert_trees_equal(a_dir, b_dir):
    names = sorted(os.listdir(a_dir))
    assert names == sorted(os.listdir(b_dir)) and names
    for name in names:
        a, b = _h5(os.path.join(a_dir, name)), _h5(os.path.join(b_dir, name))
        assert sorted(a) == sorted(b), name
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


def test_resample_all_matches_jax(corpus, tmp_path, capsys):
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jfailed = jprep.resample_all(corpus["edf250"], jout)
    tfailed = tprep.resample_all(corpus["edf250"], tout)
    assert tfailed == jfailed and len(tfailed) == 2  # the CZ-less file
    assert "notes.edf.txt" in " ".join(tfailed)      # and the text file
    _assert_trees_equal(jout, tout)
    assert len(os.listdir(tout)) == 2
    for name in os.listdir(tout):
        got = _h5(os.path.join(tout, name))
        assert int(got["resample_freq"]) == 200
        assert got["resampled_signal"].shape == (19, 48 * 200)
    # existing outputs are skipped (the failed files are tried again)
    mtimes = {f: os.path.getmtime(os.path.join(tout, f))
              for f in os.listdir(tout)}
    assert tprep.resample_all(corpus["edf250"], tout) == tfailed
    assert mtimes == {f: os.path.getmtime(os.path.join(tout, f))
                      for f in os.listdir(tout)}
    # the in-memory half: each signal under its h5 path, no file written
    mem_dir, signals = str(tmp_path / "mem"), {}
    assert tprep.resample_all(corpus["edf250"], mem_dir, signals) == tfailed
    assert os.listdir(mem_dir) == []
    assert sorted(signals) == sorted(os.path.join(mem_dir, f)
                                     for f in os.listdir(tout))
    for path, sig in signals.items():
        np.testing.assert_array_equal(sig, _h5(os.path.join(
            tout, os.path.basename(path)))["resampled_signal"])
    assert tprep.resample_all(corpus["edf250"], mem_dir, signals) == tfailed
    capsys.readouterr()


def _cache_argv(cmd, p, out, flags):
    argv = [cmd, "--resampled_dir", p["input_dir"], "--marker_dir",
            p["marker_dir"], "--output_dir", out, "--clip_len", str(CLIP)]
    if cmd != "ssl":
        argv += ["--raw_data_dir", p["raw_data_dir"]]
    return argv + flags


@pytest.mark.parametrize("flags", [[], ["--no_fft", "--time_step_size",
                                        "2"]], ids=["fft", "raw-2s"])
@pytest.mark.parametrize("cmd", ["detection", "classification", "ssl"])
def test_clip_caches_match_jax(corpus, tmp_path, capsys, cmd, flags):
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jprep.main(_cache_argv(cmd, corpus, jout, flags))
    tprep.main(_cache_argv(cmd, corpus, tout, flags))
    assert capsys.readouterr().out.count("cached") > 0
    _assert_trees_equal(jout, tout)
    # the in-memory half: signals in, clips out, against the h5 files
    clips = {}
    kw = dict(time_step_size=2 if flags else 1, use_fft=not flags,
              signals=corpus["signals"], clips=clips)
    mem = str(tmp_path / "mem")
    if cmd == "ssl":
        tprep.preprocess_ssl(corpus["input_dir"], corpus["marker_dir"], mem,
                             CLIP, **kw)
    else:
        fn = getattr(tprep, f"preprocess_{cmd}")
        fn(corpus["input_dir"], corpus["raw_data_dir"],
           corpus["marker_dir"], mem, CLIP, **kw)
    assert os.listdir(mem) == []
    assert sorted(os.path.basename(k) for k in clips) == \
        sorted(os.listdir(tout))
    for path, clip in clips.items():
        want = _h5(os.path.join(tout, os.path.basename(path)))["clip"]
        np.testing.assert_array_equal(clip, want)
        assert clip.dtype == want.dtype


def test_graph_pickle_matches_jax(tmp_path, capsys):
    rng = np.random.RandomState(4)
    names = list(INCLUDED_CHANNELS) + ["EEG A1"]
    xyz = rng.randn(len(names), 3)
    lines = ["from,to,distance"]
    for i, a in enumerate(names):
        for j, b in enumerate(names):
            lines.append(f"{a},{b},{np.linalg.norm(xyz[i] - xyz[j]):.6f}")
    csv = tmp_path / "d.csv"
    csv.write_text("\n".join(lines) + "\n")
    for mod, out in ((jprep, "j.pkl"), (tprep, "t.pkl")):
        mod.main(["graph", "--distances_csv", str(csv), "--output_pkl",
                  str(tmp_path / out), "--dist_k", "1.2"])
    assert capsys.readouterr().out.count("nonzeros") == 2
    with open(tmp_path / "j.pkl", "rb") as f:
        want = pickle.load(f)
    with open(tmp_path / "t.pkl", "rb") as f:
        got = pickle.load(f)
    assert got[0] == want[0] == list(INCLUDED_CHANNELS)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2].dtype == np.float32 and 0 < (got[2] > 0).sum() < 19 * 19


@pytest.mark.parametrize("task", ["detection", "classification",
                                  "SS pre-training"])
def test_hbm_cache_reads_preproc_dir(corpus, tmp_path, capsys, task):
    """``--hbm_cache`` with ``--preproc_dir``: the cache builders read the
    cached clips through the datasets (the resampled signals are not
    reachable: ``input_dir`` does not exist), as in JAX."""
    cmd = {"SS pre-training": "ssl"}.get(task, task)
    cache = str(tmp_path / cmd)
    tprep.main(_cache_argv(cmd, corpus, cache, []))
    capsys.readouterr()
    missing = str(tmp_path / "no_signals_here")
    cfg = ExperimentConfig(
        task=task, hbm_cache=True, preproc_dir=cache, max_seq_len=CLIP,
        output_seq_len=4, use_fft=True, graph_type="combined",
        input_dir=missing, raw_data_dir=corpus["raw_data_dir"],
        train_batch_size=4, test_batch_size=8, num_workers=1,
        num_classes=4 if task == "classification" else 1,
        metric_name="F1" if task == "classification" else "auroc",
        do_train=True).finalize()
    _, caches = tcli.input_path(cfg, StandardScaler(0.0, 1.0),
                                adj_mat_dir=corpus["adj_mat_dir"],
                                marker_dir=corpus["marker_dir"],
                                device="cpu")
    kw = dict(input_dir=missing, raw_data_dir=corpus["raw_data_dir"],
              train_batch_size=4, test_batch_size=8, standardize=False,
              num_workers=1, use_fft=True, preproc_dir=cache,
              marker_dir=corpus["marker_dir"], build_loaders=False)
    if task == "detection":
        plain = jds.load_dataset_detection(max_seq_len=CLIP, **kw)[1]
        build = lambda ds: jdc.build_detection_cache(ds, CLIP)
    elif task == "classification":
        plain = jds.load_dataset_classification(max_seq_len=CLIP, **kw)[1]
        build = lambda ds: jdc.build_classification_cache(ds, CLIP)
    else:
        plain = jds.load_dataset_ssl(input_len=CLIP, output_len=4, **kw)[1]
        build = lambda ds: jdc.build_ssl_cache(ds, CLIP)
    for split, ds in plain.items():
        want, got = build(ds), caches[split]
        assert got.num_clips == want.num_clips == len(ds) > 0
        np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
        np.testing.assert_array_equal(got.y.numpy(), np.asarray(want.y))
        if task == "classification":
            np.testing.assert_array_equal(got.seq.numpy(),
                                          np.asarray(want.seq))
