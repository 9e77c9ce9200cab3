"""The port's host data pipeline against the JAX package's on the CPU:
FFT features, scaler, augmentation, markers, swap pairs, the synthetic
corpus, the distance graph, the detection and SSL datasets and the
threaded loader.

Tolerances: the FFT features and the datasets' samples at atol 1e-6 (the
same numpy arithmetic; samples are float32); everything else exact.
"""

import os
import pickle

import numpy as np
import pytest

from eeg_gnn_tpu import constants as jconst
from eeg_gnn_tpu.data import augment as jaug
from eeg_gnn_tpu.data import markers as jmarkers
from eeg_gnn_tpu.data.datasets import load_dataset_densecnn_classification \
    as jdc_cls
from eeg_gnn_tpu.data.datasets import load_dataset_detection as jdet
from eeg_gnn_tpu.data.datasets import load_dataset_ssl as jssl
from eeg_gnn_tpu.data.loader import DataLoader as JLoader
from eeg_gnn_tpu.data.scaler import StandardScaler as JScaler
from eeg_gnn_tpu.data.synthetic import make_synthetic_corpus as jmake
from eeg_gnn_tpu.graphs import distance as jdist
from eeg_gnn_tpu.ops import fft_features as jfft
from eeg_gnn_tpu_torch import constants as tconst
from eeg_gnn_tpu_torch.data import augment as taug
from eeg_gnn_tpu_torch.data import clips as tclips
from eeg_gnn_tpu_torch.data import datasets as tds
from eeg_gnn_tpu_torch.data import markers as tmarkers
from eeg_gnn_tpu_torch.data.loader import DataLoader as TLoader
from eeg_gnn_tpu_torch.data.scaler import StandardScaler as TScaler
from eeg_gnn_tpu_torch.data.synthetic import make_synthetic_corpus as tmake
from eeg_gnn_tpu_torch.graphs import distance as tdist
from eeg_gnn_tpu_torch.ops import fft_features as tfft

CLIP = 12  # seconds
FEAT_ATOL = 1e-6


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    return jmake(root, num_files=4, file_seconds=96, clip_len=CLIP, seed=0)


def _loader_kw(p, graph_type, augment=False):
    return dict(
        input_dir=p["input_dir"], raw_data_dir=p["raw_data_dir"],
        train_batch_size=4, test_batch_size=8, time_step_size=1,
        standardize=True, num_workers=1, augmentation=augment,
        adj_mat_dir=p["adj_mat_dir"], graph_type=graph_type, top_k=3,
        filter_type=("laplacian" if graph_type == "combined"
                     else "dual_random_walk"),
        use_fft=True, marker_dir=p["marker_dir"])


def _assert_samples_equal(got, want):
    """One dataset sample tuple (x, y, seq_len, supports, adj, name)."""
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=FEAT_ATOL)
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=FEAT_ATOL)
    assert got[2] == want[2] and got[5] == want[5]
    assert len(got[3]) == len(want[3])
    for s_got, s_want in zip(got[3], want[3]):
        np.testing.assert_allclose(s_got, s_want, rtol=0, atol=FEAT_ATOL)
    np.testing.assert_array_equal(got[4], want[4])


# ---------------------------------------------------------------------------
# features, scaler, augmentation, constants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_fft", [True, False])
@pytest.mark.parametrize("time_step_size,points", [(1, 2400), (2, 2500)])
def test_featurize_clip_matches_jax(rng, use_fft, time_step_size, points):
    clip = rng.randn(19, points) * 20.0
    clip[3, :400] = 0.0  # exact zeros take the 1e-8 floor
    got = tfft.featurize_clip_np(clip, time_step_size, 200, use_fft)
    want = jfft.featurize_clip_np(clip, time_step_size, 200, use_fft)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=FEAT_ATOL)
    assert tfft._ZERO_FLOOR == jfft._ZERO_FLOOR


def test_log_amplitude_fft_matches_jax(rng):
    x = rng.randn(3, 19, 200)
    x[0, 0] = 0.0
    np.testing.assert_allclose(tfft.log_amplitude_fft_np(x, 200),
                               jfft.log_amplitude_fft_np(x, 200),
                               rtol=0, atol=FEAT_ATOL)


def test_scaler_matches_jax(rng, tmp_path):
    for name, v in (("m.pkl", np.float64(1.25)), ("s.pkl", np.float64(3.5))):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(v, f)
    paths = (str(tmp_path / "m.pkl"), str(tmp_path / "s.pkl"))
    got, want = TScaler.from_pickles(*paths), JScaler.from_pickles(*paths)
    x = rng.randn(6, 19, 100)
    np.testing.assert_array_equal(got.transform(x), want.transform(x))
    assert got.mean == want.mean and got.std == want.std


@pytest.mark.parametrize("use_fft", [True, False])
@pytest.mark.parametrize("reflect", [None, True, False])
def test_augmentations_match_jax(rng, use_fft, reflect):
    clip = rng.randn(12, 19, 100)
    for seed in range(6):
        r_got, r_want = (np.random.RandomState(seed),
                         np.random.RandomState(seed))
        got, got_pairs = taug.random_reflect(clip, r_got, reflect)
        want, want_pairs = jaug.random_reflect(clip, r_want, reflect)
        np.testing.assert_array_equal(got, want)
        assert got_pairs == want_pairs
        np.testing.assert_array_equal(
            taug.random_scale(got, r_got, use_fft),
            jaug.random_scale(want, r_want, use_fft))
        # the draws left the two streams in the same state
        assert r_got.randint(1 << 30) == r_want.randint(1 << 30)


def test_constants_and_swap_pairs_match_jax():
    assert tconst.INCLUDED_CHANNELS == jconst.INCLUDED_CHANNELS
    assert tconst.FREQUENCY == jconst.FREQUENCY
    assert tconst.ALL_LABEL_DICT == jconst.ALL_LABEL_DICT
    assert tconst._SWAP_NAMES == jconst._SWAP_NAMES
    assert tconst.get_swap_pairs() == jconst.get_swap_pairs()
    sub = ["EEG F3", "EEG FP2", "EEG CZ", "EEG FP1", "EEG F4", "EEG T3"]
    assert tconst.get_swap_pairs(sub) == jconst.get_swap_pairs(sub)


# ---------------------------------------------------------------------------
# markers, corpus, distance graph
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", ["train", "dev", "test"])
@pytest.mark.parametrize("scale_ratio", [1, 0.5])
def test_detection_markers_match_jax(corpus, split, scale_ratio):
    md = corpus["marker_dir"]
    files = (split,
             os.path.join(md, f"{split}Set_seq2seq_{CLIP}s_sz.txt"),
             os.path.join(md, f"{split}Set_seq2seq_{CLIP}s_nosz.txt"))
    got = tmarkers.parse_detection_markers(*files, cv_seed=123,
                                           scale_ratio=scale_ratio)
    state_got = np.random.get_state()[1].copy()
    want = jmarkers.parse_detection_markers(*files, cv_seed=123,
                                            scale_ratio=scale_ratio)
    assert got == want and len(got) > 0
    # the same global-generator draws (the reference's quirk)
    np.testing.assert_array_equal(state_got, np.random.get_state()[1])


def test_ssl_and_classification_markers_match_jax(corpus):
    md = corpus["marker_dir"]
    for split in ("train", "dev", "test"):
        ssl = os.path.join(md, f"{split}Set_seq2seq_{CLIP}s.txt")
        assert tmarkers.parse_ssl_markers(ssl) == \
            jmarkers.parse_ssl_markers(ssl)
        cls = os.path.join(md, f"{split}Set_seizure_files.txt")
        assert tmarkers.parse_classification_markers(cls) == \
            jmarkers.parse_classification_markers(cls)


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_corpus_matches_jax(tmp_path, seed):
    import h5py

    kw = dict(num_files=3, file_seconds=60, clip_len=CLIP, seed=seed)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    jp, tp = jmake(jroot, **kw), tmake(troot, **kw)
    assert set(tp) == set(jp) and tp["clip_len"] == jp["clip_len"]
    files = _tree_files(jroot)
    assert files == _tree_files(troot)
    h5s = [f for f in files if f.endswith(".h5")]
    assert len(h5s) == 3
    for f in files:
        a, b = os.path.join(jroot, f), os.path.join(troot, f)
        if f in h5s:
            with h5py.File(a, "r") as fa, h5py.File(b, "r") as fb:
                assert sorted(fa) == sorted(fb)
                for k in fa:
                    np.testing.assert_array_equal(fa[k][()], fb[k][()])
        else:  # markers, annotations, scaler and graph pickles
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f
    # held in memory instead: the same signals and the same other files
    mroot, signals = str(tmp_path / "mem"), {}
    mp = tmake(mroot, signals=signals, **kw)
    assert _tree_files(mroot) == [f for f in files if f not in h5s]
    assert sorted(signals) == sorted(os.path.join(mp["input_dir"],
                                                  os.path.basename(f))
                                     for f in h5s)
    for path, sig in signals.items():
        with h5py.File(os.path.join(jp["input_dir"], os.path.basename(path)),
                       "r") as fa:
            np.testing.assert_array_equal(sig, fa["resampled_signal"][()])


def test_distance_graph_matches_jax(corpus, rng, tmp_path):
    adj = tdist.load_distance_adjacency(corpus["adj_mat_dir"])
    np.testing.assert_array_equal(
        adj, jdist.load_distance_adjacency(corpus["adj_mat_dir"]))
    pairs = tconst.get_swap_pairs()
    for swap in (None, [], pairs[:1], pairs[2:5], pairs):
        got = tdist.swap_adjacency_nodes(adj, swap)
        np.testing.assert_array_equal(got,
                                      jdist.swap_adjacency_nodes(adj, swap))
    # the multi-pair quirk: not the clean symmetric permutation
    perm = np.arange(19)
    for a, b in pairs:
        perm[a], perm[b] = b, a
    assert not np.array_equal(tdist.swap_adjacency_nodes(adj, pairs),
                              adj[perm][:, perm])
    names = [c.split(" ")[-1] for c in tconst.INCLUDED_CHANNELS]
    csv = tmp_path / "dist.csv"
    with open(csv, "w") as f:
        f.write("from,to,distance\n")
        for i in range(19):
            for j in range(19):
                if rng.rand() < 0.7:
                    d = 0.0 if i == j else rng.rand() * 1.5
                    f.write(f"{names[i]},{names[j]},{d}\n")
    got, got_idx = tdist.build_distance_adjacency(str(csv), names)
    want, want_idx = jdist.build_distance_adjacency(str(csv), names)
    np.testing.assert_array_equal(got, want)
    assert got_idx == want_idx


# ---------------------------------------------------------------------------
# datasets and loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graph_type", ["combined", "individual"])
@pytest.mark.parametrize("augment", [False, True])
def test_detection_dataset_matches_jax(corpus, graph_type, augment):
    _, tsets, tscaler = tds.load_dataset_detection(
        max_seq_len=CLIP, seed=123, build_loaders=False,
        **_loader_kw(corpus, graph_type, augment))
    _, jsets, jscaler = jdet(max_seq_len=CLIP, seed=123, build_loaders=False,
                             **_loader_kw(corpus, graph_type, augment))
    assert tscaler.mean == jscaler.mean and tscaler.std == jscaler.std
    for split in ("train", "dev", "test"):
        got, want = tsets[split], jsets[split]
        assert got.file_tuples == want.file_tuples
        assert len(got) == len(want) > 0
        for i in range(len(got)):
            _assert_samples_equal(got[i], want[i])


@pytest.mark.parametrize("graph_type", ["combined", "individual"])
@pytest.mark.parametrize("augment", [False, True])
def test_ssl_dataset_matches_jax(corpus, graph_type, augment):
    _, tsets, _ = tds.load_dataset_ssl(
        input_len=CLIP, output_len=5, build_loaders=False,
        **_loader_kw(corpus, graph_type, augment))
    _, jsets, _ = jssl(input_len=CLIP, output_len=5, build_loaders=False,
                       **_loader_kw(corpus, graph_type, augment))
    for split in ("train", "dev", "test"):
        got, want = tsets[split], jsets[split]
        # both packages seed the SSL augmentation stream from the OS
        got.rng, want.rng = (np.random.RandomState(7),
                             np.random.RandomState(7))
        assert got.file_tuples == want.file_tuples and len(got) > 0
        for i in range(len(got)):
            g = got[i]
            _assert_samples_equal(g, want[i])
            assert g[0].shape == (CLIP, 19, 100) and g[1].shape == (5, 19, 100)


def test_datasets_read_signals_from_memory(corpus, tmp_path):
    """signals= (no h5 files) gives the samples of the h5 corpus."""
    signals = {}
    mem = tmake(str(tmp_path), num_files=4, file_seconds=96, clip_len=CLIP,
                seed=0, signals=signals)
    kw = _loader_kw(mem, "combined")
    _, msets, _ = tds.load_dataset_detection(
        max_seq_len=CLIP, build_loaders=False, signals=signals, **kw)
    _, fsets, _ = tds.load_dataset_detection(
        max_seq_len=CLIP, build_loaders=False,
        **_loader_kw(corpus, "combined"))
    for i in range(len(fsets["dev"])):
        _assert_samples_equal(msets["dev"][i], fsets["dev"][i])


def _batches(loader, epochs=2):
    return [b for _ in range(epochs) for b in loader]


@pytest.mark.parametrize("num_workers", [1, 3])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batch_order_matches_jax(corpus, num_workers, shuffle):
    _, tsets, _ = tds.load_dataset_detection(
        max_seq_len=CLIP, build_loaders=False,
        **_loader_kw(corpus, "combined"))
    _, jsets, _ = jdet(max_seq_len=CLIP, build_loaders=False,
                       **_loader_kw(corpus, "combined"))
    got = _batches(TLoader(tsets["train"], 5, shuffle=shuffle,
                           num_workers=num_workers, seed=4))
    want = _batches(JLoader(jsets["train"], 5, shuffle=shuffle,
                            num_workers=num_workers, seed=4))
    assert len(got) == len(want) == 2 * -(-len(tsets["train"]) // 5)
    assert [len(b) for b in got] == [len(b) for b in want]
    for g, w in zip(got, want):
        assert g.names == w.names
        np.testing.assert_allclose(g.x, w.x, rtol=0, atol=FEAT_ATOL)
        np.testing.assert_array_equal(g.y, w.y)
        np.testing.assert_array_equal(g.seq_lengths, w.seq_lengths)
        np.testing.assert_allclose(g.supports, w.supports, rtol=0,
                                   atol=FEAT_ATOL)
        np.testing.assert_array_equal(g.adj, w.adj)
    if shuffle:  # the two epochs are shuffled differently
        first = sum((b.names for b in got[:len(got) // 2]), [])
        second = sum((b.names for b in got[len(got) // 2:]), [])
        assert sorted(first) == sorted(second) and first != second


def test_loader_surfaces_a_worker_error():
    class Bad:
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 4:
                raise KeyError("clip 4")
            return (np.zeros((2, 19, 3), np.float32), np.float32(0),
                    np.int32(2), [], [], str(i))

    with pytest.raises(KeyError, match="clip 4"):
        list(TLoader(Bad(), 2, num_workers=3))


def test_slicing_matches_jax(corpus):
    h5 = os.path.join(corpus["input_dir"], "synthetic_001.h5")
    edf = os.path.join(corpus["raw_data_dir"], "synthetic_001.edf")
    from eeg_gnn_tpu.data import clips as jclips

    stem = edf.split(".edf")[0]
    assert tclips.get_seizure_times(stem) == jclips.get_seizure_times(stem)
    assert tclips.get_seizure_classes(stem) == \
        jclips.get_seizure_classes(stem)
    for idx in range(8):
        got = tclips.slice_detection_clip(h5, edf, idx, 1, CLIP, True)
        want = jclips.slice_detection_clip(h5, edf, idx, 1, CLIP, True)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=FEAT_ATOL)
        assert got[1] == want[1]
        np.testing.assert_allclose(
            tclips.slice_ssl_clip(h5, idx, 1, CLIP, False),
            jclips.slice_ssl_clip(h5, idx, 1, CLIP, False), rtol=0,
            atol=FEAT_ATOL)
    clip = np.ones((7, 19, 4))
    for max_len in (5, 7, 10):
        got, want = tclips.pad_clip(clip, max_len, -1.0), \
            jclips.pad_clip(clip, max_len, -1.0)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


@pytest.mark.parametrize("task", ["detection", "ssl"])
def test_raw_datasets_match_jax(corpus, task):
    """``raw_mode``: the raw clips of the on-device pipeline, exactly; the
    loader batches them with no supports."""
    kw = _loader_kw(corpus, "combined")
    if task == "detection":
        got = tds.load_dataset_detection(max_seq_len=CLIP, raw_mode=True,
                                         **kw)
        want = jdet(max_seq_len=CLIP, raw_mode=True, **kw)
    else:
        got = tds.load_dataset_ssl(input_len=CLIP, output_len=4,
                                   raw_mode=True, **kw)
        want = jssl(input_len=CLIP, output_len=4, raw_mode=True, **kw)
    for split in ("train", "dev", "test"):
        a, b = got[1][split], want[1][split]
        assert type(a).__name__ == type(b).__name__
        assert len(a) == len(b)
        for i in range(len(a)):
            ga, gb = a[i], b[i]
            np.testing.assert_array_equal(ga[0], gb[0])
            np.testing.assert_array_equal(ga[1], gb[1])
            assert ga[0].dtype == np.float32 and ga[2] == gb[2]
            assert ga[3] == [] and ga[4] == [] and ga[5] == gb[5]
    batch = next(iter(got[0]["train"]))
    assert batch.x.shape == (4, 19, CLIP * 200) and batch.supports is None
    from eeg_gnn_tpu.data import clips as jclips

    h5 = os.path.join(corpus["input_dir"], sorted(
        f for f in os.listdir(corpus["input_dir"]) if f.endswith(".h5"))[0])
    for idx in range(3):
        np.testing.assert_array_equal(tclips.slice_raw_clip(h5, idx, CLIP),
                                      jclips.slice_raw_clip(h5, idx, CLIP))


def test_unported_data_paths_raise(corpus):
    kw = _loader_kw(corpus, "combined")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tds.load_dataset_detection(max_seq_len=CLIP, preproc_dir="/x", **kw)
    # the Dense-CNN's flat-clip dataset runs (against JAX's) and refuses
    # preproc_dir as the others do
    dc_kw = {k: kw[k] for k in ("input_dir", "raw_data_dir",
                                "train_batch_size", "test_batch_size",
                                "standardize", "num_workers", "marker_dir")}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tds.load_dataset_densecnn_classification(
            max_seq_len=CLIP, preproc_dir="/x", **dc_kw)
    got = tds.load_dataset_densecnn_classification(max_seq_len=CLIP,
                                                   **dc_kw)[1]
    want = jdc_cls(max_seq_len=CLIP, **dc_kw)[1]
    for split in ("train", "dev", "test"):
        assert len(got[split]) == len(want[split]) > 0
        for i in range(len(want[split])):
            _assert_samples_equal(got[split][i], want[split][i])
            assert got[split][i][0].shape == (CLIP * 100, tconst.NUM_NODES)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tds.load_dataset_classification(max_seq_len=CLIP, preproc_dir="/x",
                                        **kw)
