"""The port's clip store (``eeg_gnn_tpu_torch/data/clipstore.py`` and its
native gather, ``eeg_gnn_tpu_torch/native/clipstore.cpp``) against the
JAX package's on the CPU, on seeded numpy clips: the store's bytes and
sidecar, the native gather and its plain version against JAX's
``ClipStore.gather``, the out-of-range refusal, ``ClipStoreLoader``'s
batches for the same seed, ``build_clipstore_from_detection_markers``
from h5 files and from signals in memory, and the build's refusal to
fall back when g++ fails. Everything bitwise: the store holds float32
copies and the gathers copy them."""

import os

import numpy as np
import pytest

from eeg_gnn_tpu.data import clipstore as jcs
from eeg_gnn_tpu_torch.data import clipstore as tcs
from eeg_gnn_tpu_torch.data.clips import read_resampled_h5
from eeg_gnn_tpu_torch.data.loader import Batch
from eeg_gnn_tpu_torch.data.synthetic import make_synthetic_corpus


def _stores(tmp_path, clips, labels=None, names=None):
    tp, jp = str(tmp_path / "t.ecs"), str(tmp_path / "j.ecs")
    tcs.write_clipstore(tp, clips, labels, names)
    jcs.write_clipstore(jp, clips, labels, names)
    return tp, jp


@pytest.mark.parametrize("with_meta", [True, False])
def test_files_match_jax(rng, tmp_path, with_meta):
    clips = rng.randn(7, 19, 50) * 30  # float64 in: stored as float32
    labels = rng.randint(0, 2, 7) if with_meta else None
    names = [f"f_{i}" for i in range(7)] if with_meta else None
    tp, jp = _stores(tmp_path, clips, labels, names)
    for suffix in ("", ".json"):
        with open(tp + suffix, "rb") as a, open(jp + suffix, "rb") as b:
            assert a.read() == b.read()
    assert os.path.getsize(tp) == 64 + 7 * 19 * 50 * 4


@pytest.mark.parametrize("num_threads", [0, 1, 3])
def test_gathers_match_jax(rng, tmp_path, num_threads):
    clips = rng.randn(37, 19, 400).astype(np.float32)
    tp, jp = _stores(tmp_path, clips, rng.randint(0, 2, 37))
    store, jstore = tcs.ClipStore(tp, num_threads), jcs.ClipStore(jp)
    assert (store.num_clips, store.channels, store.samples, len(store)) == \
        (37, 19, 400, 37)
    for idx in (rng.randint(0, 37, 16), np.arange(37)[::-1], [5], []):
        want = jstore.gather(idx)
        for got in (store.gather(idx), store.gather_plain(idx)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == np.float32 and got.shape == want.shape
    out = np.empty((3, 19, 400), np.float32)
    assert store.gather([1, 2, 3], out=out) is out
    np.testing.assert_array_equal(out, clips[1:4])
    with pytest.raises(ValueError, match="C-contiguous float32"):
        store.gather([1, 2], out=out)
    store.close()
    with pytest.raises(ValueError, match="closed"):
        store.gather([0])


def test_gather_out_of_range_raises(rng, tmp_path):
    tp, _ = _stores(tmp_path, rng.randn(4, 2, 8).astype(np.float32))
    store = tcs.ClipStore(tp)
    for idx in ([0, 4], [-1], [3, 0, 99]):
        with pytest.raises(IndexError, match="out of range"):
            store.gather(idx)
    with open(tp, "r+b") as f:  # truncated data: refused at open
        f.truncate(64 + 4 * 2 * 8 * 4 - 4)
    with pytest.raises(ValueError, match="truncated"):
        tcs.ClipStore(tp)
    bad = tmp_path / "bad.ecs"
    bad.write_bytes(b"XXXX" + bytes(60))
    with pytest.raises(ValueError, match="not a clip store"):
        tcs.ClipStore(str(bad))


@pytest.mark.parametrize("shuffle,drop_last,labelled", [
    (True, False, True), (False, False, True), (True, True, False)])
def test_loader_batches_match_jax(rng, tmp_path, shuffle, drop_last,
                                  labelled):
    clips = rng.randn(10, 19, 400).astype(np.float32)
    labels = rng.randint(0, 2, 10) if labelled else None
    names = [f"clip_{i}" for i in range(10)] if labelled else None
    tp, jp = _stores(tmp_path, clips, labels, names)
    loader = tcs.ClipStoreLoader(tcs.ClipStore(tp), batch_size=4,
                                 shuffle=shuffle, seq_len=2, seed=7,
                                 drop_last=drop_last)
    jloader = jcs.ClipStoreLoader(jcs.ClipStore(jp), batch_size=4,
                                  shuffle=shuffle, seq_len=2, seed=7,
                                  drop_last=drop_last)
    assert len(loader) == len(jloader) == (2 if drop_last else 3)
    for _ in range(2):  # two epochs: the shuffle stream goes on
        got, want = list(loader), list(jloader)
        assert len(got) == len(want) == len(loader)
        for a, b in zip(got, want):
            assert isinstance(a, Batch)
            for k in ("x", "y", "seq_lengths"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
                assert getattr(a, k).dtype == getattr(b, k).dtype
            assert a.names == b.names and a.supports is None and a.adj is None


@pytest.mark.parametrize("split", ["train", "dev"])
def test_build_from_detection_markers_matches_jax(tmp_path, capsys, split):
    p = make_synthetic_corpus(str(tmp_path / "c"), num_files=3,
                              file_seconds=36, clip_len=12, seed=3)
    jp, tp = str(tmp_path / "j.ecs"), str(tmp_path / "t.ecs")
    n = jcs.build_clipstore_from_detection_markers(
        jp, p["input_dir"], p["marker_dir"], split, 12)
    assert tcs.build_clipstore_from_detection_markers(
        tp, p["input_dir"], p["marker_dir"], split, 12) == n > 0
    signals = {os.path.join(p["input_dir"], f): read_resampled_h5(
        os.path.join(p["input_dir"], f)) for f in os.listdir(p["input_dir"])}
    mp = str(tmp_path / "m.ecs")
    assert tcs.build_clipstore_from_detection_markers(
        mp, p["input_dir"], p["marker_dir"], split, 12,
        signals=signals) == n
    for suffix in ("", ".json"):
        with open(jp + suffix, "rb") as a:
            want = a.read()
        for path in (tp, mp):
            with open(path + suffix, "rb") as b:
                assert b.read() == want
    store = tcs.ClipStore(tp)
    assert store.samples == 12 * 200 and set(store.labels) <= {0.0, 1.0}
    capsys.readouterr()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No numpy fallback: a source g++ rejects raises with its output."""
    src = tmp_path / "clipstore.cpp"
    src.write_text('extern "C" int ecs_gather( {\n')
    monkeypatch.setattr(tcs, "_SRC", str(src))
    monkeypatch.setattr(tcs, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed.*error"):
        tcs.load_native.__wrapped__()
    assert os.listdir(tmp_path / "build") == []  # no half-written library
