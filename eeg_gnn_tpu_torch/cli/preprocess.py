"""Offline preprocessing CLIs (``eeg_gnn_tpu/cli/preprocess.py``: the same
subcommands, flags, defaults and outputs).

Parity with the reference's three preprocessing entry points:

- ``resample``: EDF -> 200 Hz h5 (reference ``data/resample_signals.py``),
  using the pure-numpy EDF reader (no pyedflib).
- ``detection`` / ``classification`` / ``ssl``: ahead-of-time featurized
  clip caches consumed via ``--preproc_dir``
  (reference ``data/preprocess_detection.py`` / ``_classification.py``).
- ``graph``: the distance-graph pickle from an electrode-distance CSV.

Each writer has an in-memory half and an h5 write, as ``data/clips.py``
splits slicing from reading: :func:`resample_edf` resamples one recording,
and the clip caches slice a signal in memory with ``data/clips.py``'s
``detection_clip`` / ``classification_clip`` / ``ssl_clip``. On hosts
without h5py, ``signals`` (resampled signals by h5 path, as
``data/synthetic.make_synthetic_corpus(signals=...)`` fills it) stands in
for the resampled files, and a dict given as ``resample_all``'s
``signals`` or the caches' ``clips`` receives each output under its h5
path instead of the file being written. h5py is imported only where a
file is read or written.

Usage:
    python -m eeg_gnn_tpu_torch.cli.preprocess resample --raw_edf_dir D \
        --save_dir S
    python -m eeg_gnn_tpu_torch.cli.preprocess detection --resampled_dir R \
        --raw_data_dir D --marker_dir M --output_dir O --clip_len 60
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np

from eeg_gnn_tpu_torch.constants import FREQUENCY, INCLUDED_CHANNELS
from eeg_gnn_tpu_torch.data import clips as clip_ops


def _write_h5(path, signal):
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("resampled_signal", data=signal)
        f.create_dataset("resample_freq", data=FREQUENCY)


def _done(path: str, outputs: Optional[dict]) -> bool:
    """Whether an output exists already (in ``outputs`` when given, else
    on disk): existing outputs are skipped."""
    return path in outputs if outputs is not None else os.path.exists(path)


def _signal(h5_path: str, signals: Optional[dict]) -> np.ndarray:
    if signals is not None:
        return signals[h5_path]
    return clip_ops.read_resampled_h5(h5_path)


def _write_clip(path: str, clip: np.ndarray, clips: Optional[dict]):
    if clips is not None:
        clips[path] = clip
        return
    import h5py

    with h5py.File(path, "w") as hf:
        hf.create_dataset("clip", data=clip)


def resample_edf(edf_path: str) -> np.ndarray:
    """One recording reordered to INCLUDED_CHANNELS and resampled to 200 Hz
    by the FFT method (scipy.signal.resample, as the reference,
    data_utils.py:158-170): (19, seconds * 200) float64."""
    from scipy.signal import resample

    from eeg_gnn_tpu_torch.data.edf import (
        get_ordered_channels,
        read_edf_header,
        read_edf_signals,
    )

    header = read_edf_header(edf_path)
    ordered = get_ordered_channels(edf_path, header.labels, INCLUDED_CHANNELS)
    signals = read_edf_signals(edf_path, header)[ordered]
    freq = float(header.sample_frequencies()[ordered[0]])
    seconds = signals.shape[1] / freq
    return resample(signals, num=int(FREQUENCY * seconds), axis=1)


def resample_all(raw_edf_dir: str, save_dir: str,
                 signals: Optional[dict] = None) -> list:
    """Walk ``raw_edf_dir`` for .edf files and resample each
    (:func:`resample_edf`) to ``save_dir/<name>.h5``; with ``signals`` (a
    dict) each signal lands there under that path instead.

    Returns the list of failed files (reference resample_signals.py:49-52
    swallows per-file failures the same way).
    """
    import scipy.signal  # noqa: F401  (missing scipy raises, not per file)

    os.makedirs(save_dir, exist_ok=True)
    edf_files = clip_ops.find_edf_files(raw_edf_dir)
    failed_files = []
    for idx, edf_fn in enumerate(edf_files):
        new_file_name = os.path.basename(edf_fn).split(".edf")[0] + ".h5"
        save_path = os.path.join(save_dir, new_file_name)
        if _done(save_path, signals):
            continue
        try:
            resampled = resample_edf(edf_fn)
            if signals is None:
                _write_h5(save_path, resampled)
            else:
                signals[save_path] = resampled
        except Exception as e:
            print(f"{edf_fn} failed: {e}", file=sys.stderr)
            failed_files.append(edf_fn)
        if (idx + 1) % 50 == 0:
            print(f"resampled {idx + 1}/{len(edf_files)}")
    return failed_files


def preprocess_detection(resampled_dir, raw_data_dir, marker_dir, output_dir,
                         clip_len, time_step_size=1, use_fft=True,
                         signals=None, clips=None):
    """AOT cache of detection clips: one ``{clip}`` h5 per marker line
    (reference data/preprocess_detection.py:89-130)."""
    os.makedirs(output_dir, exist_ok=True)
    edf_files = clip_ops.find_edf_files(raw_data_dir)
    for split in ("train", "dev", "test"):
        for kind in ("sz", "nosz"):
            marker = os.path.join(
                marker_dir, f"{split}Set_seq2seq_{clip_len}s_{kind}.txt")
            if not os.path.exists(marker):
                continue
            with open(marker) as f:
                lines = [ln.strip("\n").split(",") for ln in f.readlines()]
            for h5_fn, _ in lines:
                out = os.path.join(output_dir, h5_fn)
                if _done(out, clips):
                    continue
                clip_idx = int(h5_fn.split("_")[-1].split(".h5")[0])
                edf = [f for f in edf_files
                       if h5_fn.split(".edf")[0] + ".edf" in f][0]
                h5_path = os.path.join(
                    resampled_dir, h5_fn.split(".edf")[0] + ".h5")
                clip, _ = clip_ops.detection_clip(
                    _signal(h5_path, signals),
                    clip_ops.get_seizure_times(edf.split(".edf")[0]),
                    clip_idx, time_step_size, clip_len, use_fft)
                _write_clip(out, clip, clips)
            print(f"cached {split}/{kind}: {len(lines)} clips")


def preprocess_classification(resampled_dir, raw_data_dir, marker_dir,
                              output_dir, clip_len, time_step_size=1,
                              use_fft=True, signals=None, clips=None):
    """AOT cache of classification clips, ``{edf}_{seizure_idx}.h5``
    (reference data/preprocess_classification.py:71-112)."""
    os.makedirs(output_dir, exist_ok=True)
    edf_files = clip_ops.find_edf_files(raw_data_dir)
    for split in ("train", "dev", "test"):
        marker = os.path.join(marker_dir, f"{split}Set_seizure_files.txt")
        if not os.path.exists(marker):
            continue
        with open(marker) as f:
            rows = [ln.strip("\n").split(",") for ln in f.readlines()]
        for edf_fn, _, seizure_idx in rows:
            out = os.path.join(output_dir, f"{edf_fn}_{seizure_idx}.h5")
            if _done(out, clips):
                continue
            edf = [f for f in edf_files if edf_fn in f][0]
            h5_path = os.path.join(
                resampled_dir, edf_fn.split(".edf")[0] + ".h5")
            clip = clip_ops.classification_clip(
                _signal(h5_path, signals),
                clip_ops.get_seizure_times(edf.split(".edf")[0]),
                int(seizure_idx), time_step_size, clip_len, use_fft)
            _write_clip(out, clip, clips)
        print(f"cached {split}: {len(rows)} clips")


def preprocess_ssl(resampled_dir, marker_dir, output_dir, clip_len,
                   time_step_size=1, use_fft=True, signals=None, clips=None):
    """AOT cache of SSL clips: one ``{clip}`` h5 per unique clip named in
    the consecutive-pair markers ``{split}Set_seq2seq_{clip_len}s.txt``.

    The SSL loader consumes these via ``--preproc_dir`` exactly like the
    reference (``dataloader_ssl.py:312-315`` reads ``hf['clip']`` for both
    clips of the pair); the clip math is the SSL ``computeSliceMatrix``
    (``dataloader_ssl.py:24-82`` — fixed window, no label).
    """
    from eeg_gnn_tpu_torch.data.markers import parse_ssl_markers

    os.makedirs(output_dir, exist_ok=True)
    for split in ("train", "dev", "test"):
        marker = os.path.join(
            marker_dir, f"{split}Set_seq2seq_{clip_len}s.txt")
        if not os.path.exists(marker):
            continue
        clip_names = sorted({name for pair in parse_ssl_markers(marker)
                             for name in pair})
        for h5_fn in clip_names:
            out = os.path.join(output_dir, h5_fn)
            if _done(out, clips):
                continue
            clip_idx = int(h5_fn.split("_")[-1].split(".h5")[0])
            h5_path = os.path.join(
                resampled_dir, h5_fn.split(".edf")[0] + ".h5")
            clip = clip_ops.ssl_clip(_signal(h5_path, signals), clip_idx,
                                     time_step_size, clip_len, use_fft)
            _write_clip(out, clip, clips)
        print(f"cached {split}: {len(clip_names)} clips")


def main(argv=None):
    p = argparse.ArgumentParser("Offline preprocessing for eeg_gnn_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("resample")
    pr.add_argument("--raw_edf_dir", required=True)
    pr.add_argument("--save_dir", required=True)

    for name in ("detection", "classification", "ssl"):
        pc = sub.add_parser(name)
        pc.add_argument("--resampled_dir", required=True)
        if name != "ssl":  # SSL clips need no annotations, only markers
            pc.add_argument("--raw_data_dir", required=True)
        pc.add_argument("--marker_dir", required=True)
        pc.add_argument("--output_dir", required=True)
        pc.add_argument("--clip_len", type=int, default=60)
        pc.add_argument("--time_step_size", type=int, default=1)
        pc.add_argument("--no_fft", dest="use_fft", action="store_false",
                        default=True)

    # distance-graph regeneration: the counterpart of the reference notebook
    # data/electrode_graph/generate_adj_mx.ipynb (cell 4) that produced the
    # shipped adj_mx_3d.pkl — rebuild it from a from,to,distance CSV.
    pg = sub.add_parser("graph")
    pg.add_argument("--distances_csv", required=True,
                    help="3-D electrode pairwise distances (from,to,distance)")
    pg.add_argument("--output_pkl", required=True,
                    help="Where to write [channels, name->idx, adj] pickle")
    pg.add_argument("--dist_k", type=float, default=0.9,
                    help="Distance threshold (reference default 0.9)")

    ns = p.parse_args(argv)
    if ns.cmd == "graph":
        import pickle

        from eeg_gnn_tpu_torch.graphs.distance import (
            build_distance_adjacency,
        )

        adj, idx = build_distance_adjacency(ns.distances_csv,
                                            dist_k=ns.dist_k)
        with open(ns.output_pkl, "wb") as f:
            pickle.dump([list(INCLUDED_CHANNELS), idx,
                         adj.astype(np.float32)], f)
        print(f"DONE. {int((adj > 0).sum())} nonzeros -> {ns.output_pkl}")
    elif ns.cmd == "resample":
        failed = resample_all(ns.raw_edf_dir, ns.save_dir)
        print(f"DONE. {len(failed)} failed files.")
    elif ns.cmd == "detection":
        preprocess_detection(ns.resampled_dir, ns.raw_data_dir, ns.marker_dir,
                             ns.output_dir, ns.clip_len, ns.time_step_size,
                             ns.use_fft)
    elif ns.cmd == "ssl":
        preprocess_ssl(ns.resampled_dir, ns.marker_dir, ns.output_dir,
                       ns.clip_len, ns.time_step_size, ns.use_fft)
    else:
        preprocess_classification(ns.resampled_dir, ns.raw_data_dir,
                                  ns.marker_dir, ns.output_dir, ns.clip_len,
                                  ns.time_step_size, ns.use_fft)


if __name__ == "__main__":
    main()
