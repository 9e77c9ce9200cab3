"""Synthetic TUSZ-like corpus generator (``eeg_gnn_tpu/data/synthetic.py``:
the same seed writes the same files).

Produces a directory tree compatible with the ``load_dataset_*`` factories
(resampled-signal h5 files, ``.tse_bi``/``.tse`` annotations, file markers,
scaler pickles, distance-graph pickle) so the full pipeline — markers ->
slicing -> FFT -> augmentation -> graphs -> training -> eval — runs
end-to-end in tests and benchmarks without the (restricted-access) TUSZ
corpus. Signals embed a crude "seizure" (amplitude + rhythm change) so
models can actually learn above-chance AUROC on it.
"""

from __future__ import annotations

import os
import pickle

from typing import Optional

import numpy as np

from eeg_gnn_tpu_torch.constants import FREQUENCY, NUM_NODES
from eeg_gnn_tpu_torch.ops.fft_features import featurize_clip_np


def _write_h5(path, signal):
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("resampled_signal", data=signal)
        f.create_dataset("resample_freq", data=FREQUENCY)


def _smooth_walk(rng, n, tau=8.0):
    """Per-second log-amplitude random walk smoothed to time constant
    ``tau`` seconds: values drift slowly, so the near future is
    predictable from the recent past."""
    w = np.cumsum(rng.randn(NUM_NODES, n) * 0.25, axis=1)
    k = int(max(3, 2 * tau))
    kernel = np.exp(-np.arange(-k, k + 1) ** 2 / (2 * tau ** 2))
    kernel /= kernel.sum()
    sm = np.stack([np.convolve(row, kernel, mode="same") for row in w])
    sm -= sm.mean(axis=1, keepdims=True)
    return np.exp(np.clip(sm, -0.8, 0.8))


def _signal(rng, seconds, seizure_spans):
    """Noise + 10 Hz alpha with SLOWLY-DRIFTING per-channel amplitude;
    seizures add 3 Hz spikes under a raised-cosine onset/offset envelope.

    The drift/envelope give the signal real temporal structure: the next
    window's spectrum is predictable from the recent past, so the SSL
    next-window task (benchmarks/ssl_efficacy.py) has learnable,
    detection-relevant content instead of an i.i.d. noise floor — while
    detection itself stays a band-power task like before (boundary clips
    become genuinely weak positives under the envelope ramps)."""
    t = np.arange(seconds * FREQUENCY) / FREQUENCY
    # broadband amplitude also drifts slowly (real EEG band powers are
    # strongly autocorrelated): EVERY log-FFT bin carries a predictable
    # component, not just the alpha peak
    env_b = np.repeat(_smooth_walk(rng, seconds), FREQUENCY, axis=1)
    base = rng.randn(NUM_NODES, t.size) * 8.0 * env_b[:, : t.size]
    env = np.repeat(_smooth_walk(rng, seconds), FREQUENCY, axis=1)
    alpha = (10.0 * env[:, : t.size]
             * np.sin(2 * np.pi * 10.0 * t + rng.rand(NUM_NODES, 1) * 6.28))
    sig = base + alpha
    for t0, t1 in seizure_spans:
        sl = slice(int(t0 * FREQUENCY), int(t1 * FREQUENCY))
        n_s = sl.stop - sl.start
        ramp = np.sin(np.linspace(0, np.pi, n_s)) ** 2  # raised-cosine
        spike = 40.0 * ramp * np.sin(
            2 * np.pi * 3.0 * t[sl] + rng.rand(NUM_NODES, 1) * 6.28)
        sig[:, sl] += spike + rng.randn(NUM_NODES, n_s) * 20.0 * ramp
    return sig.astype(np.float64)


def make_synthetic_corpus(root: str, num_files: int = 6, file_seconds: int = 240,
                          clip_len: int = 12, seed: int = 0,
                          signals: Optional[dict] = None):
    """Build the corpus; returns a dict of directory paths.

    ``signals``: a dict that receives each resampled signal under its h5
    path instead of the file being written (for hosts without h5py; the
    datasets read it back through their ``signals=``). Everything else is
    written as usual.

    Layout:
        root/resampled/<name>.h5      — resampled signals
        root/edf/<name>.edf           — empty placeholder (path anchors)
        root/edf/<name>.tse_bi/.tse   — annotations
        root/markers/...              — detection/classification/ssl markers
        root/adj_mx_3d.pkl            — distance-graph pickle (synthetic but
                                        same format as the reference's)
    """
    rng = np.random.RandomState(seed)
    resampled = os.path.join(root, "resampled")
    edf_dir = os.path.join(root, "edf")
    markers = os.path.join(root, "markers")
    for d in (resampled, edf_dir, markers):
        os.makedirs(d, exist_ok=True)

    det_sz, det_nosz, ssl_pairs, cls_rows = [], [], [], []
    all_feats = []

    num_clips = file_seconds // clip_len
    for fi in range(num_files):
        name = f"synthetic_{fi:03d}.edf"
        stem = name.split(".edf")[0]
        # 1-2 seizures per file at random positions
        spans = []
        for _ in range(rng.randint(1, 3)):
            t0 = rng.uniform(5, file_seconds - 30)
            spans.append((t0, t0 + rng.uniform(8, 20)))
        spans.sort()
        sig = _signal(rng, file_seconds, spans)
        h5_path = os.path.join(resampled, stem + ".h5")
        if signals is None:
            _write_h5(h5_path, sig)
        else:
            signals[h5_path] = sig

        open(os.path.join(edf_dir, name), "w").close()
        with open(os.path.join(edf_dir, stem + ".tse_bi"), "w") as f:
            f.write("version = tse_v1.0.0\n\n")
            for t0, t1 in spans:
                f.write(f"{t0:.4f} {t1:.4f} seiz 1.0000\n")
        classes = ["fnsz", "gnsz", "cpsz", "tnsz"]
        with open(os.path.join(edf_dir, stem + ".tse"), "w") as f:
            f.write("version = tse_v1.0.0\n\n")
            for si, (t0, t1) in enumerate(spans):
                f.write(f"{t0:.4f} {t1:.4f} {classes[si % 4]} 1.0000\n")

        for ci in range(num_clips):
            s0, s1 = ci * clip_len, (ci + 1) * clip_len
            overlap = any(not (s1 * FREQUENCY < t0 * FREQUENCY or
                               s0 * FREQUENCY > t1 * FREQUENCY)
                          for t0, t1 in spans)
            line = f"{name}_{ci}.h5,{1 if overlap else 0}\n"
            (det_sz if overlap else det_nosz).append(line)
            if ci + 1 < num_clips:
                ssl_pairs.append(f"{name}_{ci}.h5,{name}_{ci + 1}.h5\n")
        for si, _ in enumerate(spans):
            cls_rows.append(f"{name},{si % 4},{si}\n")

        all_feats.append(featurize_clip_np(sig[:, :clip_len * FREQUENCY], 1,
                                           FREQUENCY, True))

    rng.shuffle(det_sz)
    rng.shuffle(det_nosz)
    rng.shuffle(ssl_pairs)
    splits = {"train": (0.0, 0.6), "dev": (0.6, 0.8), "test": (0.8, 1.0)}

    def split_rows(rows, lo, hi):
        return rows[int(lo * len(rows)):int(hi * len(rows))]

    for split, (lo, hi) in splits.items():
        with open(os.path.join(markers, f"{split}Set_seq2seq_{clip_len}s_sz.txt"), "w") as f:
            f.writelines(split_rows(det_sz, lo, hi))
        with open(os.path.join(markers, f"{split}Set_seq2seq_{clip_len}s_nosz.txt"), "w") as f:
            f.writelines(split_rows(det_nosz, lo, hi))
        with open(os.path.join(markers, f"{split}Set_seq2seq_{clip_len}s.txt"), "w") as f:
            f.writelines(split_rows(ssl_pairs, lo, hi))
        with open(os.path.join(markers, f"{split}Set_seizure_files.txt"), "w") as f:
            f.writelines(split_rows(cls_rows, lo, hi))

    # Scalar FFT-feature statistics (same pickle format as the reference's)
    feats = np.concatenate([a.reshape(-1) for a in all_feats])
    mean, std = np.float64(feats.mean()), np.float64(feats.std())
    for prefix, suffix in (
        ("seq2seq_fft_", "_szdetect_single"),   # detection
        ("seq2seq_fft_", "_single"),            # ssl
        ("fft_", "_single"),                    # classification
    ):
        with open(os.path.join(markers, f"means_{prefix}{clip_len}s{suffix}.pkl"), "wb") as f:
            pickle.dump(mean, f)
        with open(os.path.join(markers, f"stds_{prefix}{clip_len}s{suffix}.pkl"), "wb") as f:
            pickle.dump(std, f)

    # Synthetic distance graph in the reference pickle format.
    adj = np.eye(NUM_NODES, dtype=np.float32)
    coords = rng.randn(NUM_NODES, 3)
    d = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
    adj = np.exp(-np.square(d / d.std())).astype(np.float32)
    adj[d > np.median(d)] = 0.0
    np.fill_diagonal(adj, 1.0)
    adj_path = os.path.join(root, "adj_mx_3d.pkl")
    with open(adj_path, "wb") as f:
        pickle.dump([[f"ch{i}" for i in range(NUM_NODES)],
                     {f"ch{i}": i for i in range(NUM_NODES)}, adj], f)

    return {
        "input_dir": resampled,
        "raw_data_dir": edf_dir,
        "marker_dir": markers,
        "adj_mat_dir": adj_path,
        "clip_len": clip_len,
    }
