"""Clip slicing from resampled signal h5 files (``eeg_gnn_tpu/data/clips.py``).

Parity: the per-task ``computeSliceMatrix`` variants of the reference's
dataloaders: for detection and SSL a fixed-position clip ``clip_idx`` of
``clip_len`` seconds (``data/dataloader_detection.py:25-85``,
``data/dataloader_ssl.py:24-82``), for classification a variable-length
clip around one seizure (``data/dataloader_classification.py:25-87``),
each windowed into ``time_step_size``-second steps with optional FFT
features. Annotation parsing (``.tse_bi`` / ``.tse``) follows
``data/data_utils.py:82-136``.

``detection_clip`` / ``ssl_clip`` / ``classification_clip`` /
``raw_clip`` slice a signal already in memory; the ``slice_*`` functions
read it from its h5 file first (h5py is imported only there).
``raw_clip`` is the raw window of the on-device pipeline.
"""

from __future__ import annotations

import numpy as np

from eeg_gnn_tpu_torch.constants import ALL_LABEL_DICT, FREQUENCY
from eeg_gnn_tpu_torch.ops.fft_features import featurize_clip_np


def read_resampled_h5(h5_path: str):
    """Read {resampled_signal, resample_freq} written by the ingest tool."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        signal = f["resampled_signal"][()]
        freq = f["resample_freq"][()]
    if int(freq) != FREQUENCY:
        raise ValueError(f"{h5_path}: resample_freq {freq} != {FREQUENCY}")
    return signal


def get_seizure_times(file_stem: str):
    """Seizure [start, end] times (s) from a ``.tse_bi`` annotation file.

    Parity: reference ``getSeizureTimes`` (data/data_utils.py:82-102);
    ``file_stem`` is the edf path without extension.
    """
    tse_file = file_stem + ".tse_bi"
    times = []
    with open(tse_file) as f:
        for line in f.readlines():
            if "seiz" in line:
                parts = line.strip().split(" ")
                times.append([float(parts[0]), float(parts[1])])
    return times


def get_seizure_classes(file_stem: str, label_dict=None):
    """Seizure class ids from a ``.tse`` annotation file.

    Parity: reference ``getSeizureClass`` (data/data_utils.py:105-136).
    """
    label_dict = ALL_LABEL_DICT if label_dict is None else label_dict
    targets = list(label_dict.keys())
    classes = []
    with open(file_stem + ".tse") as f:
        for line in f.readlines():
            hits = [s for s in targets if s in line]
            if hits:
                classes.append(label_dict[hits[0]])
    return classes


def detection_clip(signal: np.ndarray, seizure_times, clip_idx: int,
                   time_step_size: int = 1, clip_len: int = 60,
                   use_fft: bool = False):
    """(eeg_clip, is_seizure) of a (channels, samples) signal: fixed window
    ``clip_idx``, labeled seizure if its sample window overlaps any
    annotated seizure interval (inclusive bounds)."""
    physical_clip_len = int(FREQUENCY * clip_len)
    start = clip_idx * physical_clip_len
    end = start + physical_clip_len
    clip = signal[:, start:end]
    eeg_clip = featurize_clip_np(clip, time_step_size, FREQUENCY, use_fft)

    is_seizure = 0
    for t0, t1 in seizure_times:
        if not (end < int(t0 * FREQUENCY) or start > int(t1 * FREQUENCY)):
            is_seizure = 1
            break
    return eeg_clip, is_seizure


def slice_detection_clip(h5_path: str, edf_path: str, clip_idx: int,
                         time_step_size: int = 1, clip_len: int = 60,
                         use_fft: bool = False):
    """Parity: detection ``computeSliceMatrix``
    (dataloader_detection.py:25-85); see :func:`detection_clip`."""
    return detection_clip(read_resampled_h5(h5_path),
                          get_seizure_times(edf_path.split(".edf")[0]),
                          clip_idx, time_step_size, clip_len, use_fft)


def ssl_clip(signal: np.ndarray, clip_idx: int, time_step_size: int = 1,
             clip_len: int = 60, use_fft: bool = False):
    """Fixed window ``clip_idx`` of a (channels, samples) signal, without a
    label."""
    physical_clip_len = int(FREQUENCY * clip_len)
    start = clip_idx * physical_clip_len
    clip = signal[:, start:start + physical_clip_len]
    return featurize_clip_np(clip, time_step_size, FREQUENCY, use_fft)


def slice_ssl_clip(h5_path: str, clip_idx: int, time_step_size: int = 1,
                   clip_len: int = 60, use_fft: bool = False):
    """Parity: SSL ``computeSliceMatrix`` (dataloader_ssl.py:24-82); see
    :func:`ssl_clip`."""
    return ssl_clip(read_resampled_h5(h5_path), clip_idx, time_step_size,
                    clip_len, use_fft)


def classification_clip(signal: np.ndarray, seizure_times, seizure_idx: int,
                        time_step_size: int = 1, clip_len: int = 60,
                        use_fft: bool = False):
    """The variable-length clip of seizure ``seizure_idx`` of a (channels,
    samples) signal: from max(the previous seizure's end sample + 1, onset
    - 2 s) to min(that + ``clip_len`` s, the seizure's end), windowed
    (a trailing partial window dropped)."""
    offset = 2  # the reference's hard-coded pre-onset context (:44)
    cur = seizure_times[seizure_idx]
    pre_end = (int(FREQUENCY * seizure_times[seizure_idx - 1][1])
               if seizure_idx > 0 else 0)
    start_t = max(pre_end + 1, int(FREQUENCY * (cur[0] - offset)))
    end_t = min(start_t + int(FREQUENCY * clip_len), int(FREQUENCY * cur[1]))
    return featurize_clip_np(signal[:, start_t:end_t], time_step_size,
                             FREQUENCY, use_fft)


def slice_classification_clip(h5_path: str, edf_path: str, seizure_idx: int,
                              time_step_size: int = 1, clip_len: int = 60,
                              use_fft: bool = False):
    """Parity: classification ``computeSliceMatrix``
    (dataloader_classification.py:25-87); see
    :func:`classification_clip`."""
    return classification_clip(read_resampled_h5(h5_path),
                               get_seizure_times(edf_path.split(".edf")[0]),
                               seizure_idx, time_step_size, clip_len,
                               use_fft)


def raw_clip(signal: np.ndarray, clip_idx: int, clip_len: int = 60):
    """Raw (num_channels, clip_len*FREQUENCY) window ``clip_idx`` of a
    (channels, samples) signal, for the on-device featurization pipeline
    (``data/device_pipeline.py``): the host only slices."""
    step = int(FREQUENCY * clip_len)
    start = clip_idx * step
    return np.ascontiguousarray(signal[:, start:start + step])


def slice_raw_clip(h5_path: str, clip_idx: int, clip_len: int = 60):
    """Parity: JAX ``data/clips.py:slice_raw_clip``; see :func:`raw_clip`."""
    return raw_clip(read_resampled_h5(h5_path), clip_idx, clip_len)


def pad_clip(clip: np.ndarray, max_seq_len: int, padding_val: float = 0.0):
    """Zero-pad a (T, N, D) clip to max_seq_len; returns (padded, seq_len).

    Parity: reference dataloader_classification.py:334-352.
    """
    curr_len = clip.shape[0]
    seq_len = int(min(curr_len, max_seq_len))
    if curr_len < max_seq_len:
        pad = np.ones((max_seq_len - curr_len,) + clip.shape[1:]) * padding_val
        clip = np.concatenate([clip, pad], axis=0)
    return clip[:max_seq_len], seq_len
