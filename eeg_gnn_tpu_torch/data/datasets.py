"""Map-style datasets of the detection, classification and SSL tasks, and
their loader factories (``eeg_gnn_tpu/data/datasets.py``).

Parity targets: ``data/dataloader_detection.py`` (SeizureDataset +
load_dataset_detection), ``data/dataloader_classification.py``,
``data/dataloader_densecnn_classification.py`` (the Dense-CNN's flat
clips) and ``data/dataloader_ssl.py``. Same sample tuple
layout ``(x, y, seq_len, supports, adj, writeout_fn)``, same marker
parsing, augmentation, standardization, and per-sample support
computation on the host (numpy; λmax by ``eigvalsh`` for ``combined``).
Batches are assembled by the threaded prefetcher of ``data/loader.py``.

``signals`` (a mapping from h5 path to its resampled signal, e.g. filled
by ``data/synthetic.make_synthetic_corpus(signals=...)``) stands in for
the h5 files on hosts without h5py.

``raw_mode`` builds the raw-clip datasets of the on-device pipeline
(``RawDetectionDataset``, ``RawSSLDataset``): the host only reads and
slices; FFT, augmentation, standardization and graphs run on the device
(``data/device_pipeline.py``).

``preproc_dir`` reads each clip from the caches of
``cli/preprocess.py`` (``hf["clip"]`` of one h5 file a clip) where the
JAX datasets do: detection ``{h5_fn}``, classification and the
Dense-CNN ``{edf_fn}_{seizure_idx}.h5`` (the Dense-CNN's ``seq_len`` is
the cached clip's first dimension), SSL both clips of the pair. The
raw-clip datasets read the resampled signals, as in JAX.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import numpy as np

from eeg_gnn_tpu_torch.constants import FREQUENCY, get_swap_pairs
from eeg_gnn_tpu_torch.data import clips as clip_ops
from eeg_gnn_tpu_torch.data.augment import random_reflect, random_scale
from eeg_gnn_tpu_torch.data.loader import DataLoader
from eeg_gnn_tpu_torch.data.markers import (
    parse_classification_markers,
    parse_detection_markers,
    parse_ssl_markers,
)
from eeg_gnn_tpu_torch.data.scaler import StandardScaler
from eeg_gnn_tpu_torch.graphs.distance import (
    load_distance_adjacency,
    swap_adjacency_nodes,
)
from eeg_gnn_tpu_torch.graphs.supports import compute_supports
from eeg_gnn_tpu_torch.graphs.xcorr import correlation_adjacency
from eeg_gnn_tpu_torch.ops.fft_features import log_amplitude_fft_np


class _BaseEEGDataset:
    """Shared machinery: augmentation, standardization, graph/supports."""

    def __init__(self, input_dir, raw_data_dir, time_step_size, max_seq_len,
                 standardize, scaler, split, data_augment, adj_mat_dir,
                 graph_type, top_k, filter_type, use_fft, preproc_dir=None,
                 rng_seed=None, signals: Optional[Mapping] = None):
        if standardize and scaler is None:
            raise ValueError("To standardize, please provide scaler.")
        if graph_type == "individual" and top_k is None:
            raise ValueError("Please specify top_k for individual graph.")
        self.input_dir = input_dir
        self.raw_data_dir = raw_data_dir
        self.time_step_size = time_step_size
        self.max_seq_len = max_seq_len
        self.standardize = standardize
        self.scaler = scaler
        self.split = split
        self.data_augment = data_augment
        self.adj_mat_dir = adj_mat_dir
        self.graph_type = graph_type
        self.top_k = top_k
        self.filter_type = filter_type
        self.use_fft = use_fft
        self.preproc_dir = preproc_dir
        self.signals = signals
        self.edf_files = (clip_ops.find_edf_files(raw_data_dir)
                          if raw_data_dir else [])
        # O(1) lookup index (marker entries carry the exact file name);
        # the reference substring-scans the whole list per sample
        # (dataloader_detection.py:364-369)
        self._edf_index = {}
        for f in self.edf_files:
            self._edf_index.setdefault(os.path.basename(f), []).append(f)
        # Unlike the reference (which relies on np.random global state in
        # worker processes), augmentation randomness is an explicit stream,
        # shared by the loader's worker threads
        self.rng = np.random.RandomState(rng_seed)
        self._distance_adj = None

    def _lookup_edf(self, edf_name: str) -> str:
        hits = self._edf_index.get(os.path.basename(edf_name), ())
        if len(hits) == 1:
            return hits[0]
        # fall back to the reference's substring semantics (and its
        # uniqueness check) for marker entries that aren't exact names
        matches = [f for f in self.edf_files if edf_name in f]
        if len(matches) != 1:
            raise ValueError(f"edf lookup for {edf_name}: {len(matches)} "
                             "matches")
        return matches[0]

    def _signal(self, h5_path: str) -> np.ndarray:
        if self.signals is not None:
            return self.signals[h5_path]
        return clip_ops.read_resampled_h5(h5_path)

    def _cached_clip(self, name: str) -> np.ndarray:
        """``hf["clip"]`` of ``preproc_dir/name``."""
        import h5py

        with h5py.File(os.path.join(self.preproc_dir, name), "r") as hf:
            return hf["clip"][()]

    def _augment(self, eeg_clip):
        if self.data_augment:
            feat, swap_nodes = random_reflect(eeg_clip, self.rng)
            feat = random_scale(feat, self.rng, self.use_fft)
        else:
            swap_nodes = None
            feat = eeg_clip.copy()
        return feat, swap_nodes

    def _graph_and_supports(self, eeg_clip, swap_nodes):
        """Per-sample adjacency + dense support matrices.

        Parity: the ``__getitem__`` tails (dataloader_detection.py:402-414).
        Correlation graphs are built from the UN-augmented clip and ignore
        swap_nodes (reference dead-code quirk, see graphs/xcorr.py).
        """
        if self.graph_type == "individual":
            adj = correlation_adjacency(eeg_clip, top_k=self.top_k,
                                        swap_nodes=swap_nodes)
            sups = compute_supports(adj, self.filter_type)
            if any(np.any(np.isnan(s)) for s in sups):
                raise ValueError("Nan found in indiv_supports!")
        elif self.adj_mat_dir is not None:
            if self._distance_adj is None:  # the reference reads it per clip
                self._distance_adj = load_distance_adjacency(self.adj_mat_dir)
            adj = swap_adjacency_nodes(self._distance_adj, swap_nodes)
            sups = compute_supports(adj, self.filter_type)
        else:
            adj, sups = [], []
        return sups, adj

    def _standardize(self, feat):
        return self.scaler.transform(feat) if self.standardize else feat


class DetectionDataset(_BaseEEGDataset):
    """Binary seizure-detection clips, train split class-balanced.

    Parity: ``data/dataloader_detection.py:130-416``.
    """

    def __init__(self, *, marker_dir, sampling_ratio=1, seed=123, **kw):
        super().__init__(**kw)
        seizure_file = os.path.join(
            marker_dir, f"{self.split}Set_seq2seq_{self.max_seq_len}s_sz.txt")
        nonseizure_file = os.path.join(
            marker_dir, f"{self.split}Set_seq2seq_{self.max_seq_len}s_nosz.txt")
        self.file_tuples = parse_detection_markers(
            self.split, seizure_file, nonseizure_file, cv_seed=seed,
            scale_ratio=sampling_ratio)

    def __len__(self):
        return len(self.file_tuples)

    def __getitem__(self, idx):
        h5_fn, seizure_label = self.file_tuples[idx]
        clip_idx = int(h5_fn.split("_")[-1].split(".h5")[0])
        if self.preproc_dir is None:
            edf_file = self._lookup_edf(h5_fn.split(".edf")[0] + ".edf")
            h5_path = os.path.join(self.input_dir,
                                   h5_fn.split(".edf")[0] + ".h5")
            eeg_clip, _ = clip_ops.detection_clip(
                self._signal(h5_path),
                clip_ops.get_seizure_times(edf_file.split(".edf")[0]),
                clip_idx, self.time_step_size, self.max_seq_len,
                self.use_fft)
        else:
            eeg_clip = self._cached_clip(h5_fn)

        feat, swap_nodes = self._augment(eeg_clip)
        feat = self._standardize(feat)
        sups, adj = self._graph_and_supports(eeg_clip, swap_nodes)
        return (
            feat.astype(np.float32),
            np.float32(seizure_label),
            np.int32(self.max_seq_len),
            sups,
            adj,
            h5_fn.split(".h5")[0],
        )


class SSLDataset(_BaseEEGDataset):
    """Consecutive-clip pairs for next-window prediction.

    Parity: ``data/dataloader_ssl.py:85-361`` — y is the first
    ``output_len`` windows of the next clip; reflection decision and scale
    factor are shared between x and y; the correlation graph comes from x.
    """

    def __init__(self, *, marker_dir, input_len, output_len, **kw):
        kw["max_seq_len"] = input_len
        super().__init__(**kw)
        self.input_len = input_len
        self.output_len = output_len
        self.file_tuples = parse_ssl_markers(
            os.path.join(marker_dir, f"{self.split}Set_seq2seq_{input_len}s.txt"))

    def __len__(self):
        return len(self.file_tuples)

    def __getitem__(self, idx):
        h5_fn_x, h5_fn_y = self.file_tuples[idx]
        clip_idx_x = int(h5_fn_x.split("_")[-1].split(".h5")[0])
        clip_idx_y = int(h5_fn_y.split("_")[-1].split(".h5")[0])
        if self.preproc_dir is None:
            h5_path = os.path.join(self.input_dir,
                                   h5_fn_x.split(".edf")[0] + ".h5")
            signal = self._signal(h5_path)
            eeg_clip_x = clip_ops.ssl_clip(signal, clip_idx_x,
                                           self.time_step_size,
                                           self.input_len, self.use_fft)
            eeg_clip_y = clip_ops.ssl_clip(signal, clip_idx_y,
                                           self.time_step_size,
                                           self.input_len, self.use_fft)
        else:
            eeg_clip_x = self._cached_clip(h5_fn_x)
            eeg_clip_y = self._cached_clip(h5_fn_y)

        if self.data_augment:
            reflect = bool(self.rng.choice([True, False]))
            x_feat, swap_nodes = random_reflect(eeg_clip_x, self.rng, reflect)
            y_feat, _ = random_reflect(eeg_clip_y, self.rng, reflect)
            scale = self.rng.uniform(0.8, 1.2)
            x_feat = random_scale(x_feat, self.rng, self.use_fft, scale)
            y_feat = random_scale(y_feat, self.rng, self.use_fft, scale)
        else:
            swap_nodes = None
            x_feat, y_feat = eeg_clip_x.copy(), eeg_clip_y.copy()

        x_feat = self._standardize(x_feat)
        y_feat = self._standardize(y_feat)

        if x_feat.shape[0] != self.input_len:
            raise ValueError(f"{h5_fn_x}: {x_feat.shape[0]} windows, not "
                             f"{self.input_len}")
        sups, adj = self._graph_and_supports(eeg_clip_x, swap_nodes)
        return (
            x_feat.astype(np.float32),
            y_feat[: self.output_len].astype(np.float32),
            np.int32(self.input_len),
            sups,
            adj,
            h5_fn_x.split(".h5")[0],
        )


class RawDetectionDataset(DetectionDataset):
    """Detection clips in RAW form for the on-device pipeline: the host
    only reads and slices the signal; FFT, augmentation, standardization
    and graphs run on the device (``data/device_pipeline.py``)."""

    def __getitem__(self, idx):
        h5_fn, seizure_label = self.file_tuples[idx]
        clip_idx = int(h5_fn.split("_")[-1].split(".h5")[0])
        h5_path = os.path.join(self.input_dir, h5_fn.split(".edf")[0] + ".h5")
        raw = clip_ops.raw_clip(self._signal(h5_path), clip_idx,
                                self.max_seq_len)
        return (
            raw.astype(np.float32),  # (C, clip_len*FREQUENCY)
            np.float32(seizure_label),
            np.int32(self.max_seq_len),
            [],
            [],
            h5_fn.split(".h5")[0],
        )


class RawSSLDataset(SSLDataset):
    """SSL clip pairs in RAW form for the on-device pipeline: x the whole
    input clip, y the first ``output_len`` seconds of the next clip."""

    def __getitem__(self, idx):
        h5_fn_x, h5_fn_y = self.file_tuples[idx]
        clip_idx_x = int(h5_fn_x.split("_")[-1].split(".h5")[0])
        clip_idx_y = int(h5_fn_y.split("_")[-1].split(".h5")[0])
        h5_path = os.path.join(self.input_dir, h5_fn_x.split(".edf")[0] + ".h5")
        signal = self._signal(h5_path)
        raw_x = clip_ops.raw_clip(signal, clip_idx_x, self.input_len)
        raw_y = clip_ops.raw_clip(signal, clip_idx_y, self.input_len)
        return (
            raw_x.astype(np.float32),
            raw_y[:, : self.output_len * FREQUENCY].astype(np.float32),
            np.int32(self.input_len),
            [],
            [],
            h5_fn_x.split(".h5")[0],
        )


class ClassificationDataset(_BaseEEGDataset):
    """4-class seizure-type clips, variable length, padded to
    ``max_seq_len`` with ``padding_val``.

    Parity: ``data/dataloader_classification.py:90-368``: augment, then
    standardize, then pad; the per-clip graph comes from the unpadded,
    un-augmented clip.
    """

    def __init__(self, *, marker_dir, padding_val=0.0, **kw):
        super().__init__(**kw)
        self.padding_val = padding_val
        self.file_tuples = parse_classification_markers(
            os.path.join(marker_dir, f"{self.split}Set_seizure_files.txt"))

    def __len__(self):
        return len(self.file_tuples)

    def __getitem__(self, idx):
        edf_fn, seizure_class, seizure_idx = self.file_tuples[idx]
        if self.preproc_dir is None:
            edf_file = self._lookup_edf(edf_fn)
            h5_path = os.path.join(self.input_dir,
                                   edf_fn.split(".edf")[0] + ".h5")
            eeg_clip = clip_ops.classification_clip(
                self._signal(h5_path),
                clip_ops.get_seizure_times(edf_file.split(".edf")[0]),
                seizure_idx, self.time_step_size, self.max_seq_len,
                self.use_fft)
        else:
            eeg_clip = self._cached_clip(f"{edf_fn}_{seizure_idx}.h5")

        feat, swap_nodes = self._augment(eeg_clip)
        feat = self._standardize(feat)
        padded, seq_len = clip_ops.pad_clip(feat, self.max_seq_len,
                                            self.padding_val)
        if np.any(np.isnan(padded)):
            raise ValueError("Nan found in x!")
        sups, adj = self._graph_and_supports(eeg_clip, swap_nodes)
        return (
            padded.astype(np.float32),
            np.int32(seizure_class),
            np.int32(seq_len),
            sups,
            adj,
            f"{edf_fn}_{seizure_idx}",
        )


class DenseCNNClassificationDataset(_BaseEEGDataset):
    """Flat (time, electrodes) clips of the Dense-CNN baseline.

    Parity: ``data/dataloader_densecnn_classification.py:27-226`` (JAX
    ``DenseCNNClassificationDataset``): the whole variable-length seizure
    clip (the classification clip's bounds) is FFT'd at once (n = its
    length), its log amplitudes zero-padded to ``max_seq_len *
    FREQUENCY / 2`` bins and transposed to (time, 19); ``seq_len`` is the
    bin count before padding. No graph. The reference's non-FFT branch
    reads an undefined name (its ``:76``), so the FFT branch is the only
    one. Augmentation reflects electrode pairs on axis 1, then scales.
    """

    def __init__(self, *, marker_dir, **kw):
        super().__init__(**kw)
        self.file_tuples = parse_classification_markers(
            os.path.join(marker_dir, f"{self.split}Set_seizure_files.txt"))

    def __len__(self):
        return len(self.file_tuples)

    def _slice(self, edf_fn, seizure_idx):
        edf_file = self._lookup_edf(edf_fn)
        h5_path = os.path.join(self.input_dir,
                               edf_fn.split(".edf")[0] + ".h5")
        signal = self._signal(h5_path)
        times = clip_ops.get_seizure_times(edf_file.split(".edf")[0])
        cur = times[seizure_idx]
        pre_end = (int(FREQUENCY * times[seizure_idx - 1][1])
                   if seizure_idx > 0 else 0)
        start_t = max(pre_end + 1, int(FREQUENCY * (cur[0] - 2)))
        end_t = min(start_t + int(FREQUENCY * self.max_seq_len),
                    int(FREQUENCY * cur[1]))
        clip = signal[:, start_t:end_t]
        eeg_clip = log_amplitude_fft_np(clip, n=clip.shape[-1])
        seq_len = eeg_clip.shape[-1]
        diff = int(FREQUENCY * self.max_seq_len / 2) - seq_len
        if diff > 0:
            eeg_clip = np.concatenate(
                [eeg_clip, np.zeros((eeg_clip.shape[0], diff))], axis=1)
        return eeg_clip.T, seq_len  # (time, channels)

    def __getitem__(self, idx):
        edf_fn, seizure_class, seizure_idx = self.file_tuples[idx]
        if self.preproc_dir is None:
            eeg_clip, seq_len = self._slice(edf_fn, seizure_idx)
        else:
            eeg_clip = self._cached_clip(f"{edf_fn}_{seizure_idx}.h5")
            seq_len = eeg_clip.shape[0]
        if self.data_augment:
            reflected = eeg_clip.copy()
            if self.rng.choice([True, False]):
                for a, b in get_swap_pairs():
                    reflected[:, [a, b]] = eeg_clip[:, [b, a]]
            eeg_clip = random_scale(reflected, self.rng, self.use_fft)
        eeg_clip = self._standardize(eeg_clip)
        return (
            eeg_clip.astype(np.float32),
            np.int32(seizure_class),
            np.int32(seq_len),
            [],
            [],
            f"{edf_fn}_{seizure_idx}",
        )


# ---------------------------------------------------------------------------
# Loader factories (reference load_dataset_* parity)
# ---------------------------------------------------------------------------


def _make_loaders(dataset_fn, train_batch_size, test_batch_size, num_workers,
                  build_loaders=True):
    # data-parallel ranks: each loader materializes only this rank's rows
    # of every global batch (parallel/distributed.py)
    from eeg_gnn_tpu_torch.parallel.distributed import process_shard

    shard = process_shard()
    dataloaders, datasets = {}, {}
    for split in ["train", "dev", "test"]:
        ds = dataset_fn(split)
        datasets[split] = ds
        if not build_loaders:
            continue
        is_train = split == "train"
        dataloaders[split] = DataLoader(
            ds,
            batch_size=train_batch_size if is_train else test_batch_size,
            shuffle=is_train,
            num_workers=num_workers,
            process_shard=shard,
        )
    return dataloaders, datasets


def _load_scaler(marker_dir: str, prefix: str, max_seq_len: int,
                 suffix: str) -> StandardScaler:
    means = os.path.join(marker_dir, f"means_{prefix}{max_seq_len}s{suffix}.pkl")
    stds = os.path.join(marker_dir, f"stds_{prefix}{max_seq_len}s{suffix}.pkl")
    return StandardScaler.from_pickles(means, stds)


def load_dataset_detection(input_dir, raw_data_dir, train_batch_size,
                           test_batch_size=None, time_step_size=1,
                           max_seq_len=60, standardize=True, num_workers=8,
                           augmentation=False, adj_mat_dir=None,
                           graph_type=None, top_k=None,
                           filter_type="laplacian", use_fft=False,
                           sampling_ratio=1, seed=123, preproc_dir=None,
                           marker_dir=None, raw_mode=False, build_loaders=True,
                           signals=None):
    """Parity: ``load_dataset_detection`` (dataloader_detection.py:419-525).
    ``marker_dir`` points at the file-marker directory (the reference
    hard-codes its repo-relative path). ``raw_mode`` emits raw clips for
    the on-device pipeline."""
    if graph_type is not None and graph_type not in ["individual", "combined"]:
        raise NotImplementedError
    scaler = (
        _load_scaler(marker_dir, "seq2seq_fft_", max_seq_len, "_szdetect_single")
        if standardize else None
    )

    cls = RawDetectionDataset if raw_mode else DetectionDataset

    def make(split):
        return cls(
            marker_dir=marker_dir, sampling_ratio=sampling_ratio, seed=seed,
            input_dir=input_dir, raw_data_dir=raw_data_dir,
            time_step_size=time_step_size, max_seq_len=max_seq_len,
            standardize=standardize, scaler=scaler, split=split,
            data_augment=augmentation if split == "train" else False,
            adj_mat_dir=adj_mat_dir, graph_type=graph_type, top_k=top_k,
            filter_type=filter_type, use_fft=use_fft, preproc_dir=preproc_dir,
            rng_seed=seed, signals=signals,
        )

    loaders, datasets = _make_loaders(make, train_batch_size, test_batch_size,
                                      num_workers, build_loaders)
    return loaders, datasets, scaler


def load_dataset_classification(input_dir, raw_data_dir, train_batch_size,
                                test_batch_size=None, time_step_size=1,
                                max_seq_len=60, standardize=True,
                                num_workers=8, padding_val=0.0,
                                augmentation=False, adj_mat_dir=None,
                                graph_type="combined", top_k=None,
                                filter_type="laplacian", use_fft=False,
                                preproc_dir=None, marker_dir=None,
                                build_loaders=True, signals=None):
    """Parity: ``load_dataset_classification``
    (dataloader_classification.py:372-469); the scaler is
    ``fft_{max_seq_len}s_single``."""
    if graph_type is not None and graph_type not in ["individual", "combined"]:
        raise NotImplementedError
    scaler = (
        _load_scaler(marker_dir, "fft_", max_seq_len, "_single")
        if standardize else None
    )

    def make(split):
        return ClassificationDataset(
            marker_dir=marker_dir, padding_val=padding_val,
            input_dir=input_dir, raw_data_dir=raw_data_dir,
            time_step_size=time_step_size, max_seq_len=max_seq_len,
            standardize=standardize, scaler=scaler, split=split,
            data_augment=augmentation if split == "train" else False,
            adj_mat_dir=adj_mat_dir, graph_type=graph_type, top_k=top_k,
            filter_type=filter_type, use_fft=use_fft, preproc_dir=preproc_dir,
            signals=signals,
        )

    loaders, datasets = _make_loaders(make, train_batch_size, test_batch_size,
                                      num_workers, build_loaders)
    return loaders, datasets, scaler


def load_dataset_ssl(input_dir, raw_data_dir, train_batch_size,
                     test_batch_size, time_step_size=1, input_len=60,
                     output_len=12, standardize=True, num_workers=8,
                     augmentation=False, adj_mat_dir=None, graph_type=None,
                     top_k=None, filter_type="laplacian", use_fft=False,
                     preproc_dir=None, marker_dir=None, raw_mode=False,
                     build_loaders=True, signals=None):
    """Parity: ``load_dataset_ssl`` (dataloader_ssl.py:364-461);
    ``raw_mode`` as in :func:`load_dataset_detection`."""
    if graph_type is not None and graph_type not in ["individual", "combined"]:
        raise NotImplementedError
    scaler = (
        _load_scaler(marker_dir, "seq2seq_fft_", input_len, "_single")
        if standardize else None
    )

    cls = RawSSLDataset if raw_mode else SSLDataset

    def make(split):
        return cls(
            marker_dir=marker_dir, input_len=input_len, output_len=output_len,
            input_dir=input_dir, raw_data_dir=raw_data_dir,
            time_step_size=time_step_size, max_seq_len=input_len,
            standardize=standardize, scaler=scaler, split=split,
            data_augment=augmentation if split == "train" else False,
            adj_mat_dir=adj_mat_dir, graph_type=graph_type, top_k=top_k,
            filter_type=filter_type, use_fft=use_fft, preproc_dir=preproc_dir,
            signals=signals,
        )

    loaders, datasets = _make_loaders(make, train_batch_size, test_batch_size,
                                      num_workers, build_loaders)
    return loaders, datasets, scaler


def load_dataset_densecnn_classification(input_dir, raw_data_dir,
                                         train_batch_size,
                                         test_batch_size=None,
                                         max_seq_len=60, standardize=True,
                                         num_workers=8, padding_val=0.0,
                                         augmentation=False, use_fft=True,
                                         preproc_dir=None, marker_dir=None,
                                         build_loaders=True, signals=None):
    """Parity: ``load_dataset_densecnn_classification``
    (dataloader_densecnn_classification.py:228-307); the scaler is
    classification's, ``fft_{max_seq_len}s_single``. ``padding_val`` is
    the reference's argument, which its FFT branch does not read (it pads
    with zeros)."""
    scaler = (
        _load_scaler(marker_dir, "fft_", max_seq_len, "_single")
        if standardize else None
    )

    def make(split):
        return DenseCNNClassificationDataset(
            marker_dir=marker_dir, input_dir=input_dir,
            raw_data_dir=raw_data_dir, time_step_size=1,
            max_seq_len=max_seq_len, standardize=standardize, scaler=scaler,
            split=split,
            data_augment=augmentation if split == "train" else False,
            adj_mat_dir=None, graph_type=None, top_k=None,
            filter_type="laplacian", use_fft=use_fft,
            preproc_dir=preproc_dir, signals=signals,
        )

    loaders, datasets = _make_loaders(make, train_batch_size, test_batch_size,
                                      num_workers, build_loaders)
    return loaders, datasets, scaler
