"""Device-resident dataset cache (``eeg_gnn_tpu/data/device_cache.py``):
upload the featurized split once, then serve every batch by a gather on
the device inside the train step.

The reference streams every batch from host DataLoader workers each
epoch (dataloader_detection.py:356-416, dataloader_ssl.py:282-361), and
the port's host loaders featurize every clip again each epoch. A
flagship detection split is small against the card's memory (4096 clips
× (60, 19, 100) in bf16 = 0.93 GB), so the split stays on the device and
a step moves no data from the host: the epoch's shuffled permutation goes
up once an epoch (``epoch_plan``) and each step gathers its rows with one
``index_select``.

Per-step data math runs on the device through ``DevicePipeline.features``
/ ``ssl_features``, with the host loader's semantics (augment THEN
standardize, the reflection's support choice). The shuffle stays on the
host: a seeded permutation per epoch, the JAX package's plan for the
same ``RandomState``.

Batches run at their natural size: the JAX plan pads a short last batch
by repeating its first index and masks the loss by the valid count; the
port gathers only the valid rows, which gives the same loss.

Detection (features + float labels) and SSL (x features + next-window
target features in the label slot) cache here. Classification
(``build_classification_cache``) waits for ROADMAP.md Queue 1 item 5;
the row-sharded mesh caches (``mesh_epoch_plan``, ``mesh_plan``,
``shard_cache``, ``_process_rows``) for item 10.

:func:`fits_in_hbm` sizes a split against the user's budget; past it the
CLI switches to the rotating cache (``data/rotating_cache.py``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from eeg_gnn_tpu_torch.device import resolve_device
from eeg_gnn_tpu_torch.train.step import cached_batch

# rows per host-to-device copy while a cache is built: bounds the float32
# staging on the device to ~233 MB at the flagship clip size
_UPLOAD_ROWS = 512


def storage_dtype_of(name: str) -> torch.dtype:
    """'bfloat16' -> torch.bfloat16; anything else float32."""
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _mesh_not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1, item 10: "
        "scale-out)")


def upload(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """Host array -> ``dtype`` tensor on ``device``, in row blocks (the cast
    runs on the device)."""
    out = torch.empty(a.shape, dtype=dtype, device=device)
    for lo in range(0, a.shape[0], _UPLOAD_ROWS):
        out[lo:lo + _UPLOAD_ROWS] = torch.from_numpy(
            np.ascontiguousarray(a[lo:lo + _UPLOAD_ROWS])).to(device)
    return out


class Plan(NamedTuple):
    """One plan over rows held on the device (a resident split, or one
    rotating shard): the steps gather ``x`` / ``y`` rows ``perm[k*B :
    k*B + valid[k]]`` for batch k. ``labels`` (detection, else None) and
    ``names`` are the host's, indexed like ``x``."""
    x: torch.Tensor
    y: torch.Tensor
    perm: np.ndarray     # (K*B,) int32 row indices into x, y
    valid: np.ndarray    # (K,) int32 real rows of each batch
    labels: Optional[np.ndarray]
    names: List[str]


class DeviceDatasetCache:
    """Featurized clips and labels resident on one device.

    Args:
        feats: (num_clips, T, N, D) UN-augmented, UN-standardized features
            (augment and standardize run on the device per step).
        labels: (num_clips,) float labels (detection) or (num_clips,
            T_out, N, D) target features (SSL, in the storage dtype).
        seq_len: the clips' constant ``seq_lengths`` value.
        storage_dtype: 'bfloat16' halves the device memory and the upload;
            'float32' for exact host-path parity.
        seq_lengths: per-clip lengths (classification): not ported yet.
        device: ``None`` (the CUDA card, raising without one), or e.g.
            ``"cpu"``.
    """

    def __init__(self, feats: np.ndarray, labels: np.ndarray, seq_len: int,
                 storage_dtype: str = "float32", names=None,
                 seq_lengths: Optional[np.ndarray] = None, mesh=None,
                 global_num_clips: Optional[int] = None, device=None):
        if mesh is not None or global_num_clips is not None:
            _mesh_not_ported("the row-sharded dataset cache")
        if seq_lengths is not None:
            raise NotImplementedError(
                "per-clip lengths (the classification cache) are not "
                "ported yet (ROADMAP.md, Queue 1, item 5: classification)")
        self.device = resolve_device(device, "DeviceDatasetCache")
        dt = storage_dtype_of(storage_dtype)
        feats = np.asarray(feats)
        labels = np.asarray(labels, np.float32)
        self.num_clips = int(feats.shape[0])
        self.x = upload(feats, dt, self.device)
        # SSL target features share the label slot and the storage dtype
        self.y = upload(labels, dt if labels.ndim > 1 else torch.float32,
                        self.device)
        self.seq_len = int(seq_len)
        self.names = (list(names) if names is not None
                      else [str(i) for i in range(self.num_clips)])
        self._labels_host = labels if labels.ndim == 1 else None

    def __len__(self):
        return self.num_clips

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.x, self.y))

    def epoch_index_batches(self, batch_size: int, shuffle: bool,
                            rng: np.random.RandomState,
                            drop_last: bool = False):
        """Host-side index plan for one epoch: yields (idx (B,), valid).

        The final partial batch is padded by repeating its first index —
        the JAX package's plan, so the same ``rng`` gives the same draws;
        consumers gather only ``idx[:valid]``.
        """
        order = np.arange(self.num_clips)
        if shuffle:
            rng.shuffle(order)
        for lo in range(0, self.num_clips, batch_size):
            idx = order[lo:lo + batch_size]
            valid = len(idx)
            if valid < batch_size:
                if drop_last:
                    return
                idx = np.concatenate(
                    [idx, np.repeat(idx[:1], batch_size - valid)])
            yield idx.astype(np.int32), valid

    def epoch_plan(self, batch_size: int, shuffle: bool,
                   rng: np.random.RandomState, drop_last: bool = False):
        """Flat epoch plan for the cached step
        (``train/step.py:make_cached_train_step``): (perm (K*batch_size,)
        int32, valid (K,) int32); the trainer uploads perm once an
        epoch."""
        plan = list(self.epoch_index_batches(batch_size, shuffle, rng,
                                             drop_last))
        perm = np.concatenate([p[0] for p in plan])
        valid = np.asarray([p[1] for p in plan], np.int32)
        return perm, valid

    def epoch_plans(self, batch_size: int, shuffle: bool,
                    rng: np.random.RandomState):
        """An epoch as :class:`Plan` s (here one: the whole split), the
        iteration that ``RotatingDeviceCache.epoch_plans`` shares."""
        perm, valid = self.epoch_plan(batch_size, shuffle, rng)
        yield Plan(self.x, self.y, perm, valid, self._labels_host,
                   self.names)

    def mesh_epoch_plan(self, *args, **kwargs):
        """Per-device plans of a row-sharded cache (JAX ``:193``)."""
        _mesh_not_ported("the mesh epoch plan")

    def device_batch(self, idx: np.ndarray, valid: int):
        """The step's batch of plan rows ``idx[:valid]``: the index vector
        goes to the device; the rows are gathered in the step."""
        rows = torch.from_numpy(np.ascontiguousarray(idx[:valid],
                                                     np.int64))
        return cached_batch(self.x, self.y, rows.to(self.device),
                            self.seq_len)


def mesh_plan(*args, **kwargs):
    """Per-device plan core of the row-sharded caches (JAX ``:236``)."""
    _mesh_not_ported("the mesh plan")


def fits_in_hbm(num_clips: int, t: int, n: int, d: int,
                storage_dtype: str = "bfloat16",
                budget_bytes: int = 12 * 2 ** 30, t_out: int = 0,
                num_devices: int = 1) -> bool:
    """Whether a split's features fit ``budget_bytes`` of device memory
    (the user's budget: ``--hbm_budget_gb``). ``t_out`` adds the SSL
    target windows; ``num_devices`` scales the budget for row-sharded
    caches (each device holds 1/p of the split)."""
    itemsize = 2 if storage_dtype == "bfloat16" else 4
    need = num_clips * (t + t_out) * n * d * itemsize
    return need <= budget_bytes * num_devices


def _materialize(dataset, pick, num_workers: int = 0, rows=None):
    """Featurize clips of ``dataset`` via ``pick(item) -> tuple``, with a
    thread pool when ``num_workers > 1`` (h5py and numpy release the GIL
    for most of the work). ``rows`` restricts it to an index list."""
    idx = range(len(dataset)) if rows is None else rows
    if num_workers and num_workers > 1 and len(idx) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            return list(pool.map(lambda i: pick(dataset[i]), idx))
    return [pick(dataset[i]) for i in idx]


def _process_rows(*args, **kwargs):
    """The rows this process featurizes for a row-sharded cache (JAX
    ``:290``)."""
    _mesh_not_ported("multi-process row shards")


def detection_rows(dataset, num_workers: int = 0):
    """(feats (n, T, N, D), labels (n,), names) of a plain detection
    dataset (built with ``augmentation=False``, ``standardize=False``)."""
    rows = _materialize(
        dataset,
        lambda item: (np.asarray(item[0], np.float32),
                      np.float32(item[1]), item[5]),
        num_workers)
    xs, ys, names = zip(*rows)
    return np.stack(xs), np.asarray(ys), names


def ssl_rows(dataset, num_workers: int = 0):
    """(x feats, next-window y feats, names) of a plain SSL dataset."""
    rows = _materialize(
        dataset,
        lambda item: (np.asarray(item[0], np.float32),
                      np.asarray(item[1], np.float32), item[5]),
        num_workers)
    xs, ys, names = zip(*rows)
    return np.stack(xs), np.stack(ys), names


def build_detection_cache(dataset, seq_len: int,
                          storage_dtype: str = "float32",
                          scaler=None, num_workers: int = 0, mesh=None,
                          device=None) -> DeviceDatasetCache:
    """A cache of a detection dataset's reference-layout tuples.

    The dataset must be built with ``augmentation=False`` and
    ``standardize=False`` (both run on the device per step); the caller
    owns that (``cli/train.py`` does).
    """
    if mesh is not None:
        _mesh_not_ported("the row-sharded dataset cache")
    feats, labels, names = detection_rows(dataset, num_workers)
    return DeviceDatasetCache(feats, labels, seq_len,
                              storage_dtype=storage_dtype, names=names,
                              device=device)


def build_ssl_cache(dataset, input_len: int,
                    storage_dtype: str = "float32",
                    num_workers: int = 0, mesh=None,
                    device=None) -> DeviceDatasetCache:
    """SSL pair cache: x features in ``x``, next-window target features in
    the ``y`` slot. The dataset must be built with ``augmentation=False``,
    ``standardize=False`` (the joint augment and z-score run on the
    device, ``DevicePipeline.ssl_features``)."""
    if mesh is not None:
        _mesh_not_ported("the row-sharded dataset cache")
    xs, ys, names = ssl_rows(dataset, num_workers)
    return DeviceDatasetCache(xs, ys, input_len,
                              storage_dtype=storage_dtype, names=names,
                              device=device)


def build_classification_cache(*args, **kwargs):
    """Classification cache: padded features, int labels, true lengths
    (JAX ``:358``)."""
    raise NotImplementedError(
        "the classification cache is not ported yet (ROADMAP.md, Queue 1, "
        "item 5: classification)")


def shard_cache(*args, **kwargs):
    """Re-place a cache row-sharded over a mesh (JAX ``:383``)."""
    _mesh_not_ported("the row-sharded dataset cache")
