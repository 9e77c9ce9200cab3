"""Rotating dataset cache for splits beyond the device budget
(``eeg_gnn_tpu/data/rotating_cache.py``), on one device.

The featurized split lives on the HOST, in the storage dtype, in pinned
memory, cut into equal shards; the device holds at most two of them: the
one being trained on and the next one, whose copy runs on a side stream
while the current shard's steps run on the compute stream:

    epoch = permutation over shards x in-shard permutations

Each shard's steps are the cached step of ``data/device_cache.py``, so
the steady state costs max(steps, copy) per shard, not their sum. The
copy overlaps only because its source is pinned: a ``non_blocking`` copy
from pageable memory is synchronous.

DIVERGENCE (the JAX package's): shard-local shuffling, not the
reference's global shuffle (dataloader_detection.py:356-416): every clip
is visited exactly once an epoch; shard order and in-shard order both
reshuffle each epoch, drawn from the same ``RandomState`` calls as JAX's,
so the plans are equal.

Shard geometry: JAX's ``rotating_geometry`` can leave an empty trailing
shard when ``min_shards`` binds and the rows round up (its ADVICE.md
flags ``rotating_cache.py:48``). The port clamps the shard count after
rounding, so every shard has real rows.

Classification's per-clip lengths ride in the slabs beside ``x`` and
``y``. The mesh (row-sharded slabs) and multi-host stripe modes wait for
ROADMAP.md Queue 1 item 10.
"""

from __future__ import annotations

import weakref
from typing import Optional

import numpy as np
import torch

from eeg_gnn_tpu_torch.data.device_cache import (
    Plan,
    _mesh_not_ported,
    classification_rows,
    detection_rows,
    ssl_rows,
    storage_dtype_of,
)
from eeg_gnn_tpu_torch.device import resolve_device


def rotating_geometry(num_clips: int, clip_bytes: int, budget_bytes: int,
                      p: int = 1, min_shards: int = 2):
    """(num_shards, shard_rows): shards sized so THREE fit the budget
    (the live slab, the prefetch and the previous one while the device
    still reads it), rows rounded to a multiple of ``p``, then the shard
    count clamped so that every shard holds real rows (``min_shards``
    holds only where it leaves none empty)."""
    max_rows = max(1, budget_bytes // (3 * clip_bytes)) * p
    num_shards = max(min_shards, -(-num_clips // max_rows))
    base_rows = -(-num_clips // num_shards)
    shard_rows = -(-base_rows // p) * p
    return min(num_shards, max(1, -(-num_clips // shard_rows))), shard_rows


class Slab:
    """One shard resident on the device: ``x``, ``y``, the clips' lengths
    ``seq`` (classification, else None), and the event its copy recorded
    on the side stream."""

    def __init__(self, shard: int, x, y, seq=None, event=None):
        self.shard = shard
        self.x, self.y, self.seq = x, y, seq
        self._event = event

    def ready(self) -> "Slab":
        """Make the current stream wait for the copy, and tell the
        allocator the current stream reads the slab (its memory is not
        handed out again until that work is done). Returns self."""
        if self._event is not None:
            stream = torch.cuda.current_stream(self.x.device)
            stream.wait_event(self._event)
            for t in (self.x, self.y, self.seq):
                if t is not None:
                    t.record_stream(stream)
            self._event = None
        return self


class RotatingDeviceCache:
    """Host-resident featurized split served as rotating shards through
    one device, the next shard's copy overlapping the current one's steps.

    Args:
        feats: (num_clips, T, N, D) un-augmented, un-standardized features.
        labels: (num_clips,) labels or (num_clips, T_out, N, D) SSL target
            features.
        seq_len: the clips' constant ``seq_lengths`` value, or their
            padded length with ``seq_lengths``.
        storage_dtype: host and device storage dtype ('bfloat16' halves
            both the footprint and each rotation's copy).
        seq_lengths: (num_clips,) true lengths of padded clips
            (classification), copied with each shard.
        budget_bytes: device memory for the slabs: shards are sized so
            THREE fit (see :func:`rotating_geometry`).
        min_shards: lower bound on the shard count (to rotate a split that
            would fit).
        device: ``None`` (the CUDA card, raising without one), or e.g.
            ``"cpu"``.
    """

    def __init__(self, feats: np.ndarray, labels: np.ndarray, seq_len: int,
                 storage_dtype: str = "float32",
                 budget_bytes: int = 12 * 2 ** 30, names=None,
                 seq_lengths: Optional[np.ndarray] = None,
                 min_shards: int = 2, mesh=None,
                 global_num_clips: Optional[int] = None, device=None):
        if mesh is not None or global_num_clips is not None:
            _mesh_not_ported("the row-sharded rotating cache")
        self.device = resolve_device(device, "RotatingDeviceCache")
        self.storage_dtype = storage_dtype
        dt = storage_dtype_of(storage_dtype)
        labels = np.asarray(labels, np.float32)
        pin = self.device.type == "cuda"

        def host(a, dtype):
            t = torch.from_numpy(np.ascontiguousarray(a)).to(dtype)
            return t.pin_memory() if pin else t

        self._x = host(np.asarray(feats, np.float32), dt)
        self._y = host(labels, dt if labels.ndim > 1 else torch.float32)
        self._seq = (None if seq_lengths is None
                     else host(np.asarray(seq_lengths, np.int64),
                               torch.int64))
        self.num_clips = int(self._x.shape[0])
        self.seq_len = int(seq_len)
        self.names = (list(names) if names is not None
                      else [str(i) for i in range(self.num_clips)])
        self._labels_host = labels if labels.ndim == 1 else None
        # the JAX package's count: features, and SSL targets (not labels)
        self.clip_bytes = sum(
            int(np.prod(t.shape[1:])) * t.element_size()
            for t in ((self._x, self._y) if labels.ndim > 1 else (self._x,)))
        self.num_shards, self.shard_rows = rotating_geometry(
            self.num_clips, self.clip_bytes, budget_bytes, 1, min_shards)
        self._stream = (torch.cuda.Stream(self.device) if pin else None)
        self._live = weakref.WeakSet()  # the slabs not yet freed

    # -- host-side plan ----------------------------------------------------

    def shard_real_rows(self, shard: int) -> int:
        lo = shard * self.shard_rows
        return max(0, min(self.shard_rows, self.num_clips - lo))

    def epoch_shard_order(self, rng: np.random.RandomState,
                          shuffle: bool = True) -> np.ndarray:
        order = np.arange(self.num_shards)
        if shuffle:
            rng.shuffle(order)
        return order

    def shard_plan(self, shard: int, batch_size: int, shuffle: bool,
                   rng: np.random.RandomState):
        """(perm (K*B,) int32 LOCAL rows, valid (K,) int32) for one shard —
        the contract of ``DeviceDatasetCache.epoch_plan``."""
        real = self.shard_real_rows(shard)
        order = np.arange(real, dtype=np.int32)
        if shuffle:
            rng.shuffle(order)
        k = -(-real // batch_size)
        perm = np.full((k * batch_size,), order[0] if real else 0, np.int32)
        perm[:real] = order
        valid = np.full((k,), batch_size, np.int32)
        if real % batch_size:
            valid[-1] = real % batch_size
        return perm, valid

    def epoch_plans(self, batch_size: int, shuffle: bool,
                    rng: np.random.RandomState):
        """An epoch as one :class:`Plan` per shard (the shard order, then
        each shard's rows, drawn from ``rng`` as the JAX trainer draws
        them). The next shard's copy starts before a shard's plan is
        yielded, so it overlaps that shard's steps; a slab is dropped once
        the next one is ready, and the last when the epoch ends."""
        order = self.epoch_shard_order(rng, shuffle)
        slab_next = self.prefetch(order[0])
        for i, sid in enumerate(order):
            slab = slab_next.ready()
            slab_next = (self.prefetch(order[i + 1])
                         if i + 1 < len(order) else None)
            perm, valid = self.shard_plan(sid, batch_size, shuffle, rng)
            yield Plan(slab.x, slab.y, perm, valid, self.shard_labels(sid),
                       self.shard_names(sid), slab.seq)

    def mesh_shard_plan(self, *args, **kwargs):
        """Per-device plans of a row-sharded slab (JAX ``:252``)."""
        _mesh_not_ported("the mesh shard plan")

    # -- device-side slabs -------------------------------------------------

    def prefetch(self, shard: int) -> Slab:
        """Start the copy of one shard to the device and return its
        :class:`Slab`; call ``ready()`` on it before its first use. On the
        card the slab is allocated and filled on a side stream, so the
        copy overlaps whatever the compute stream runs meanwhile; the
        allocator reuses a freed slab's memory only after the compute
        work that read it (``Slab.ready`` records that stream). A shard's
        last rows past its real ones stay unset: the plans never read
        them."""
        lo = shard * self.shard_rows
        hi = lo + self.shard_real_rows(shard)
        host = [self._x, self._y] + ([self._seq] if self._seq is not None
                                     else [])
        if self._stream is None:
            slab = Slab(shard, *(t[lo:hi].clone() for t in host))
        else:
            with torch.cuda.stream(self._stream):
                dev = []
                for t in host:
                    d = torch.empty((self.shard_rows,) + t.shape[1:],
                                    dtype=t.dtype, device=self.device)
                    d[: hi - lo].copy_(t[lo:hi], non_blocking=True)
                    dev.append(d)
                event = torch.cuda.Event()
                event.record(self._stream)
            slab = Slab(shard, *dev, event=event)
        self._live.add(slab)
        return slab

    def resident(self) -> int:
        """Slabs of this cache not yet freed by their holders."""
        return len(self._live)

    def shard_labels(self, shard: int):
        lo = shard * self.shard_rows
        hi = min(lo + self.shard_rows, self.num_clips)
        return (None if self._labels_host is None
                else self._labels_host[lo:hi])

    def shard_names(self, shard: int):
        lo = shard * self.shard_rows
        hi = min(lo + self.shard_rows, self.num_clips)
        return self.names[lo:hi]

    def nbytes_resident(self) -> int:
        """Worst-case device bytes: three slabs (live, prefetch, and the
        previous one while the device still reads it)."""
        return 3 * self.shard_rows * self.clip_bytes


def build_rotating_cache(dataset, seq_len: int, kind: str,
                         storage_dtype: str = "float32",
                         budget_bytes: int = 12 * 2 ** 30,
                         num_workers: int = 0,
                         min_shards: int = 2,
                         mesh=None, device=None) -> RotatingDeviceCache:
    """A rotating cache of a plain (un-augmented, un-standardized)
    dataset. ``kind``: 'detection' | 'ssl' | 'classification' (the item
    layouts of the ``device_cache`` builders)."""
    if mesh is not None:
        _mesh_not_ported("the row-sharded rotating cache")
    common = dict(storage_dtype=storage_dtype, budget_bytes=budget_bytes,
                  min_shards=min_shards, device=device)
    if kind == "detection":
        feats, labels, names = detection_rows(dataset, num_workers)
        return RotatingDeviceCache(feats, labels, seq_len, names=names,
                                   **common)
    if kind == "ssl":
        xs, ys, names = ssl_rows(dataset, num_workers)
        return RotatingDeviceCache(xs, ys, seq_len, names=names, **common)
    if kind == "classification":
        feats, labels, lens, names = classification_rows(dataset,
                                                         num_workers)
        return RotatingDeviceCache(feats, labels, seq_len, names=names,
                                   seq_lengths=lens, **common)
    raise ValueError(f"unknown rotating-cache kind: {kind!r}")
