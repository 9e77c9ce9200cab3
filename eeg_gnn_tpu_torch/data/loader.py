"""Batching data loader with background prefetch
(``eeg_gnn_tpu/data/loader.py``).

Replaces the reference's ``torch.utils.data.DataLoader(num_workers=8)``
(dataloader_detection.py:518-522) with a thread-based prefetcher, as the
JAX package does: the per-sample work (h5 read + numpy featurization and
graph math) releases the GIL in h5py/numpy, so threads overlap it without
pickling. The epoch shuffle is a seeded ``RandomState``, so two loaders
with one seed give the same batch order; batches come out in order
whatever the number of workers.

Data-parallel ranks (``process_shard=(rank, count)``): ``batch_size`` stays
the GLOBAL batch, the seeded shuffle is the same on every rank, and each
rank materializes only its contiguous rows of every global batch; a
partial global batch is padded at its end by repeating its first sample,
and ``Batch.valid`` carries the global valid count.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class Batch:
    x: np.ndarray              # (B, T, N, D)
    y: np.ndarray              # (B,) or (B, T_out, N, D)
    seq_lengths: np.ndarray    # (B,)
    supports: Optional[np.ndarray]  # (S, B, N, N) stacked, or None
    adj: Optional[np.ndarray]  # (B, N, N) or None
    names: List[str]
    valid: Optional[int] = None  # GLOBAL valid rows (a rank's loader: it
    # holds its slice; the padding rows sit at the global end)

    def __len__(self):
        return self.x.shape[0]


def collate(samples) -> Batch:
    """Stack reference-layout sample tuples (x, y, seq_len, supports, adj,
    name) into a Batch; per-sample support lists stack to (S, B, N, N) like
    the torch default collate's list-of-stacked-tensors."""
    xs, ys, lens, sups, adjs, names = zip(*samples)
    x = np.stack(xs).astype(np.float32)
    y = np.stack(ys)
    seq_lengths = np.asarray(lens, dtype=np.int32)
    if len(sups[0]):
        num_s = len(sups[0])
        supports = np.stack(
            [np.stack([s[i] for s in sups]) for i in range(num_s)]
        ).astype(np.float32)
    else:
        supports = None
    adj = (
        np.stack([np.asarray(a, dtype=np.float32) for a in adjs])
        if not isinstance(adjs[0], list) else None
    )
    return Batch(x, y, seq_lengths, supports, adj, list(names))


class DataLoader:
    """Iterable over (optionally shuffled) batches with a bounded prefetch
    queue filled by up to 4 worker threads."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 2, drop_last: bool = False, seed: int = 0,
                 prefetch: int = 4, process_shard=None):
        """``process_shard=(rank, count)``: this rank's rows of every
        global batch of ``batch_size`` (the module docstring; the layout of
        ``parallel.distributed.process_batch_slice``)."""
        if process_shard is not None and batch_size % process_shard[1]:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{process_shard[1]} ranks")
        self.process_shard = process_shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, min(num_workers, 4))
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._epoch_rng = np.random.RandomState(seed)

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batch_indices(self):
        """(index array, global valid count or None) per batch of this
        epoch: this rank's rows under ``process_shard``."""
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._epoch_rng.shuffle(idx)
        batches = [
            idx[i:i + self.batch_size]
            for i in range(0, len(idx), self.batch_size)
        ]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()
        if self.process_shard is None:
            return [(b, None) for b in batches]
        rank, count = self.process_shard
        per = self.batch_size // count
        out = []
        for b in batches:
            valid = len(b)
            if valid != self.batch_size:  # pad the global tail: sample 0
                b = np.concatenate(
                    [b, np.repeat(b[:1], self.batch_size - valid)])
            out.append((b[rank * per:(rank + 1) * per], valid))
        return out

    def _collate(self, b, valid):
        batch = collate([self.dataset[int(i)] for i in b])
        batch.valid = valid
        return batch

    def __iter__(self):
        batches = self._batch_indices()
        if self.num_workers <= 1 or len(batches) <= 1:
            for b, valid in batches:
                yield self._collate(b, valid)
            return

        task_q: "queue.Queue" = queue.Queue()
        for pos, b in enumerate(batches):
            task_q.put((pos, b))
        results: dict = {}
        slots = threading.Semaphore(self.prefetch)  # bound work-ahead
        ready_cv = threading.Condition(threading.Lock())

        def worker():
            while True:
                slots.acquire()
                try:
                    pos, (b, valid) = task_q.get_nowait()
                except queue.Empty:
                    slots.release()
                    return
                try:
                    batch = self._collate(b, valid)
                except Exception as e:  # surface in the consuming thread
                    batch = e
                with ready_cv:
                    results[pos] = batch
                    ready_cv.notify_all()

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.num_workers)
        ]
        for t in threads:
            t.start()

        for next_pos in range(len(batches)):
            with ready_cv:
                while next_pos not in results:
                    ready_cv.wait(timeout=1.0)
                batch = results.pop(next_pos)
            slots.release()
            if isinstance(batch, Exception):
                raise batch
            yield batch
