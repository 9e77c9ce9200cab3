"""Profiling hooks (``eeg_gnn_tpu/utils/profiling.py``): a
``torch.profiler`` trace of a block, and a step timer that waits for the
device.

CUDA launches return before the card finishes, so a host clock around a
step measures its enqueue unless something waits: :class:`StepTimer`
waits through the value it is given (its ``float()`` copies it to the
host) and, for a value on the card, ``torch.cuda.synchronize``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block with ``torch.profiler`` (the host, and the
    card when there is one) and write a Chrome trace to
    ``log_dir/trace.json`` (viewable in Perfetto or chrome://tracing).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling step timing with a real device sync per measurement: pass
    ``stop`` a value the step produced (e.g. its loss)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None) -> float:
        if sync_value is not None:
            if isinstance(sync_value, torch.Tensor) and sync_value.is_cuda:
                torch.cuda.synchronize(sync_value.device)
            float(sync_value)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)
