"""Profiling hooks (``eeg_gnn_tpu/utils/profiling.py``): the program's
spans and set-up totals, and a ``torch.profiler`` trace of a block.

- :func:`span` names a stretch of the program (``eeg.step.forward``,
  ...). While a torch profiler runs it is a ``record_function`` range:
  the Chrome trace holds it as a ``user_annotation`` on the clock of the
  device's kernels, and the runtime calls inside it carry the
  correlation ids of the kernels it launched. While none runs it costs
  one flag check and returns a shared no-op context.
- :func:`timed` is for work done once (building a kernel library, the
  ``TrainStep``) or already timed by the program (a wait on a loader): it
  is a :func:`span` and always adds its host seconds and a count to a
  total per name, read by :func:`totals` and cleared by :func:`reset`
  from any thread.
- :func:`count` adds to a total's count while a torch profiler runs (the
  clips whose graph a step built, ...), from numbers the host holds: no
  sync. While none runs it costs one flag check.
- :func:`trace` is how an operator traces a block: its Chrome trace
  carries the spans beside the host's operators and the device's kernels.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, NamedTuple

import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a torch profiler
    runs; otherwise one shared no-op context."""
    if not _profiler_enabled():
        return _OFF
    return record_function(name)


class Total(NamedTuple):
    seconds: float
    count: int


class Timing:
    """What a :func:`timed` block yields: its host ``seconds`` once it
    has ended."""

    __slots__ = ("seconds",)

    def __init__(self):
        self.seconds = 0.0


_lock = threading.Lock()
_totals: Dict[str, Total] = {}


@contextlib.contextmanager
def timed(name: str):
    """A :func:`span` that also adds its host seconds and one to
    ``totals()[name]``; yields a :class:`Timing`."""
    timing = Timing()
    t0 = time.perf_counter()
    try:
        with span(name):
            yield timing
    finally:
        timing.seconds = time.perf_counter() - t0
        with _lock:
            seconds, count = _totals.get(name, (0.0, 0))
            _totals[name] = Total(seconds + timing.seconds, count + 1)


def count(name: str, n: int):
    """Add ``n`` to ``totals()[name].count`` while a torch profiler runs;
    otherwise one flag check."""
    if not _profiler_enabled():
        return
    with _lock:
        seconds, total = _totals.get(name, (0.0, 0))
        _totals[name] = Total(seconds, total + n)


def totals() -> Dict[str, Total]:
    """A copy of the process's :func:`timed` and :func:`count` totals, by
    name."""
    with _lock:
        return dict(_totals)


def reset():
    """Clear the totals."""
    with _lock:
        _totals.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the enclosed block with ``torch.profiler`` (the host, and the
    card when there is one) and write a Chrome trace to
    ``log_dir/trace.json`` (viewable in Perfetto or chrome://tracing),
    the program's spans in it. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
