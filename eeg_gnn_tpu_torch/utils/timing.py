"""Wall-clock helpers (``eeg_gnn_tpu/utils/timing.py``; reference
utils.py:41-49, 360-371)."""

from __future__ import annotations

import time
from contextlib import contextmanager
from datetime import datetime


@contextmanager
def timer(name: str = "Main", logger=None):
    t0 = time.time()
    yield
    msg = f"[{name}] done in {time.time() - t0} s"
    if logger is not None:
        logger.info(msg)
    else:
        print(msg)


class Timer:
    def __init__(self):
        self.cache = datetime.now()

    def check(self) -> float:
        now = datetime.now()
        duration = now - self.cache
        self.cache = now
        return duration.total_seconds()

    def reset(self):
        self.cache = datetime.now()
