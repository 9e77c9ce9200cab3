"""Logging + metrics observability (``eeg_gnn_tpu/utils/logging.py``).

Parity: reference ``utils.get_logger`` (utils.py:258-275: file + stdout
handlers) and its scalar stream (train.py:284-287,324-326), as the JAX
package's JSONL sink: ``metrics.jsonl`` holds one ``{tag, value, step,
ts}`` line per scalar. The JAX package's optional tensorboardX writer is
not carried.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time


def get_logger(log_dir: str, name: str, log_filename: str = "info.log",
               level=logging.INFO):
    logger = logging.getLogger(name)
    logger.setLevel(level)
    for h in list(logger.handlers):
        h.close()
    logger.handlers.clear()
    formatter = logging.Formatter(
        "%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    file_handler = logging.FileHandler(os.path.join(log_dir, log_filename))
    file_handler.setFormatter(formatter)
    console = logging.StreamHandler(sys.stdout)
    console.setFormatter(
        logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
    logger.addHandler(file_handler)
    logger.addHandler(console)
    logger.info("Log directory: %s", log_dir)
    return logger


class MetricsWriter:
    """Scalar metrics sink: ``metrics.jsonl`` in ``log_dir``."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        self._jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step),
                        "ts": time.time()}) + "\n")
        self._jsonl.flush()

    def close(self):
        self._jsonl.close()
