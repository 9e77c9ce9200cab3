"""Z-score standardization wrt train-set statistics.

Parity: reference ``utils.StandardScaler`` (utils.py:393-428), as
``eeg_gnn_tpu/data/scaler.py``. The shipped statistics pickles are scalar
float64 means/stds, loaded per task/clip-length by each ``load_dataset_*``.
"""

from __future__ import annotations

import pickle

import numpy as np


class StandardScaler:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean)
        self.std = np.asarray(std)

    def transform(self, data):
        return (data - self.mean) / self.std

    @classmethod
    def from_pickles(cls, means_path: str, stds_path: str) -> "StandardScaler":
        """Read the statistics pickles (written by this package's or the
        reference's tooling: unpickling runs code, so only trusted files)."""
        with open(means_path, "rb") as f:
            means = pickle.load(f)
        with open(stds_path, "rb") as f:
            stds = pickle.load(f)
        return cls(mean=means, std=stds)
