"""File-marker parsing with the reference's balanced-undersampling semantics
(``eeg_gnn_tpu/data/markers.py``).

Marker formats (reference ``data/file_markers_*``):

- detection: ``{split}Set_seq2seq_{len}s_{sz,nosz}.txt`` lines
  ``<h5_clip_name>,<label>``; train is class-balanced by undersampling
  non-seizure to the (scaled) seizure count with a seeded shuffle
  (``data/dataloader_detection.py:88-127``; seed 123 from train.py:71).
- classification: ``{split}Set_seizure_files.txt`` lines
  ``<edf_name>,<class 0..3>,<seizure_idx>``
  (``data/dataloader_classification.py:152-163``).
- SSL: ``{split}Set_seq2seq_{len}s.txt`` lines ``<clip_i>,<clip_{i+1}>``
  pairing consecutive clips (``data/dataloader_ssl.py:141-151``).
"""

from __future__ import annotations

import numpy as np


def parse_detection_markers(split_type: str, seizure_file: str,
                            nonseizure_file: str, cv_seed: int = 123,
                            scale_ratio: float = 1):
    """Parity: reference ``parseTxtFiles`` (dataloader_detection.py:88-127).
    QUIRK kept: it seeds numpy's GLOBAL generator with ``cv_seed`` and
    shuffles from it, so the sampled train subset is the reference's."""
    np.random.seed(cv_seed)

    with open(seizure_file) as f:
        seizure_str = f.readlines()
    with open(nonseizure_file) as f:
        nonseizure_str = f.readlines()

    if split_type == "train":
        num_points = int(scale_ratio * len(seizure_str))
        sz_ndxs_all = list(range(len(seizure_str)))
        np.random.shuffle(sz_ndxs_all)
        sz_ndxs = sz_ndxs_all[:num_points]
        seizure_str = [seizure_str[i] for i in sz_ndxs]
        np.random.shuffle(nonseizure_str)
        nonseizure_str = nonseizure_str[:num_points]

    combined = seizure_str + nonseizure_str
    np.random.shuffle(combined)

    tuples = []
    for line in combined:
        tup = line.strip("\n").split(",")
        tup[1] = int(tup[1])
        tuples.append(tup)
    return tuples


def parse_classification_markers(marker_file: str):
    """(edf_fn, seizure_class, seizure_idx) tuples
    (dataloader_classification.py:152-163)."""
    with open(marker_file) as f:
        lines = f.readlines()
    tuples = []
    for line in lines:
        tup = line.strip("\n").split(",")
        tup[1] = int(tup[1])
        tup[2] = int(tup[2])
        tuples.append(tup)
    return tuples


def parse_ssl_markers(marker_file: str):
    """(clip_x_name, clip_y_name) consecutive-clip pairs
    (dataloader_ssl.py:141-151)."""
    with open(marker_file) as f:
        lines = f.readlines()
    return [line.strip("\n").split(",") for line in lines]
