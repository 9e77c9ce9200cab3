"""Distance ("combined") graph: fixed 19x19 scalp-geometry adjacency
(``eeg_gnn_tpu/graphs/distance.py``).

The reference pre-computes this once from 3-D electrode coordinates with a
thresholded Gaussian kernel and ships it as a pickle
(``data/electrode_graph/adj_mx_3d.pkl`` = ``[channel_names, name->idx dict,
adj(19,19)]``; built in ``data/electrode_graph/generate_adj_mx.ipynb``).
"""

from __future__ import annotations

import pickle

import numpy as np

from eeg_gnn_tpu_torch.constants import INCLUDED_CHANNELS


def build_distance_adjacency(distance_csv_path: str, sensor_ids=None, dist_k: float = 0.9):
    """Build the distance adjacency from a ``from,to,distance`` CSV.

    Gaussian kernel ``exp(-(d/sigma)^2)`` with sigma = std of all finite
    pairwise distances; entries with distance > ``dist_k`` are zeroed.

    Parity: reference notebook ``generate_adj_mx.ipynb`` cell 4
    (``get_adjacency_matrix``): note the threshold applies to the raw
    *distance*, not the kernel value, and self-loops (d=0) give weight 1.
    """
    import csv

    sensor_ids = INCLUDED_CHANNELS if sensor_ids is None else sensor_ids
    n = len(sensor_ids)
    idx = {s: i for i, s in enumerate(sensor_ids)}
    dist = np.full((n, n), np.inf, dtype=np.float32)
    with open(distance_csv_path) as f:
        reader = csv.reader(f)
        next(reader)  # header
        for frm, to, d in reader:
            if frm in idx and to in idx:
                dist[idx[frm], idx[to]] = float(d)
    std = dist[~np.isinf(dist)].flatten().std()
    adj = np.exp(-np.square(dist / std))
    adj[dist > dist_k] = 0.0
    return adj, idx


def load_distance_adjacency(pkl_path: str) -> np.ndarray:
    """Load the shipped ``adj_mx_3d.pkl`` -> (19, 19) float32 adjacency.

    Parity: reference ``data/dataloader_detection.py:315-317`` (pickle holds
    ``[channel_names, name->idx, adj]``; the adjacency is the last element).
    """
    with open(pkl_path, "rb") as f:
        payload = pickle.load(f)
    return np.asarray(payload[-1], dtype=np.float32)


def swap_adjacency_nodes(adj: np.ndarray, swap_pairs) -> np.ndarray:
    """Permute adjacency rows/cols for the left-right reflection augmentation.

    Parity: reference ``data/dataloader_detection.py:309-333``
    (``_get_combined_graph``): per swapped pair, rows and columns are
    exchanged, the diagonal is re-pinned to 1, and the (a,b)/(b,a) entries
    take the transposed originals. QUIRK, reproduced deliberately: with
    multiple pairs this is NOT a clean symmetric permutation — every pair's
    writes read from the ORIGINAL matrix, so a later pair's column update
    overwrites an earlier pair's row swap at their intersections. We match
    the reference's exact observable output (verified in tests).
    """
    adj = np.asarray(adj)
    out = adj.copy()
    if not swap_pairs:
        return out
    for a, b in swap_pairs:
        for i in range(adj.shape[0]):
            out[a, i] = adj[b, i]
            out[b, i] = adj[a, i]
            out[i, a] = adj[i, b]
            out[i, b] = adj[i, a]
            out[i, i] = 1.0
        out[a, b] = adj[b, a]
        out[b, a] = adj[a, b]
    return out
