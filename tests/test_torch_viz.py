"""The port's electrode-graph drawing (``eeg_gnn_tpu_torch/viz``) against
the JAX package's on the CPU, on a seeded 19-node distance-graph pickle in
the reference's ``[channels, name->idx, adj]`` layout: the spectral
positions (self-edges excluded, rotated (x, y) -> (y, -x)) at rtol 1e-9,
and a rendered PNG."""

import pickle

import numpy as np
import pytest

from eeg_gnn_tpu.viz import graph_viz as jviz
from eeg_gnn_tpu_torch.constants import INCLUDED_CHANNELS
from eeg_gnn_tpu_torch.viz import graph_viz as tviz


@pytest.fixture()
def adj_pkl(rng, tmp_path):
    xyz = rng.randn(19, 3)
    d = np.linalg.norm(xyz[:, None] - xyz[None], axis=-1)
    adj = np.exp(-np.square(d / d.std())).astype(np.float32)
    adj[d > np.median(d)] = 0.0
    np.fill_diagonal(adj, 1.0)
    path = str(tmp_path / "adj_mx_3d.pkl")
    with open(path, "wb") as f:
        pickle.dump([list(INCLUDED_CHANNELS),
                     {c: i for i, c in enumerate(INCLUDED_CHANNELS)}, adj], f)
    return path, adj


def test_spectral_positions_match_jax(adj_pkl):
    import networkx as nx

    path, adj = adj_pkl
    got, want = (m.get_spectral_graph_positions(path) for m in (tviz, jviz))
    assert sorted(got) == sorted(want) == list(range(19))
    for node in want:
        np.testing.assert_allclose(got[node], want[node], rtol=1e-9,
                                   atol=0)
    g = nx.Graph()
    g.add_nodes_from(range(19))
    g.add_edges_from((i, j) for i in range(19) for j in range(19)
                     if i != j and adj[i, j] > 0)
    for node, (x, y) in nx.spectral_layout(g).items():
        np.testing.assert_allclose(got[node], (y, -x), rtol=1e-9, atol=0)


def test_draw_writes_a_png(adj_pkl, tmp_path):
    import matplotlib.pyplot as plt

    path, adj = adj_pkl
    pos = tviz.get_spectral_graph_positions(path)
    out = tmp_path / "graph.png"
    fig = tviz.draw_graph_weighted_edge(adj, pos, title="distance graph",
                                        save_path=str(out))
    try:
        assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
        assert out.stat().st_size > 10000
        ax = fig.axes[0]
        assert ax.get_title() == "distance graph"
        assert len(fig.axes) == 2  # the weight colorbar
    finally:
        plt.close(fig)
