"""EEG scalp-graph visualization (``eeg_gnn_tpu/viz/graph_viz.py``).

Parity: reference ``graph_viz/graph_viz_utils.py:12-114`` — spectral layout
of the electrode graph via networkx and weighted-edge rendering with
matplotlib. Kept dependency-gated (viz is not on any training path).
"""

from __future__ import annotations

from eeg_gnn_tpu_torch.constants import INCLUDED_CHANNELS


def get_spectral_graph_positions(adj_pkl_path: str):
    """Node positions from a spectral layout of the shipped distance graph.

    Parity: reference ``get_spectral_graph_positions`` (graph_viz_utils.py:12-44):
    self-edges are excluded from the layout graph and the spectral positions
    are rotated ``(x, y) -> (y, -x)`` to keep the scalp orientation
    (graph_viz_utils.py:41).
    """
    import networkx as nx
    import pickle

    with open(adj_pkl_path, "rb") as f:
        adj_mx_all = pickle.load(f)
    adj_mx = adj_mx_all[-1]

    eeg_viz = nx.Graph()
    adj_mx = adj_mx[:len(INCLUDED_CHANNELS), :len(INCLUDED_CHANNELS)]
    for i in range(adj_mx.shape[0]):
        eeg_viz.add_node(i)
    for i in range(adj_mx.shape[0]):
        for j in range(adj_mx.shape[1]):
            if i != j and adj_mx[i, j] > 0:
                eeg_viz.add_edge(i, j)
    pos = nx.spectral_layout(eeg_viz)
    return {node: (y, -x) for node, (x, y) in pos.items()}


def draw_graph_weighted_edge(adj_mx, pos_spec, title="", save_path=None,
                             node_color="lightblue", font_size=10,
                             node_size=600, fig_size=(12, 8),
                             edge_vmin=None, edge_vmax=None, plot_colorbar=True):
    """Render a weighted electrode graph.

    Parity: reference ``draw_graph_weighted_edge`` (graph_viz_utils.py:47-114)
    — directed edges colored by weight on the spectral positions, electrode
    names as labels.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import networkx as nx
    import numpy as np

    adj_mx = np.asarray(adj_mx)
    g = nx.DiGraph()
    labels = {i: ch.split(" ")[-1] for i, ch in enumerate(INCLUDED_CHANNELS)}
    for i in range(adj_mx.shape[0]):
        g.add_node(i)
    for i in range(adj_mx.shape[0]):
        for j in range(adj_mx.shape[1]):
            if adj_mx[i, j] > 0 and i != j:
                g.add_edge(i, j, weight=float(adj_mx[i, j]))

    weights = [g[u][v]["weight"] for u, v in g.edges()]
    fig, ax = plt.subplots(figsize=fig_size)
    nx.draw_networkx_nodes(g, pos_spec, node_color=node_color,
                           node_size=node_size, ax=ax)
    nx.draw_networkx_labels(g, pos_spec, labels, font_size=font_size, ax=ax)
    edges = nx.draw_networkx_edges(
        g, pos_spec, edge_color=weights, edge_cmap=plt.cm.Greys,
        edge_vmin=edge_vmin, edge_vmax=edge_vmax, width=2,
        connectionstyle="arc3,rad=0.1", ax=ax)
    if plot_colorbar and weights:
        sm = plt.cm.ScalarMappable(
            cmap=plt.cm.Greys,
            norm=plt.Normalize(vmin=edge_vmin or min(weights),
                               vmax=edge_vmax or max(weights)))
        fig.colorbar(sm, ax=ax)
    ax.set_title(title)
    ax.axis("off")
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    return fig
