"""Everything a run feeds the program, made from ``--seed``: the weights,
the electrode graph and the training splits.

Weights and data are made on the device by a ``torch.Generator`` there, in
a few large calls, in float32 (the configurations' dtype). Each purpose
draws from its own stream, derived from the seed and a tag, so a change
in one leaves the others as they were.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run seed ``seed``."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             *tag.encode()]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def host_rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))


# --------------------------------------------------------------------------
# the electrode graph
# --------------------------------------------------------------------------


def distance_adjacency(cfg: dict) -> np.ndarray:
    """(N, N) float32 distance graph: N electrodes at seeded points on a
    sphere, a Gaussian kernel of their distances (sigma their std), zero
    beyond the median distance, ones on the diagonal. The configuration's
    ``graph_seed`` fixes it, the same in every run."""
    n = cfg["num_nodes"]
    rng = np.random.RandomState(cfg["graph_seed"])
    pts = rng.randn(n, 3)
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    d = np.linalg.norm(pts[:, None] - pts[None, :], axis=-1)
    adj = np.exp(-np.square(d / d.std()))
    adj[d > np.median(d)] = 0.0
    np.fill_diagonal(adj, 1.0)
    return adj.astype(np.float32)


def adjacency_pickle(adj: np.ndarray, directory: str) -> str:
    """The graph in the published pickle format ([names, index, adj]), for
    the program's loader."""
    path = os.path.join(directory, "adj_mx_3d.pkl")
    n = adj.shape[0]
    with open(path, "wb") as f:
        pickle.dump([[f"ch{i}" for i in range(n)],
                     {f"ch{i}": i for i in range(n)}, adj], f)
    return path


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------


def _cell_shapes(prefix: str, d: int, h: int, m: int) -> list:
    rows = (d + h) * m
    return [(f"{prefix}.gate_w", (rows, 2 * h), "xavier"),
            (f"{prefix}.gate_b", (2 * h,), "zero"),
            (f"{prefix}.cand_w", (rows, h), "xavier"),
            (f"{prefix}.cand_b", (h,), "zero")]


def param_shapes(cfg: dict) -> list:
    """(name, shape, init) of every parameter, in the published layout:
    cell weights (D_total*M, out), row d*M + m; linear layers (out, in)."""
    h, layers = cfg["rnn_units"], cfg["num_rnn_layers"]
    m = (1 if cfg["graph_type"] == "combined" else 2) \
        * cfg["max_diffusion_step"] + 1
    dims = [cfg["input_dim"]] + [h] * (layers - 1)
    out = []
    for i, d in enumerate(dims):
        out += _cell_shapes(f"encoder.{i}", d, h, m)
    if cfg["task"] == "SS pre-training":
        out += _cell_shapes("decoder.layer0", cfg["output_dim"], h, m)
        if layers > 1:
            out += _cell_shapes("decoder.shared", h, h, m)
        d_out = cfg["output_dim"]
        out += [("decoder.proj.weight", (d_out, h), "uniform"),
                ("decoder.proj.bias", (d_out,), "uniform")]
    else:
        c = cfg["num_classes"]
        out += [("fc.weight", (c, h), "uniform"),
                ("fc.bias", (c,), "uniform")]
    return out


def make_params(cfg: dict, seed: int, device) -> dict:
    """The published initialization, drawn on ``device``: Xavier-normal
    cell weights (gain 1.414), zero cell biases, linear layers uniform in
    +-1/sqrt(units). One normal and one uniform draw for all of them."""
    shapes = param_shapes(cfg)
    gen = generator(seed, "weights", device)
    size = lambda s: int(np.prod(s))
    normal = torch.randn(sum(size(s) for _, s, k in shapes if k == "xavier"),
                         generator=gen, device=device)
    uniform = torch.rand(sum(size(s) for _, s, k in shapes
                             if k == "uniform"), generator=gen, device=device)
    bound = 1.0 / cfg["rnn_units"] ** 0.5
    params, i_n, i_u = {}, 0, 0
    for name, shape, kind in shapes:
        k = size(shape)
        if kind == "xavier":
            std = 1.414 * (2.0 / (shape[0] + shape[1])) ** 0.5
            params[name] = (normal[i_n:i_n + k] * std).reshape(shape)
            i_n += k
        elif kind == "uniform":
            params[name] = ((uniform[i_u:i_u + k] * 2 - 1) * bound
                            ).reshape(shape)
            i_u += k
        else:
            params[name] = torch.zeros(shape, device=device)
    return params


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------


def features(shape, cfg: dict, gen: torch.Generator, device,
             standardized: bool) -> torch.Tensor:
    """Featurized windows: N(mean, std) of the configuration's feature
    statistics, or N(0, 1) when ``standardized``."""
    x = torch.randn(shape, generator=gen, device=device)
    if not standardized:
        x.mul_(cfg["feature_std"]).add_(cfg["feature_mean"])
    return x
