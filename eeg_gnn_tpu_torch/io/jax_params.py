"""Weights carried across from the JAX package.

The JAX DCRNN classification parameters are the tree
``{"encoder": [{gate_w, gate_b, cand_w, cand_b}, ...], "fc_w", "fc_b"}``
(``eeg_gnn_tpu/models/dcrnn.py:94-104``); its checkpoints are flat
``.npz`` files keyed by path, e.g. ``encoder/0/gate_w``
(``eeg_gnn_tpu/train/checkpoint.py:26-41``). Layouts are identical in
both packages, so every array maps over unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_CELL_KEYS = ("gate_w", "gate_b", "cand_w", "cand_b")


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (of numpy arrays) -> the port's state_dict."""
    sd = {}
    for i, cell in enumerate(tree["encoder"]):
        for k in _CELL_KEYS:
            sd[f"encoder.{i}.{k}"] = _tensor(cell[k])
    sd["fc.weight"] = _tensor(tree["fc_w"])
    sd["fc.bias"] = _tensor(tree["fc_b"])
    return sd


def load_jax_npz(path: str, cfg) -> Dict[str, torch.Tensor]:
    """Read a JAX ``.npz`` checkpoint of the DCRNN classifier of ``cfg``
    (an ``ExperimentConfig``) into the port's state_dict."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        tree = {
            "encoder": [{k: data[f"encoder/{i}/{k}"] for k in _CELL_KEYS}
                        for i in range(cfg.num_rnn_layers)],
            "fc_w": data["fc_w"],
            "fc_b": data["fc_b"],
        }
    return params_from_jax(tree)
