"""Weights carried across from the JAX package.

The JAX DCRNN parameters are the trees
``{"encoder": [{gate_w, gate_b, cand_w, cand_b}, ...], "fc_w", "fc_b"}``
(classification, ``eeg_gnn_tpu/models/dcrnn.py:94-104``) and
``{"encoder": [...], "decoder": {"layer0", "shared", "proj_w", "proj_b"}}``
(SSL next-window prediction, ``:142-153``; ``shared`` only with more than
one layer). Its checkpoints are flat ``.npz`` files keyed by path, e.g.
``encoder/0/gate_w`` or ``decoder/layer0/gate_w``
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
    if "decoder" in tree:
        dec = tree["decoder"]
        for name in ("layer0", "shared"):
            for k in _CELL_KEYS if name in dec else ():
                sd[f"decoder.{name}.{k}"] = _tensor(dec[name][k])
        sd["decoder.proj.weight"] = _tensor(dec["proj_w"])
        sd["decoder.proj.bias"] = _tensor(dec["proj_b"])
    else:
        sd["fc.weight"] = _tensor(tree["fc_w"])
        sd["fc.bias"] = _tensor(tree["fc_b"])
    return sd


def load_jax_npz(path: str, cfg) -> Dict[str, torch.Tensor]:
    """Read a JAX ``.npz`` checkpoint of the DCRNN model of ``cfg`` (an
    ``ExperimentConfig``: the classifier, or the next-window predictor of
    ``task="SS pre-training"``) into the port's state_dict."""
    cell = lambda data, prefix: {k: data[f"{prefix}/{k}"] for k in _CELL_KEYS}
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        tree = {"encoder": [cell(data, f"encoder/{i}")
                            for i in range(cfg.num_rnn_layers)]}
        if cfg.task == "SS pre-training":
            dec = {"layer0": cell(data, "decoder/layer0"),
                   "proj_w": data["decoder/proj_w"],
                   "proj_b": data["decoder/proj_b"]}
            if cfg.num_rnn_layers > 1:
                dec["shared"] = cell(data, "decoder/shared")
            tree["decoder"] = dec
        else:
            tree["fc_w"], tree["fc_b"] = data["fc_w"], data["fc_b"]
    return params_from_jax(tree)
