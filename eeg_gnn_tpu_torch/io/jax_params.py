"""Weights carried across from the JAX package.

The JAX DCRNN parameters are the trees
``{"encoder": [{gate_w, gate_b, cand_w, cand_b}, ...], "fc_w", "fc_b"}``
(classification, ``eeg_gnn_tpu/models/dcrnn.py:94-104``) and
``{"encoder": [...], "decoder": {"layer0", "shared", "proj_w", "proj_b"}}``
(SSL next-window prediction, ``:142-153``; ``shared`` only with more than
one layer). Its checkpoints are flat ``.npz`` files keyed by path, e.g.
``encoder/0/gate_w`` or ``decoder/layer0/gate_w``
(``eeg_gnn_tpu/train/checkpoint.py:26-41``). Layouts are identical in
both packages, so every array maps over unchanged, in both directions
(``params_from_jax`` / ``params_to_jax``).
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


def params_to_jax(state_dict) -> Dict:
    """The port's state_dict (of a ``DCRNNClassifier`` or a
    ``DCRNNNextTimePred``) -> the JAX parameter tree of numpy float32
    arrays; the inverse of :func:`params_from_jax`."""
    arr = lambda k: state_dict[k].detach().float().cpu().numpy()
    n_layers = 1 + max(int(k.split(".")[1]) for k in state_dict
                       if k.startswith("encoder."))
    tree = {"encoder": [{k: arr(f"encoder.{i}.{k}") for k in _CELL_KEYS}
                        for i in range(n_layers)]}
    if "decoder.proj.weight" in state_dict:
        dec = {name: {k: arr(f"decoder.{name}.{k}") for k in _CELL_KEYS}
               for name in ("layer0", "shared")
               if f"decoder.{name}.gate_w" in state_dict}
        dec["proj_w"] = arr("decoder.proj.weight")
        dec["proj_b"] = arr("decoder.proj.bias")
        tree["decoder"] = dec
    else:
        tree["fc_w"], tree["fc_b"] = arr("fc.weight"), arr("fc.bias")
    return tree


def load_params_like(path: str, template) -> Dict[str, torch.Tensor]:
    """Read a flat JAX-layout ``.npz`` (either package's) into a state_dict
    with the keys and shapes of ``template`` (a DCRNN state_dict), as the
    JAX ``load_params_like`` rebuilds its template tree."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        def rebuild(tree, prefix=""):
            if isinstance(tree, dict):
                return {k: rebuild(v, f"{prefix}{k}/") for k, v in tree.items()}
            if isinstance(tree, list):
                return [rebuild(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
            arr = data[prefix[:-1]]
            if arr.shape != tree.shape:
                raise ValueError(f"checkpoint {prefix[:-1]}: shape "
                                 f"{arr.shape} != {tree.shape}")
            return arr

        return params_from_jax(rebuild(params_to_jax(template)))


def load_jax_npz(path: str, cfg) -> Dict[str, torch.Tensor]:
    """Read a JAX ``.npz`` checkpoint of the DCRNN model of ``cfg`` (an
    ``ExperimentConfig``: the classifier, or the next-window predictor of
    ``task="SS pre-training"``) into the port's state_dict."""
    from eeg_gnn_tpu_torch.models.registry import build_model

    return load_params_like(path, build_model(cfg).state_dict())
