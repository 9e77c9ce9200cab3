"""Weights carried across from the JAX package.

The JAX parameter trees, by model (``eeg_gnn_tpu/models/``):

- DCRNN classification ``{"encoder": [{gate_w, gate_b, cand_w, cand_b},
  ...], "fc_w", "fc_b"}`` (``dcrnn.py:94-104``) and SSL next-window
  prediction ``{"encoder": [...], "decoder": {"layer0", "shared",
  "proj_w", "proj_b"}}`` (``:142-153``; ``shared`` only with more than one
  layer);
- LSTM: the flat ``weight_ih_l{k}``, ``weight_hh_l{k}``, ``bias_ih_l{k}``,
  ``bias_hh_l{k}``, ``fc_w``, ``fc_b`` (``lstm.py``);
- CNN-LSTM: ``conv1_w`` ... ``fc2_b`` and the LSTM's ``*_l{0,1}``
  (``cnnlstm.py``);
- Dense-CNN: ``inception_{i}/branch{X}_{j}/{w,b}``, ``conv1x1_*/{w,b}``,
  ``fc1``, ``fc2``, ``fcbn1/{scale,bias}`` (``densecnn.py``), and its
  model state ``{"fcbn1": {"mean", "var"}}``, the BatchNorm running
  statistics, which the port keeps as buffers.

Checkpoints are flat ``.npz`` files keyed by path, e.g. ``encoder/0/
gate_w`` or ``inception_0/branchA_1/w``
(``eeg_gnn_tpu/train/checkpoint.py:26-41``), the model state in a
``.state.npz`` beside them. Layouts are identical in both packages, so
every array maps over unchanged, in both directions
(``params_from_jax`` / ``params_to_jax`` / ``state_to_jax``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

_CELL_KEYS = ("gate_w", "gate_b", "cand_w", "cand_b")
_LSTM_KEYS = ("weight_ih", "weight_hh", "bias_ih", "bias_hh")
_CNNLSTM = (("conv1_w", "conv1.weight"), ("conv1_b", "conv1.bias"),
            ("conv2_w", "conv2.weight"), ("conv2_b", "conv2.bias"),
            ("fc1_w", "fc1.weight"), ("fc1_b", "fc1.bias"),
            ("fc2_w", "fc2.weight"), ("fc2_b", "fc2.bias"))
_DI = "dense_inception."
_BN = _DI + "fcbn1."
# the Dense-CNN's BatchNorm: JAX tree leaf -> the port's name
_BN_PARAMS = (("scale", "weight"), ("bias", "bias"))
_BN_STATE = (("mean", "running_mean"), ("var", "running_var"))


def _tensor(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _lstm_from(tree, prefix: str) -> Dict[str, torch.Tensor]:
    n_layers = sum(k.startswith("weight_ih_l") for k in tree)
    return {f"{prefix}{name}_l{i}": _tensor(tree[f"{name}_l{i}"])
            for i in range(n_layers) for name in _LSTM_KEYS}


def _densecnn_from(tree, model_state) -> Dict[str, torch.Tensor]:
    sd = {}
    for key, sub in tree.items():
        if key.startswith("inception_"):
            for br, wb in sub.items():
                sd[f"{_DI}{key}.{br}.conv.weight"] = _tensor(wb["w"])
                sd[f"{_DI}{key}.{br}.conv.bias"] = _tensor(wb["b"])
        elif key.startswith("conv1x1_"):
            sd[f"{_DI}{key}.conv.weight"] = _tensor(sub["w"])
            sd[f"{_DI}{key}.conv.bias"] = _tensor(sub["b"])
    for fc in ("fc1", "fc2"):
        sd[f"{_DI}{fc}.weight"] = _tensor(tree[fc]["w"])
        sd[f"{_DI}{fc}.bias"] = _tensor(tree[fc]["b"])
    for ours, theirs in _BN_PARAMS:
        sd[_BN + theirs] = _tensor(tree["fcbn1"][ours])
    width = sd[_BN + "weight"].shape[0]
    bn = (model_state or {}).get("fcbn1") or {
        "mean": np.zeros(width), "var": np.ones(width)}
    for ours, theirs in _BN_STATE:
        sd[_BN + theirs] = _tensor(bn[ours])
    sd[_BN + "num_batches_tracked"] = torch.tensor(0)
    return sd


def params_from_jax(tree, model_state: Optional[Dict] = None
                    ) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (of numpy arrays) -> the port's state_dict.

    ``model_state``: the JAX model state of a Dense-CNN (its BatchNorm
    running statistics); without it they are the JAX initial ones, mean 0
    and variance 1. ``num_batches_tracked``, which the JAX state lacks and
    momentum 0.1 never reads, is 0."""
    if "inception_0" in tree:
        return _densecnn_from(tree, model_state)
    if "conv1_w" in tree:
        sd = {theirs: _tensor(tree[ours]) for ours, theirs in _CNNLSTM}
        sd.update(_lstm_from(tree, "lstm."))
        return sd
    if "weight_ih_l0" in tree:
        sd = _lstm_from(tree, "lstm.")
        sd["fc.weight"] = _tensor(tree["fc_w"])
        sd["fc.bias"] = _tensor(tree["fc_b"])
        return sd
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


def _array(state_dict, k) -> np.ndarray:
    return state_dict[k].detach().float().cpu().numpy()


def _lstm_to(state_dict, prefix: str) -> Dict[str, np.ndarray]:
    n_layers = sum(k.startswith(f"{prefix}weight_ih_l") for k in state_dict)
    return {f"{name}_l{i}": _array(state_dict, f"{prefix}{name}_l{i}")
            for i in range(n_layers) for name in _LSTM_KEYS}


def _densecnn_to(state_dict) -> Dict:
    arr = lambda k: _array(state_dict, k)
    tree: Dict = {}
    for k in state_dict:
        parts = k[len(_DI):].split(".")
        if parts[0].startswith("inception_") and parts[-1] == "weight":
            tree.setdefault(parts[0], {})[parts[1]] = {
                "w": arr(k), "b": arr(k[:-len("weight")] + "bias")}
        elif parts[0].startswith("conv1x1_") and parts[-1] == "weight":
            tree[parts[0]] = {"w": arr(k),
                              "b": arr(k[:-len("weight")] + "bias")}
    for fc in ("fc1", "fc2"):
        tree[fc] = {"w": arr(f"{_DI}{fc}.weight"), "b": arr(f"{_DI}{fc}.bias")}
    tree["fcbn1"] = {ours: arr(_BN + theirs) for ours, theirs in _BN_PARAMS}
    return tree


def params_to_jax(state_dict) -> Dict:
    """The port's state_dict (of any registry model) -> the JAX parameter
    tree of numpy float32 arrays; the inverse of :func:`params_from_jax`.
    A Dense-CNN's running statistics are model state
    (:func:`state_to_jax`)."""
    if _BN + "weight" in state_dict:
        return _densecnn_to(state_dict)
    if "conv1.weight" in state_dict:
        tree = {ours: _array(state_dict, theirs) for ours, theirs in _CNNLSTM}
        tree.update(_lstm_to(state_dict, "lstm."))
        return tree
    if "lstm.weight_ih_l0" in state_dict:
        tree = _lstm_to(state_dict, "lstm.")
        tree["fc_w"], tree["fc_b"] = (_array(state_dict, "fc.weight"),
                                      _array(state_dict, "fc.bias"))
        return tree
    arr = lambda k: _array(state_dict, k)
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


def state_to_jax(state_dict) -> Dict:
    """The JAX model state of the port's state_dict: a Dense-CNN's
    ``{"fcbn1": {"mean", "var"}}``, ``{}`` for every other model (JAX
    ``CheckpointSaver`` writes a ``.state.npz`` only when it is not
    empty)."""
    if _BN + "running_mean" not in state_dict:
        return {}
    return {"fcbn1": {ours: _array(state_dict, _BN + theirs)
                      for ours, theirs in _BN_STATE}}


def state_path(path: str) -> str:
    """The model-state file beside a checkpoint: ``best.npz`` ->
    ``best.state.npz`` (JAX ``train/checkpoint.py:116-122``)."""
    return (path[:-4] if path.endswith(".npz") else path) + ".state.npz"


def _read_like(path: str, template):
    """The arrays of a flat ``.npz`` in the structure of ``template`` (a
    JAX-layout tree), with the JAX ``load_params_like``'s shape check."""
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

        return rebuild(template)


def load_params_like(path: str, template,
                     with_state: bool = False) -> Dict[str, torch.Tensor]:
    """Read a flat JAX-layout ``.npz`` (either package's) into a state_dict
    with the keys and shapes of ``template`` (a registry model's
    state_dict), as the JAX ``load_params_like`` rebuilds its template
    tree. The model state (a Dense-CNN's running statistics) is the
    template's, or with ``with_state`` read from the ``.state.npz`` beside
    ``path`` where there is one (JAX ``run_experiment``,
    ``trainer.py:667-672``)."""
    model_state = state_to_jax(template)
    if with_state and model_state and os.path.exists(state_path(path)):
        model_state = _read_like(state_path(path), model_state)
    return params_from_jax(_read_like(path, params_to_jax(template)),
                           model_state)


def load_jax_npz(path: str, cfg) -> Dict[str, torch.Tensor]:
    """Read a JAX ``.npz`` checkpoint of the model of ``cfg`` (an
    ``ExperimentConfig``) into the port's state_dict, with its
    ``.state.npz`` where there is one."""
    from eeg_gnn_tpu_torch.models.registry import build_model

    return load_params_like(path, build_model(cfg).state_dict(),
                            with_state=True)
