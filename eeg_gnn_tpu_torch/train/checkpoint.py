"""Checkpointing: best/last semantics and the fine-tune transplant
(``eeg_gnn_tpu/train/checkpoint.py``).

Parity: reference ``utils.CheckpointSaver`` (utils.py:83-153) — every eval
writes ``last``; when the monitored metric improves (direction from
``maximize_metric``) it is copied to ``best`` — and
``utils.build_finetune_model`` (utils.py:166-176), which transplants only
the encoder's gate/candidate diffusion weights from a (deeper) pretrained
SSL model into a fresh task model.

Parameter files are the JAX package's: a flat ``.npz`` keyed by the JAX
tree path (``encoder/0/gate_w``, ``fc_w``, ``decoder/layer0/...``; through
``io/jax_params.params_to_jax``) plus a JSON sidecar of metadata, so each
package reads the other's ``best.npz``. The optimizer state (torch Adam's
moments and step counts, the schedule's step) goes to ``last.opt.npz``
under this package's own flat keys; neither package restores it.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from eeg_gnn_tpu_torch.io.jax_params import (  # noqa: F401
    load_params_like,
    params_to_jax,
)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _save_flat(path: str, flat: Dict[str, np.ndarray],
               metadata: Optional[Dict[str, Any]] = None):
    np.savez(path, **flat)
    if metadata is not None:
        with open(path + ".json", "w") as f:
            json.dump(metadata, f, indent=2, sort_keys=True, default=str)


def save_params(path: str, state_dict: Mapping[str, torch.Tensor],
                metadata: Optional[Dict[str, Any]] = None):
    """Write a DCRNN state_dict as the JAX package's flat ``.npz``
    (``np.savez`` appends the suffix to ``path``)."""
    _save_flat(path, _flatten(params_to_jax(state_dict)), metadata)


def optimizer_arrays(optimizer) -> Dict[str, np.ndarray]:
    """The state of a ``train.optim.Optimizer`` as flat arrays: per
    parameter (in the model's parameter order) ``adam/<i>/step``,
    ``exp_avg`` and ``exp_avg_sq``, and ``schedule/step``."""
    out = {"schedule/step": np.asarray(optimizer.scheduler.last_epoch)}
    for i, p in enumerate(optimizer.params):
        for k, v in optimizer.adam.state.get(p, {}).items():
            out[f"adam/{i}/{k}"] = v.detach().cpu().numpy()
    return out


class CheckpointSaver:
    """best/last checkpoint manager (reference utils.py:83-153 semantics)."""

    def __init__(self, save_dir: str, metric_name: str,
                 maximize_metric: bool = False, log=None):
        self.save_dir = save_dir
        self.metric_name = metric_name
        self.maximize_metric = maximize_metric
        self.best_val = None
        self.log = log
        os.makedirs(save_dir, exist_ok=True)
        self._print(
            f"Saver will {'max' if maximize_metric else 'min'}imize {metric_name}..."
        )

    def _print(self, msg):
        if self.log is not None:
            self.log.info(msg)

    def is_best(self, metric_val) -> bool:
        if metric_val is None:
            return False
        if self.best_val is None:
            return True
        return (
            (self.maximize_metric and self.best_val <= metric_val)
            or (not self.maximize_metric and self.best_val >= metric_val)
        )

    @property
    def last_path(self):
        return os.path.join(self.save_dir, "last.npz")

    @property
    def best_path(self):
        return os.path.join(self.save_dir, "best.npz")

    def save(self, epoch: int, state_dict, optimizer, metric_val):
        """Write ``last.npz``, its metadata ``last.json`` and
        ``last.opt.npz`` and, when ``metric_val`` is the best so far, copy
        the two ``.npz`` to ``best`` (the JAX package's file set)."""
        meta = {"epoch": epoch, self.metric_name: metric_val}
        save_params(self.last_path[:-4], state_dict, metadata=meta)
        _save_flat(self.last_path[:-4] + ".opt", optimizer_arrays(optimizer))
        if self.is_best(metric_val):
            self.best_val = metric_val
            shutil.copy(self.last_path, self.best_path)
            shutil.copy(self.last_path[:-4] + ".opt.npz",
                        self.best_path[:-4] + ".opt.npz")
            self._print(f"New best checkpoint at epoch {epoch}...")


def build_finetune_params(new_params: Mapping[str, torch.Tensor],
                          pretrained_params: Mapping[str, torch.Tensor],
                          num_rnn_layers: int) -> Dict[str, torch.Tensor]:
    """Transplant encoder diffusion-conv weights from a pretrained SSL model.

    Parity: reference ``build_finetune_model`` (utils.py:166-176): only the
    first ``num_rnn_layers`` encoder cells' gate/candidate transforms are
    copied (the pretrained model may be deeper); decoder/head stay fresh.
    """
    out = dict(new_params)
    for layer in range(num_rnn_layers):
        for k in ("gate_w", "gate_b", "cand_w", "cand_b"):
            key = f"encoder.{layer}.{k}"
            out[key] = pretrained_params[key].clone()
    return out


def get_save_dir(base_dir: str, training: bool, id_max: int = 500) -> str:
    """Unique numbered run dir (reference utils.py:61-80)."""
    subdir = "train" if training else "test"
    for uid in range(1, id_max):
        save_dir = os.path.join(base_dir, subdir, f"{subdir}-{uid:02d}")
        if not os.path.exists(save_dir):
            os.makedirs(save_dir)
            return save_dir
    raise RuntimeError("Too many save directories created with the same name.")
