"""Model registry over ``--model_name`` (reference train.py:112-126).

The port has the DCRNN models so far: detection / classification, and the
next-window predictor of SSL pre-training (the JAX trainer's choice,
``train/trainer.py:626-629``). The LSTM, CNN-LSTM and DenseCNN baselines
are still to port (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from eeg_gnn_tpu_torch.config import ExperimentConfig

_NOT_PORTED = ("lstm", "cnnlstm", "densecnn")


def build_model(cfg: ExperimentConfig,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """The model for ``cfg`` on the CPU: weights drawn from ``generator``,
    or zeros (a template for ``load_state_dict``) without one."""
    if cfg.model_name == "dcrnn":
        from eeg_gnn_tpu_torch.models.dcrnn import (
            DCRNNClassifier,
            DCRNNNextTimePred,
        )

        if cfg.task == "SS pre-training":
            return DCRNNNextTimePred(cfg.dcrnn_config(), generator)
        if cfg.task not in ("detection", "classification"):
            raise ValueError(f"unknown task {cfg.task!r}")
        return DCRNNClassifier(cfg.dcrnn_config(), generator)
    if cfg.model_name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {cfg.model_name!r} is not ported yet (ROADMAP.md, "
            "Queue 1: baselines)")
    raise NotImplementedError(cfg.model_name)
