"""Model registry over ``--model_name`` (reference train.py:112-126).

The port has the DCRNN classification model so far; the LSTM, CNN-LSTM
and DenseCNN baselines are still to port (ROADMAP.md, Queue 1).
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
        if cfg.task not in ("detection", "classification"):
            raise NotImplementedError(
                f"task {cfg.task!r} is not ported yet (SSL pre-training is "
                "a later slice; see ROADMAP.md)")
        from eeg_gnn_tpu_torch.models.dcrnn import DCRNNClassifier

        return DCRNNClassifier(cfg.dcrnn_config(), generator)
    if cfg.model_name in _NOT_PORTED:
        raise NotImplementedError(
            f"model {cfg.model_name!r} is not ported yet (ROADMAP.md, "
            "Queue 1: baselines)")
    raise NotImplementedError(cfg.model_name)
