"""Model registry over ``--model_name`` (reference train.py:112-126; JAX
``eeg_gnn_tpu/models/registry.py``).

DCRNN: detection / classification, and the next-window predictor of SSL
pre-training, whatever ``--model_name`` says (the JAX trainer's choice,
``train/trainer.py:626-629``).
The baselines: the LSTM, the CNN-LSTM and the Dense-CNN
(``models/{lstm,cnnlstm,densecnn}.py``), which run in float32 whatever
``--dtype`` says (the JAX registry passes them no compute dtype). Every
model is called as ``model(x, seq_lengths, supports, generator)``; the
baselines read no graph.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from eeg_gnn_tpu_torch.config import ExperimentConfig

def densecnn_data_shape(cfg: ExperimentConfig):
    """The Dense-CNN's (time, electrodes) plane: ``max_seq_len`` seconds
    of 100 FFT bins (200 raw samples without FFT) per electrode."""
    return (cfg.max_seq_len * (100 if cfg.use_fft else 200), cfg.num_nodes)


def build_model(cfg: ExperimentConfig,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """The model for ``cfg`` on the CPU: weights drawn from ``generator``,
    or zeros (a template for ``load_state_dict``) without one."""
    if cfg.task == "SS pre-training":  # whatever --model_name says
        from eeg_gnn_tpu_torch.models.dcrnn import DCRNNNextTimePred

        return DCRNNNextTimePred(cfg.dcrnn_config(), generator)
    if cfg.task not in ("detection", "classification"):
        raise ValueError(f"unknown task {cfg.task!r}")
    if cfg.model_name == "dcrnn":
        from eeg_gnn_tpu_torch.models.dcrnn import DCRNNClassifier

        return DCRNNClassifier(cfg.dcrnn_config(), generator)
    if cfg.model_name == "lstm":
        from eeg_gnn_tpu_torch.models.lstm import LSTMModel

        return LSTMModel(cfg.input_dim * cfg.num_nodes, cfg.rnn_units,
                         cfg.num_rnn_layers, cfg.num_classes, cfg.dropout,
                         generator)
    if cfg.model_name == "cnnlstm":
        from eeg_gnn_tpu_torch.models.cnnlstm import CNNLSTM

        return CNNLSTM(cfg.num_classes, generator)
    if cfg.model_name == "densecnn":
        from eeg_gnn_tpu_torch.models.densecnn import DenseCNN

        return DenseCNN(densecnn_data_shape(cfg), cfg.num_classes, generator)
    raise NotImplementedError(cfg.model_name)
