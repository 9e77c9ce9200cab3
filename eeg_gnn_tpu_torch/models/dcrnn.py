"""DCRNN seizure detection / classification model (reference
``model/model.py:208-272``), the classification half of
``eeg_gnn_tpu/models/dcrnn.py`` as an ``nn.Module``."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from eeg_gnn_tpu_torch.models.dcgru import (
    DCGRUCell,
    encoder_apply,
    encoder_configs,
)


@dataclasses.dataclass(frozen=True)
class DCRNNConfig:
    """Static model configuration (the subset of the reference args surface
    the classification model reads, args.py:80-128)."""

    input_dim: int = 100
    rnn_units: int = 64
    num_rnn_layers: int = 2
    max_diffusion_step: int = 2
    num_nodes: int = 19
    num_supports: int = 1  # 1 for laplacian, 2 for dual_random_walk
    num_classes: int = 1
    dcgru_activation: str = "tanh"
    dropout: float = 0.0
    compute_dtype: str = "float32"
    recurrence: str = "pallas"
    input_fusion: bool = False

    def encoder_cfgs(self):
        return encoder_configs(
            self.input_dim, self.rnn_units, self.max_diffusion_step,
            self.num_nodes, self.num_supports, self.num_rnn_layers,
            self.dcgru_activation, self.compute_dtype, self.recurrence,
            self.input_fusion)


def dropout(x, rate: float, training: bool,
            generator: Optional[torch.Generator] = None):
    """Inverted dropout (``eeg_gnn_tpu/models/dcrnn.py:81-86``) whose mask
    comes from ``generator`` (on x's device). JAX's PRNG stream cannot be
    reproduced, so parity tests run with rate 0, the flagship value."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def last_relevant(output, lengths):
    """Each sequence's last valid timestep of a batch-first (B, T, ...)
    output (reference ``utils.last_relevant_pytorch``, utils.py:346-357)."""
    idx = (lengths - 1).long()
    return output[torch.arange(output.shape[0], device=output.device), idx]


class DCRNNClassifier(nn.Module):
    """Encoder -> last relevant state -> dropout -> ReLU -> per-node FC ->
    max-pool over nodes (reference ``DCRNNModel_classification``).

    ``generator`` draws the initial weights as the JAX package's
    ``init_classification_model`` does: xavier-normal cells, zero biases,
    ``nn.Linear``-style uniform FC. Without one the parameters are zeros,
    a template for ``load_state_dict``. State-dict keys follow the JAX
    parameter tree: ``encoder.<i>.{gate_w,gate_b,cand_w,cand_b}``,
    ``fc.weight``, ``fc.bias``.
    """

    def __init__(self, cfg: DCRNNConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.cell_cfgs = cfg.encoder_cfgs()
        self.encoder = nn.ModuleList(
            [DCGRUCell(c, generator) for c in self.cell_cfgs])
        self.fc = nn.Linear(cfg.rnn_units, cfg.num_classes)
        bound = 1.0 / (cfg.rnn_units ** 0.5)
        with torch.no_grad():
            for p in (self.fc.weight, self.fc.bias):
                if generator is None:
                    p.zero_()
                else:
                    p.copy_(torch.empty(p.shape).uniform_(
                        -bound, bound, generator=generator))

    def forward(self, x_seq, seq_lengths, supports,
                generator: Optional[torch.Generator] = None):
        """x_seq: (B, T, N, input_dim) batch-first clips; seq_lengths: (B,);
        supports: (S, ..., N, N); generator: draws the dropout mask in
        training. Returns (B, num_classes) logits."""
        x_tmajor = x_seq.transpose(0, 1)
        _, top_seq = encoder_apply(self.cell_cfgs,
                                   [c.params() for c in self.encoder],
                                   supports, x_tmajor)
        # the batch-first view costs no copy: only (B, N, H) is gathered
        last = last_relevant(top_seq.transpose(0, 1), seq_lengths)
        last = last.to(x_seq.dtype)
        hidden = torch.relu(dropout(last, self.cfg.dropout, self.training,
                                    generator))
        return self.fc(hidden).amax(dim=1)
