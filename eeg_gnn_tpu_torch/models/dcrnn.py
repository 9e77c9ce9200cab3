"""DCRNN task models as ``nn.Module`` s, the counterparts of
``eeg_gnn_tpu/models/dcrnn.py``: seizure detection / classification
(reference ``model/model.py:208-272``) and self-supervised next-window
prediction (reference ``model/model.py:277-360``)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from eeg_gnn_tpu_torch.models.dcgru import (
    DCGRUCell,
    DCGRUConfig,
    DCGRUDecoder,
    decoder_apply,
    dropout,
    encoder_apply,
    encoder_configs,
)


@dataclasses.dataclass(frozen=True)
class DCRNNConfig:
    """Static model configuration (the subset of the reference args surface
    the DCRNN models read, args.py:80-128)."""

    input_dim: int = 100
    output_dim: int = 100
    rnn_units: int = 64
    num_rnn_layers: int = 2
    max_diffusion_step: int = 2
    num_nodes: int = 19
    num_supports: int = 1  # 1 for laplacian, 2 for dual_random_walk
    num_classes: int = 1
    dcgru_activation: str = "tanh"
    dropout: float = 0.0
    cl_decay_steps: int = 3000
    use_curriculum_learning: bool = False
    compute_dtype: str = "float32"
    recurrence: str = "pallas"
    input_fusion: bool = False
    use_pallas: bool = False  # the encoder's; the decoder ignores it

    def encoder_cfgs(self):
        return encoder_configs(
            self.input_dim, self.rnn_units, self.max_diffusion_step,
            self.num_nodes, self.num_supports, self.num_rnn_layers,
            self.dcgru_activation, self.compute_dtype, self.recurrence,
            self.input_fusion, self.use_pallas)


def compute_sampling_threshold(cl_decay_steps, global_step):
    """Scheduled-sampling teacher-forcing ratio (reference utils.py:385-390):
    a float for a number ``global_step``, a 0-d tensor on its device for a
    tensor."""
    if isinstance(global_step, torch.Tensor):
        return cl_decay_steps / (cl_decay_steps
                                 + torch.exp(global_step / cl_decay_steps))
    return cl_decay_steps / (cl_decay_steps
                             + math.exp(global_step / cl_decay_steps))


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


class DCRNNNextTimePred(nn.Module):
    """Self-supervised next-window prediction: the encoder's final states
    start a seq2seq decoder with scheduled sampling (reference
    ``DCRNNModel_nextTimePred``; JAX ``init_next_time_pred_model`` +
    ``next_time_pred_apply``).

    ``generator`` draws the initial weights as the JAX package does
    (xavier-normal cells, zero biases, ``nn.Linear``-style uniform
    projection; the decoder's layers >= 1 share one cell); without one
    the parameters are zeros, a template for ``load_state_dict``.
    State-dict keys follow the JAX parameter tree:
    ``encoder.<i>.{gate_w,gate_b,cand_w,cand_b}``, ``decoder.layer0.*``,
    ``decoder.shared.*`` (more than one layer) and ``decoder.proj.weight``
    / ``decoder.proj.bias`` (``proj_w`` / ``proj_b``).
    """

    def __init__(self, cfg: DCRNNConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.cell_cfgs = cfg.encoder_cfgs()
        self.encoder = nn.ModuleList(
            [DCGRUCell(c, generator) for c in self.cell_cfgs])
        # no use_pallas: the decoder ignores it (JAX ``_decoder_cfgs``)
        mk = lambda d: DCGRUConfig(
            d, cfg.rnn_units, cfg.max_diffusion_step, cfg.num_nodes,
            cfg.num_supports, cfg.dcgru_activation, cfg.compute_dtype,
            cfg.recurrence)
        self.dec_cfgs = (mk(cfg.output_dim), mk(cfg.rnn_units))
        self.decoder = DCGRUDecoder(self.dec_cfgs, cfg.num_rnn_layers,
                                    cfg.output_dim, generator)

    def forward(self, enc_inputs, dec_inputs, supports, batches_seen=None,
                generator: Optional[torch.Generator] = None):
        """enc_inputs: (B, T_in, N, input_dim); dec_inputs: (B, T_out, N,
        output_dim), the ground truth that scheduled sampling feeds back;
        supports: (S, ..., N, N); batches_seen: the sample counter of the
        curriculum (read when training with ``use_curriculum_learning``);
        generator: draws the force vector and dropout masks. Returns (B,
        T_out, N, output_dim) float32 predictions."""
        cfg = self.cfg
        hidden_stack, _ = encoder_apply(
            self.cell_cfgs, [c.params() for c in self.encoder], supports,
            enc_inputs.transpose(0, 1))
        ratio = None
        if (self.training and cfg.use_curriculum_learning
                and batches_seen is not None):
            ratio = compute_sampling_threshold(cfg.cl_decay_steps,
                                               batches_seen)
        outputs = decoder_apply(
            self.dec_cfgs, self.decoder.params(), supports,
            dec_inputs.transpose(0, 1), hidden_stack, cfg.num_rnn_layers,
            teacher_forcing_ratio=ratio, dropout_rate=cfg.dropout,
            generator=generator, training=self.training)
        return outputs.transpose(0, 1)
