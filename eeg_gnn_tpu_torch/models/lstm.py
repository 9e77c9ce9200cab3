"""LSTM baseline: flattened-electrode LSTM -> last relevant step -> dropout
-> ReLU -> FC (``eeg_gnn_tpu/models/lstm.py``; reference
``model/lstm.py:9-61``).

``nn.LSTM(batch_first=True)`` in torch's gate order i, f, g, o; on the
card it runs through cuDNN. The submodules are named ``lstm`` and ``fc``
as in the reference, so its state dict maps key for key
(``io/torch_import.import_lstm_params``), and the JAX tree's
``weight_ih_l{k}`` ... ``fc_w``, ``fc_b`` by renaming
(``io/jax_params.py``). The model runs in float32 whatever ``--dtype``
says, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from eeg_gnn_tpu_torch.models.dcgru import dropout
from eeg_gnn_tpu_torch.models.dcrnn import last_relevant


def init_uniform_(params, bound: float,
                  generator: Optional[torch.Generator]):
    """Draw each tensor of ``params`` from U(-bound, bound) with
    ``generator`` (torch's default LSTM and Linear init), or zero them
    without one (a template for ``load_state_dict``)."""
    with torch.no_grad():
        for p in params:
            if generator is None:
                p.zero_()
            else:
                p.copy_(torch.empty(p.shape).uniform_(-bound, bound,
                                                      generator=generator))


class LSTMModel(nn.Module):
    """(B, T, N, D) clips -> (B, num_classes) logits (JAX
    ``lstm_model_apply``).

    ``generator`` draws every weight from U(-1/sqrt(H), 1/sqrt(H)), as
    the JAX ``init_lstm_params`` does; without one the parameters are
    zeros."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 num_classes: int, dropout_rate: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.lstm = nn.LSTM(input_size, hidden_size, num_layers,
                            batch_first=True)
        self.fc = nn.Linear(hidden_size, num_classes)
        init_uniform_(self.parameters(), 1.0 / hidden_size ** 0.5, generator)

    def forward(self, x_seq, seq_lengths, supports=None,
                generator: Optional[torch.Generator] = None):
        """x_seq: (B, T, N, D); seq_lengths: (B,); supports: ignored (the
        entry points' common signature); generator: the dropout mask in
        training."""
        b, t = x_seq.shape[:2]
        out, _ = self.lstm(x_seq.reshape(b, t, -1))
        last = last_relevant(out, seq_lengths)
        hidden = torch.relu(dropout(last, self.dropout_rate, self.training,
                                    generator))
        return self.fc(hidden)
