"""CNN-LSTM baseline: per-window 2-D convs -> FC -> 2-layer LSTM -> FC
(``eeg_gnn_tpu/models/cnnlstm.py``; reference ``model/cnnlstm.py:6-37``).

Two reference quirks are kept, as the JAX package keeps them:

- its ``nn.LSTM`` is built WITHOUT ``batch_first`` and fed the (B, T,
  512) tensor, so it scans the *batch* axis: clip i's output depends on
  clips 0..i-1 of its batch, and rows appended at the end (the
  Predictor's padding) change no earlier row;
- ``last_relevant`` then gathers along the true time axis of that
  output.

The widths are fixed (32 conv channels, fc1 32*7*48 -> 512, 2 x 128 LSTM
units), so the input is N=19 electrodes x D=100 FFT bins. Submodules
``conv1``, ``conv2``, ``fc1``, ``lstm``, ``fc2`` carry the reference's
state-dict names. The model runs in float32.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from eeg_gnn_tpu_torch.models.dcrnn import last_relevant
from eeg_gnn_tpu_torch.models.lstm import init_uniform_

CONV_CH, FC1_OUT, LSTM_UNITS = 32, 512, 128


class CNNLSTM(nn.Module):
    """(B, T, 19, 100) clips -> (B, num_classes) logits (JAX
    ``cnnlstm_apply``). ``generator`` draws the weights as torch's default
    init and the JAX ``init_cnnlstm_params`` do, U(+-1/sqrt(fan_in));
    without one the parameters are zeros."""

    def __init__(self, num_classes: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(1, CONV_CH, 3)
        self.conv2 = nn.Conv2d(CONV_CH, CONV_CH, 3)
        self.pool = nn.MaxPool2d(2, 2)
        self.fc1 = nn.Linear(CONV_CH * 7 * 48, FC1_OUT)
        self.lstm = nn.LSTM(FC1_OUT, LSTM_UNITS, 2)  # NOT batch_first
        self.fc2 = nn.Linear(LSTM_UNITS, num_classes)
        for mod, fan_in in ((self.conv1, 9), (self.conv2, CONV_CH * 9),
                            (self.fc1, self.fc1.in_features),
                            (self.lstm, LSTM_UNITS),
                            (self.fc2, LSTM_UNITS)):
            init_uniform_(mod.parameters(), 1.0 / fan_in ** 0.5, generator)

    def forward(self, x_seq, seq_lengths, supports=None,
                generator: Optional[torch.Generator] = None):
        """x_seq: (B, T, 19, 100); seq_lengths: (B,); supports and
        generator: ignored (no graph, no dropout)."""
        b, t, n, d = x_seq.shape
        out = self.conv2(self.conv1(x_seq.reshape(b * t, 1, n, d)))
        out = self.fc1(self.pool(out).reshape(b * t, -1))
        # QUIRK: the LSTM's sequence axis is the batch axis
        lstm_out, _ = self.lstm(out.reshape(b, t, -1))
        return self.fc2(last_relevant(lstm_out, seq_lengths))
