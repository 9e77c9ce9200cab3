"""Dense-Inception CNN baseline ("Dense-CNN") (``eeg_gnn_tpu/models/
densecnn.py``; reference ``model/densecnn.py`` and
``model/dense_inception/*``, configured by its ``params.json``: 10
channels, dropout 0.2).

Densely connected inception blocks of 1-D-in-time convolutions (kernels
(k, 1) over a (time, electrode) plane), 1x1 squeeze convolutions, stage
max-pools, and an FC head with BatchNorm and dropout. The reference's
quirks are kept, as in the JAX package:

- ``Inception4`` pools nothing, and its duplicate ``branchC_*``
  assignments leave ``branchC_1`` as the (21, 1) construction (the last
  one wins) beside ``branchC_2`` of (filter_size[2], 1);
- the forward applies ``inception_4`` and ``inception_6`` twice each and
  never calls ``inception_5`` or ``inception_7``, whose weights still
  exist (checkpoints hold them);
- the squeezes run in the order conv1x1_10, _2, _3, _32, _4, _5, _54,
  _6, _7, _76, and the stage max-pools are (7, 1), (5, 1), (5, 1), (4,
  1);
- dropout is hardcoded at ``DROPOUT_RATE`` (read at each call);
- the reference's ``train.py`` scrambles the flat clip with
  ``transpose(-1, -2).reshape(B, -1, N)`` before the model
  (DIVERGENCES.md), which ``DenseCNN.forward`` does first. The model's
  ``view(-1)`` of a one-class head and the ``[:, None]`` that the JAX
  registry puts back after it cancel, so the logits are (B,
  num_classes).

``fcbn1`` is ``nn.BatchNorm1d`` (momentum 0.1, eps 1e-5): in training the
batch statistics, and the running statistics updated with the unbiased
variance (JAX ``_batchnorm1d``); in eval the running statistics, which
are buffers of ``state_dict()``. Submodule names are the reference's
(``dense_inception.inception_{i}.branch{X}_{j}.conv``,
``dense_inception.conv1x1_*.conv``, ``dense_inception.fc1`` / ``fcbn1`` /
``fc2``), so its ``.pth.tar`` maps key for key. The model runs in
float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from eeg_gnn_tpu_torch.models.dcgru import dropout
from eeg_gnn_tpu_torch.models.lstm import init_uniform_

DROPOUT_RATE = 0.2  # the reference's params.json; the CLI's --dropout
# does not reach it (JAX registry.py:113)
NUM_CHANNELS = 10

# (filter sizes, in-channel multiplier (None: 1 channel), pool-features
# multiplier) of the eight inception stages (JAX densecnn.py:_STAGES)
_STAGES = (((9, 15, 21), None, 1), ((9, 13, 17), 3, 3),
           ((7, 11, 15), 9, 9), ((5, 7, 9), 18, 18), ((3, 5, 7), 18, 18),
           ((3, 5, 7), 18, 18), ((3, 5, 7), 18, 18), ((3, 5, 7), 18, 18))
# the 1x1 squeezes: (name, in multiplier, out multiplier)
_SQUEEZES = (("conv1x1_10", 12, 9), ("conv1x1_2", 27, 18),
             ("conv1x1_3", 54, 18), ("conv1x1_32", 36, 18),
             ("conv1x1_4", 54, 18), ("conv1x1_5", 54, 27),
             ("conv1x1_54", 45, 18), ("conv1x1_6", 54, 18),
             ("conv1x1_7", 54, 27), ("conv1x1_76", 45, 36))
_POOLS = (7, 5, 5, 4)
FC_UNITS = 128


class BasicConv2d(nn.Module):
    """Conv (k, 1) with padding (pad, 0), then ReLU. Weights N(0,
    sqrt(2/n)) with n = kh * kw * out_channels, biases U(+-1/sqrt(fan_in))
    (reference dense_inception.py:57-66)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, pad: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, (k, 1), padding=(pad, 0))
        with torch.no_grad():
            w = self.conv.weight
            if generator is None:
                w.zero_()
            else:
                w.copy_(torch.empty(w.shape).normal_(
                    0.0, math.sqrt(2.0 / (k * out_ch)), generator=generator))
        init_uniform_([self.conv.bias], 1.0 / math.sqrt(in_ch * k),
                      generator)

    def forward(self, x):
        return torch.relu(self.conv(x))


class Inception4(nn.Module):
    """Three branches of (k, 1) convolutions over time, concatenated on
    channels; no pooling (reference inceptions.py:141-157)."""

    def __init__(self, in_ch: int, pf: int, filter_size, generator):
        super().__init__()
        f0, f1, f2 = filter_size
        conv = lambda i, k, p: BasicConv2d(i, pf, k, p, generator)
        self.branchA_1 = conv(in_ch, f0, (f0 - 1) // 2)
        self.branchA_2 = conv(pf, f0, (f0 - 1) // 2)
        self.branchB_1 = conv(in_ch, f1, (f1 - 1) // 2)
        self.branchB_2 = conv(pf, f1, (f1 - 1) // 2)
        self.branchB_3 = conv(pf, f1, (f1 - 1) // 2)
        self.branchC_1 = conv(in_ch, 21, 10)  # the last assignment wins
        self.branchC_2 = conv(pf, f2, (f2 - 1) // 2)

    def forward(self, x):
        a = self.branchA_2(self.branchA_1(x))
        b = self.branchB_3(self.branchB_2(self.branchB_1(x)))
        c = self.branchC_2(self.branchC_1(x))
        return torch.cat([a, b, c], dim=1)


def fc1_features(data_shape: Tuple[int, int], nc: int = NUM_CHANNELS) -> int:
    """fc1's input width: electrodes x 36 nc channels x the time left
    after the four pools (reference densecnn.py)."""
    return data_shape[1] * nc * 36 * int(data_shape[0] / math.prod(_POOLS))


class DenseInception(nn.Module):
    """The reference's ``DenseInception`` on a (B, 1, time, electrodes)
    plane."""

    def __init__(self, data_shape: Tuple[int, int], num_classes: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        if fc1_features(data_shape) == 0:
            raise ValueError(
                f"the Dense-CNN's plane {data_shape} leaves no time after "
                f"its pools: it takes at least {math.prod(_POOLS)} rows")
        nc = NUM_CHANNELS
        for i, (fs, mult, pf) in enumerate(_STAGES):
            in_ch = 1 if mult is None else nc * mult
            setattr(self, f"inception_{i}",
                    Inception4(in_ch, nc * pf, fs, generator))
        for name, cin, cout in _SQUEEZES:
            setattr(self, name, BasicConv2d(nc * cin, nc * cout, 1, 0,
                                            generator))
        self.pools = nn.ModuleList(nn.MaxPool2d((k, 1), (k, 1))
                                   for k in _POOLS)
        self.fc1 = nn.Linear(fc1_features(data_shape), FC_UNITS)
        self.fcbn1 = nn.BatchNorm1d(FC_UNITS, momentum=0.1, eps=1e-5)
        self.fc2 = nn.Linear(FC_UNITS, num_classes)
        for fc in (self.fc1, self.fc2):  # the reference zeroes their biases
            init_uniform_([fc.weight], 1.0 / math.sqrt(fc.in_features),
                          generator)
            nn.init.zeros_(fc.bias)

    def _stage(self, s, first, second, squeezes, pool):
        """Two inceptions (each followed by its squeeze, where named) and
        the dense squeeze of their concatenation, then the pool."""
        sq = lambda name, v: v if name is None else getattr(self, name)(v)
        s_0 = sq(squeezes[0], getattr(self, f"inception_{first}")(s))
        s_1 = sq(squeezes[1], getattr(self, f"inception_{second}")(s_0))
        return pool(getattr(self, squeezes[2])(torch.cat([s_0, s_1], 1)))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        s = self._stage(x, 0, 1, (None, None, "conv1x1_10"), self.pools[0])
        s = self._stage(s, 2, 3, ("conv1x1_2", "conv1x1_3", "conv1x1_32"),
                        self.pools[1])
        # inception_4 and inception_6 are each applied twice (quirk)
        s = self._stage(s, 4, 4, ("conv1x1_4", "conv1x1_5", "conv1x1_54"),
                        self.pools[2])
        s = self._stage(s, 6, 6, ("conv1x1_6", "conv1x1_7", "conv1x1_76"),
                        self.pools[3])
        h = torch.relu(self.fcbn1(self.fc1(s.reshape(s.shape[0], -1))))
        h = dropout(h, DROPOUT_RATE, self.training, generator)
        return self.fc2(h)


class DenseCNN(nn.Module):
    """Flat clips -> (B, num_classes) logits (JAX ``densecnn_apply``
    behind its registry bundle, ``train.py``'s scramble included).

    Args:
        data_shape: (time, electrodes) of the model's plane:
            ``(max_seq_len * 100, 19)`` under FFT.
        num_classes: the head's width.
        generator: draws the weights (see ``BasicConv2d``; FC weights
            U(+-1/sqrt(in)), biases 0; BatchNorm scale 1, bias 0); without
            one the weights are zeros. The running statistics start at
            mean 0, variance 1 either way.
    """

    def __init__(self, data_shape: Tuple[int, int], num_classes: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_nodes = data_shape[1]
        self.dense_inception = DenseInception(data_shape, num_classes,
                                              generator)

    def forward(self, x, seq_lengths=None, supports=None,
                generator: Optional[torch.Generator] = None):
        """x: (B, time, N) flat clips (the Dense-CNN dataset's) or (B, T,
        N, D) featurized clips, scrambled by ``train.py``'s
        ``transpose(-1, -2).reshape(B, -1, N)``; seq_lengths and supports:
        ignored; generator: the dropout mask in training."""
        b = x.shape[0]
        x = x.transpose(-1, -2).reshape(b, -1, self.num_nodes)
        return self.dense_inception(x[:, None], generator)
