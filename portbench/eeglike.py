"""EEG-like featurized clips, made from ``--seed``: each clip's channels
share a few latent sources, so each clip's correlation graph is its own.

Per clip, ``sources`` latent signals (N(0, 1) over the clip's T x D
values) are mixed into the N channels by weights drawn from
gamma(``mix_shape``), plus N(0, ``noise``^2); each channel is then scaled
to unit variance by its weights (sqrt(sum_s w^2 + noise^2)) and to the
configuration's ``feature_mean`` and ``feature_std``. The weights are
drawn on the host (``numpy``'s gamma), the signals on the device,
``CHUNK_CLIPS`` clips at a time (0.5 GB of temporaries at the cell's
sizes, so set-up holds the split and little more), and the mix is a sum
of products over the sources in float32 (no matrix product, so no TF32
setting moves a bit).

White noise of the same mean and std, which the correlation reads
without removing the mean, gives every pair of channels |corr| 0.929 +-
0.0013 and leaves a clip's top-3 neighbours to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import inputs

CHUNK_CLIPS = 1024


def features(clips: int, cfg: dict, traffic: dict, seed: int,
             device) -> torch.Tensor:
    """(clips, T, N, D) float32 features on ``device``."""
    t, n, d = cfg["max_seq_len"], cfg["num_nodes"], cfg["input_dim"]
    s = traffic["sources"]
    noise = float(traffic["noise"])
    gen = inputs.generator(seed, "split", device)
    weights = inputs.host_rng(seed, "mix").gamma(
        traffic["mix_shape"], 1.0, size=(clips, n, s)).astype(np.float32)
    scale = cfg["feature_std"] / np.sqrt(
        np.square(weights).sum(axis=-1) + noise * noise)
    weights = torch.from_numpy(weights).to(device)
    scale = torch.from_numpy(scale.astype(np.float32)).to(device)
    out = torch.empty((clips, t, n, d), device=device)
    for lo in range(0, clips, CHUNK_CLIPS):
        hi = min(lo + CHUNK_CLIPS, clips)
        src = torch.randn((hi - lo, s, 1, t * d), generator=gen,
                          device=device)
        z = torch.randn((hi - lo, n, t * d), generator=gen, device=device)
        z.mul_(noise)
        w = weights[lo:hi]
        for i in range(s):
            z.addcmul_(w[:, :, i, None], src[:, i])
        z.mul_(scale[lo:hi, :, None]).add_(cfg["feature_mean"])
        out[lo:hi] = z.view(hi - lo, n, t, d).transpose(1, 2)
    return out
