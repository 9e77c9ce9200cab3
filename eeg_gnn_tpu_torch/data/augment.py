"""Train-time data augmentation.

Parity: reference per-dataloader ``_random_reflect`` / ``_random_scale``
(dataloader_detection.py:233-256), as ``eeg_gnn_tpu/data/augment.py``,
with the same ``RandomState`` draw order: (a) random left-right hemisphere
reflection, swapping symmetric electrode pairs in the clip (and the
distance graph; correlation graphs are rebuilt from the clip); (b) random
amplitude scale U(0.8, 1.2) — multiplicative on raw signals, additive
``log(scale)`` on FFT log-amplitude features.
"""

from __future__ import annotations

import numpy as np

from eeg_gnn_tpu_torch.constants import get_swap_pairs


def random_reflect(eeg_seq: np.ndarray, rng: np.random.RandomState,
                   reflect=None):
    """Maybe reflect a (T, N, D) clip along the scalp midline.

    Returns (clip, swap_pairs-or-None). ``reflect`` forces the decision
    (used by the SSL dataset to apply the same choice to x and y,
    dataloader_ssl.py:317-322).
    """
    swap_pairs = get_swap_pairs()
    out = eeg_seq.copy()
    if reflect is None:
        reflect = bool(rng.choice([True, False]))
    if reflect:
        for a, b in swap_pairs:
            out[:, [a, b], :] = eeg_seq[:, [b, a], :]
        return out, swap_pairs
    return out, None


def random_scale(eeg_seq: np.ndarray, rng: np.random.RandomState,
                 use_fft: bool, scale_factor=None):
    """Random amplitude scaling; log-additive on FFT features."""
    if scale_factor is None:
        scale_factor = rng.uniform(0.8, 1.2)
    if use_fft:
        return eeg_seq + np.log(scale_factor)
    return eeg_seq * scale_factor
