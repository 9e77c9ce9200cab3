"""FFT log-amplitude featurizer: the host (numpy) path.

The reference computes, per 1-second window, the log-amplitude of the
positive-frequency half of the FFT on the host in DataLoader workers
(reference ``data/data_utils.py:13-34``, invoked per time step at
``data/dataloader_detection.py:63-74``). These are the exact-semantics
numpy functions of ``eeg_gnn_tpu/ops/fft_features.py`` (full complex FFT,
truncate to floor(n/2) bins, exact-zero floor at 1e-8), which the data
pipeline's datasets call per clip. The batched on-device featurizer
belongs to the device pipeline (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import numpy as np

# The reference floors exact-zero amplitudes at 1e-8 before the log
# (data_utils.py:29). Note: exact zeros only, not small values.
_ZERO_FLOOR = 1e-8


def log_amplitude_fft_np(signals: np.ndarray, n: int) -> np.ndarray:
    """log|FFT| of the positive-frequency half.

    Args:
        signals: (..., num_points) real signals.
        n: FFT length; output keeps the first floor(n/2) bins.

    Parity: reference ``computeFFT`` (data/data_utils.py:13-34), amplitude
    branch (the phase spectrum is computed there but discarded by every
    caller, so it is not produced).
    """
    fourier = np.fft.fft(signals, n=n, axis=-1)
    idx_pos = int(np.floor(n / 2))
    amp = np.abs(fourier[..., :idx_pos])
    amp[amp == 0.0] = _ZERO_FLOOR
    return np.log(amp)


def featurize_clip_np(clip: np.ndarray, time_step_size: int,
                      frequency: int = 200,
                      use_fft: bool = True) -> np.ndarray:
    """Slice a raw clip into windows and (optionally) FFT.

    Args:
        clip: (num_channels, clip_len*frequency) raw signal slice.
        time_step_size: window length in seconds.
        frequency: sampling rate (Hz).
        use_fft: if False, returns raw windows.

    Returns:
        (num_windows, num_channels, window_points or window_points//2).

    Parity: the windowing loop of ``computeSliceMatrix``
    (data/dataloader_detection.py:61-74): non-overlapping windows of
    ``time_step_size*frequency`` points, trailing remainder dropped.
    """
    step = int(time_step_size * frequency)
    num_ch, total = clip.shape
    num_win = total // step
    windows = clip[:, : num_win * step].reshape(num_ch, num_win, step)
    windows = np.transpose(windows, (1, 0, 2))  # (T, C, step)
    if use_fft:
        return log_amplitude_fft_np(windows, n=step)
    return windows
