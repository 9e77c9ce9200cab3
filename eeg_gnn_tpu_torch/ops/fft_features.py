"""FFT log-amplitude featurizer (``eeg_gnn_tpu/ops/fft_features.py``).

The reference computes, per 1-second window, the log-amplitude of the
positive-frequency half of the FFT on the host in DataLoader workers
(reference ``data/data_utils.py:13-34``, invoked per time step at
``data/dataloader_detection.py:63-74``). Two implementations of the same
math:

- the exact-semantics numpy functions (full complex FFT, truncate to
  floor(n/2) bins, exact-zero floor at 1e-8), which the host datasets
  call per clip and the tests use as the oracle;
- the batched tensor path (``log_amplitude_fft``, ``featurize_clip``):
  whole batches of raw clips windowed by a reshape and transformed by one
  float32 ``torch.fft.rfft`` on the device the clips live on, for the
  on-device pipeline (``data/device_pipeline.py``).
"""

from __future__ import annotations

import numpy as np
import torch

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


def log_amplitude_fft(signals: torch.Tensor, n: int) -> torch.Tensor:
    """Batched log|FFT| of the positive-frequency half, in float32 on the
    device of ``signals``; see :func:`log_amplitude_fft_np`.

    ``rfft`` (real input) gives the complex FFT's first floor(n/2) bins at
    half the work; exact zeros floor at 1e-8 before the log.
    """
    fourier = torch.fft.rfft(signals.float(), n=n, dim=-1)
    amp = fourier[..., : n // 2].abs()
    amp = torch.where(amp == 0.0, torch.full_like(amp, _ZERO_FLOOR), amp)
    return amp.log()


def featurize_clip(clips: torch.Tensor, time_step_size: int,
                   frequency: int = 200,
                   use_fft: bool = True) -> torch.Tensor:
    """Batched clip featurizer on the device of ``clips``.

    Args:
        clips: (..., num_channels, clip_len*frequency) raw signals, any
            leading batch dims.

    Returns:
        (..., num_windows, num_channels, feat_dim) features: feat_dim is
        ``step//2`` (float32) under FFT, else the ``step`` raw points.
    """
    step = int(time_step_size * frequency)
    num_ch, total = clips.shape[-2], clips.shape[-1]
    num_win = total // step
    windows = clips[..., : num_win * step].reshape(
        *clips.shape[:-2], num_ch, num_win, step).transpose(-3, -2)
    if use_fft:
        return log_amplitude_fft(windows, n=step)
    return windows
