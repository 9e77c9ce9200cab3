"""Serving / batched inference: the fixed-shape ``Predictor``.

Semantics of ``eeg_gnn_tpu/serve.py``: inputs of any length are chunked
to one fixed batch shape, the last chunk zero-padded and its padding
dropped on the host; probabilities (sigmoid for detection, softmax for
classification) and, from an ``adjacency``, the supports are computed on
the device.

Still to port (ROADMAP.md): the raw-EEG front door (``DevicePipeline``),
data-parallel meshes and reference ``.pth.tar`` checkpoints.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from eeg_gnn_tpu_torch.config import ExperimentConfig

_TORCH_SUFFIXES = (".pth.tar", ".pth", ".pt", ".tar")


def _pad_to(a: np.ndarray, size: int, axis: int = 0) -> np.ndarray:
    if a.shape[axis] == size:
        return a
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, size - a.shape[axis])
    return np.pad(a, pad)


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    """Host array -> device tensor; copies on the host only where the array
    is not already C-contiguous, writable and of ``dtype``."""
    return torch.from_numpy(np.require(a, dtype, ["C", "W"])).to(device)


def _resolve_device(device) -> torch.device:
    """``None`` means the CUDA card; the CPU only when asked for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Predictor: no CUDA device is available; pass "
                           "device='cpu' to serve on the CPU")
    return device


class Predictor:
    """Fixed-shape batched predictor over the DCRNN classification model.

    Args:
        cfg: experiment config (graph type, shapes, dtype, recurrence).
        params: the port's state_dict (see ``io/jax_params.py`` for JAX
            parameter trees and ``.npz`` files).
        batch_size: the batch shape every call runs at; defaults to
            ``cfg.test_batch_size``.
        threshold: decision threshold for detection.
        device: ``None`` (the CUDA card), or e.g. ``"cpu"``.
        pipeline / mesh: not ported yet; must be None.
    """

    def __init__(self, cfg: ExperimentConfig,
                 params: Mapping[str, torch.Tensor], *,
                 batch_size: Optional[int] = None, threshold: float = 0.5,
                 device=None, pipeline=None, mesh=None):
        from eeg_gnn_tpu_torch.models.registry import build_model

        if pipeline is not None:
            raise NotImplementedError(
                "the raw-EEG front door (DevicePipeline) is not ported yet "
                "(ROADMAP.md, Queue 1)")
        if mesh is not None:
            raise NotImplementedError(
                "data-parallel meshes are not ported yet (ROADMAP.md, "
                "Queue 1: scale-out)")
        self.cfg = cfg
        self.device = _resolve_device(device)
        self.model = build_model(cfg)
        self.model.load_state_dict(params)
        self.model.to(self.device).eval()
        self.batch_size = int(batch_size or cfg.test_batch_size)
        self.threshold = float(threshold)

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str,
                        cfg: Optional[ExperimentConfig] = None,
                        **kwargs) -> "Predictor":
        """A predictor straight from a JAX package ``.npz`` checkpoint."""
        if checkpoint_path.endswith(_TORCH_SUFFIXES):
            raise NotImplementedError(
                "reference .pth.tar import is not ported yet (ROADMAP.md, "
                "Queue 1)")
        from eeg_gnn_tpu_torch.io.jax_params import load_jax_npz

        cfg = cfg or ExperimentConfig().finalize()
        return cls(cfg, load_jax_npz(checkpoint_path, cfg), **kwargs)

    def _chunks(self, n: int) -> Iterator[Tuple[int, int]]:
        for lo in range(0, n, self.batch_size):
            yield lo, min(lo + self.batch_size, n)

    @torch.inference_mode()
    def _probs(self, x, seq_lengths, supports):
        logits = self.model(x, seq_lengths, supports)
        if self.cfg.num_classes == 1:
            return torch.sigmoid(logits.reshape(-1))
        return torch.softmax(logits, dim=-1)

    def predict_proba(self, x: np.ndarray,
                      seq_lengths: Optional[np.ndarray] = None,
                      supports: Optional[np.ndarray] = None,
                      adjacency: Optional[np.ndarray] = None) -> np.ndarray:
        """Probabilities for featurized clips.

        Args:
            x: (n, T, N, D) featurized clips (any n — chunked internally).
            seq_lengths: (n,) true lengths; defaults to full T.
            supports: (S, n, N, N) precomputed supports; or
            adjacency: (n, N, N) per-clip adjacency — the supports are then
                built on the device (``graphs.compute_supports_torch``).

        Returns:
            (n,) seizure probabilities (detection) or (n, C) class
            probabilities (classification).
        """
        from eeg_gnn_tpu_torch.graphs.supports import compute_supports_torch

        if supports is None and adjacency is None:
            raise ValueError("supports required: pass `supports` or "
                             "`adjacency`")
        dev = self.device
        x = np.asarray(x, np.float32)
        n, t = x.shape[0], x.shape[1]
        if seq_lengths is None:
            seq_lengths = np.full((n,), t, np.int64)
        out = []
        for lo, hi in self._chunks(n):
            bs = self.batch_size
            xb = _tensor(_pad_to(x[lo:hi], bs), np.float32, dev)
            lb = _tensor(_pad_to(np.asarray(seq_lengths[lo:hi]), bs),
                         np.int64, dev)
            if supports is not None:
                sb = _tensor(_pad_to(np.asarray(supports[:, lo:hi]), bs,
                                     axis=1), np.float32, dev)
            else:
                ab = _tensor(_pad_to(np.asarray(adjacency[lo:hi]), bs),
                             np.float32, dev)
                sb = compute_supports_torch(ab, self.cfg.filter_type)
            probs = self._probs(xb, lb, sb)
            out.append(probs[:hi - lo].float().cpu().numpy())
        return np.concatenate(out) if out else np.empty((0,), np.float32)

    def predict_proba_raw(self, raw, seq_lengths=None):
        raise NotImplementedError(
            "the raw-EEG front door (DevicePipeline) is not ported yet "
            "(ROADMAP.md, Queue 1)")

    def predict(self, *args, **kwargs) -> Tuple[np.ndarray, np.ndarray]:
        """(predictions, probabilities); threshold applies to detection."""
        probs = self.predict_proba(*args, **kwargs)
        if self.cfg.num_classes == 1:
            return (probs > self.threshold).astype(np.int64), probs
        return probs.argmax(axis=-1), probs

    def stream(self, batches: Iterable[Dict[str, np.ndarray]]
               ) -> Iterator[np.ndarray]:
        """Probabilities over an iterable of feature dicts (keys as in
        :meth:`predict_proba`)."""
        for b in batches:
            yield self.predict_proba(
                b["x"], b.get("seq_lengths"), b.get("supports"),
                b.get("adjacency"))
