"""Serving / batched inference: the fixed-shape ``Predictor``.

Semantics of ``eeg_gnn_tpu/serve.py``: inputs of any length are chunked
to one fixed batch shape, the last chunk zero-padded and its padding
dropped on the host; probabilities (sigmoid for detection, softmax for
classification) and, from an ``adjacency``, the supports are computed on
the device. With a ``DevicePipeline`` (``data/device_pipeline.py``),
``predict_proba_raw`` serves raw EEG: featurization, standardization and
the graph run on the device before the model, and ``predict_proba``
needs no supports for the combined graph.

It serves every registry model: DCRNN and the LSTM, CNN-LSTM and
Dense-CNN baselines, which keep the JAX contract (supports, an adjacency
or a pipeline are still required) and read no graph. Checkpoints load
from ``.npz`` files of either package, with a ``.state.npz`` beside them
where there is one (the Dense-CNN's BatchNorm running statistics), or
from the reference's ``.pth.tar`` files (``io/torch_import.py``).

Data-parallel (``mesh=``, ``parallel/``; JAX ``serve.py:88-103``): every
rank is called with the same inputs and runs its rows of each chunk on
its own device; the probabilities are gathered over the ranks, so every
rank returns the whole array. The batch must split evenly over the
ranks.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.constants import FREQUENCY
from eeg_gnn_tpu_torch.device import resolve_device

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


class Predictor:
    """Fixed-shape batched predictor over a registry model (DCRNN or a
    baseline, by ``cfg.model_name``).

    Args:
        cfg: experiment config (model, graph type, shapes, dtype,
            recurrence).
        params: the port's state_dict (see ``io/jax_params.py`` for JAX
            parameter trees and ``.npz`` files).
        batch_size: the batch shape every call runs at; defaults to
            ``cfg.test_batch_size``.
        threshold: decision threshold for detection.
        device: ``None`` (the CUDA card), or e.g. ``"cpu"``.
        pipeline: optional ``DevicePipeline`` on the same device, enabling
            :meth:`predict_proba_raw` and, for the combined graph,
            supports-free :meth:`predict_proba`.
        mesh: a ``parallel.Mesh``: data-parallel over its ranks (the
            module docstring); ``device`` defaults to the rank's.
    """

    def __init__(self, cfg: ExperimentConfig,
                 params: Mapping[str, torch.Tensor], *,
                 batch_size: Optional[int] = None, threshold: float = 0.5,
                 device=None, pipeline=None, mesh=None):
        from eeg_gnn_tpu_torch.models.registry import build_model

        if cfg.task not in ("detection", "classification"):
            raise ValueError(f"Predictor serves detection and "
                             f"classification, not {cfg.task!r}")
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device, "Predictor")
        self.model = build_model(cfg)
        self.model.load_state_dict(params)
        self.model.to(self.device).eval()
        self.batch_size = int(batch_size or cfg.test_batch_size)
        # this rank's rows of every chunk (all of them without a mesh)
        self.rows = (slice(0, self.batch_size) if mesh is None
                     else mesh.rows(self.batch_size))
        self.threshold = float(threshold)
        if pipeline is not None and \
                pipeline.device.type != self.device.type:
            raise ValueError(f"the pipeline lives on {pipeline.device}, the "
                             f"Predictor on {self.device}")
        self.pipeline = pipeline

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str,
                        cfg: Optional[ExperimentConfig] = None,
                        **kwargs) -> "Predictor":
        """A predictor straight from a checkpoint: a ``.npz`` of either
        package with its ``.state.npz`` where there is one, or a reference
        ``.pth.tar`` of the model of ``cfg.model_name`` (JAX
        ``load_params_for``, serve.py:34-66). Unlike the JAX predictor,
        which serves a Dense-CNN ``.npz`` with the initial running
        statistics and cannot read its ``.pth.tar``, the trained
        statistics are served."""
        cfg = cfg or ExperimentConfig().finalize()
        if checkpoint_path.endswith(_TORCH_SUFFIXES):
            from eeg_gnn_tpu_torch.io.torch_import import (
                import_params_for,
                load_torch_state_dict,
            )

            params = import_params_for(cfg,
                                       load_torch_state_dict(checkpoint_path))
            return cls(cfg, params, **kwargs)
        from eeg_gnn_tpu_torch.io.jax_params import load_jax_npz

        return cls(cfg, load_jax_npz(checkpoint_path, cfg), **kwargs)

    def _default_supports(self, batch: int) -> torch.Tensor:
        """The combined graph's distance supports broadcast over ``batch``
        clips (S, B, N, N), from the pipeline."""
        if self.pipeline is not None and \
                self.pipeline.dist_supports is not None:
            sup = self.pipeline.dist_supports  # (S, N, N)
            return sup[:, None].expand(sup.shape[0], batch, *sup.shape[1:])
        raise ValueError(
            "supports required: pass `supports`/`adjacency`, or construct "
            "the Predictor with a DevicePipeline (combined graph) so the "
            "distance-graph supports are available.")

    def _chunks(self, n: int) -> Iterator[Tuple[int, int]]:
        for lo in range(0, n, self.batch_size):
            yield lo, min(lo + self.batch_size, n)

    @torch.inference_mode()
    def _probs(self, x, seq_lengths, supports):
        """Probabilities of this rank's rows, gathered over the ranks
        under a mesh."""
        logits = self.model(x, seq_lengths, supports)
        if self.cfg.num_classes == 1:
            probs = torch.sigmoid(logits.reshape(-1))
        else:
            probs = torch.softmax(logits, dim=-1)
        if self.mesh is None:
            return probs
        from eeg_gnn_tpu_torch.parallel.distributed import all_gather_rows

        return all_gather_rows(probs, self.mesh)

    def predict_proba(self, x: np.ndarray,
                      seq_lengths: Optional[np.ndarray] = None,
                      supports: Optional[np.ndarray] = None,
                      adjacency: Optional[np.ndarray] = None) -> np.ndarray:
        """Probabilities for featurized clips.

        Args:
            x: (n, T, N, D) featurized clips (any n — chunked internally);
                the Dense-CNN also takes its dataset's flat (n, time, N)
                clips.
            seq_lengths: (n,) true lengths; defaults to full T.
            supports: (S, n, N, N) precomputed supports; or
            adjacency: (n, N, N) per-clip adjacency — the supports are then
                built on the device (``graphs.compute_supports_torch``);
                with neither, the pipeline's distance-graph supports.

        Returns:
            (n,) seizure probabilities (detection) or (n, C) class
            probabilities (classification).
        """
        from eeg_gnn_tpu_torch.graphs.supports import compute_supports_torch

        dev = self.device
        x = np.asarray(x, np.float32)
        n, t = x.shape[0], x.shape[1]
        if seq_lengths is None:
            seq_lengths = np.full((n,), t, np.int64)
        out = []
        for lo, hi in self._chunks(n):
            bs, r = self.batch_size, self.rows
            xb = _tensor(_pad_to(x[lo:hi], bs)[r], np.float32, dev)
            lb = _tensor(_pad_to(np.asarray(seq_lengths[lo:hi]), bs)[r],
                         np.int64, dev)
            if supports is not None:
                sb = _tensor(_pad_to(np.asarray(supports[:, lo:hi]), bs,
                                     axis=1)[:, r], np.float32, dev)
            elif adjacency is not None:
                ab = _tensor(_pad_to(np.asarray(adjacency[lo:hi]), bs)[r],
                             np.float32, dev)
                sb = compute_supports_torch(ab, self.cfg.filter_type)
            else:
                sb = self._default_supports(r.stop - r.start)
            probs = self._probs(xb, lb, sb)
            out.append(probs[:hi - lo].float().cpu().numpy())
        return np.concatenate(out) if out else np.empty((0,), np.float32)

    def predict_proba_raw(self, raw: np.ndarray,
                          seq_lengths: Optional[np.ndarray] = None
                          ) -> np.ndarray:
        """Probabilities straight from raw (n, C, L) signal windows, chunked
        and padded as :meth:`predict_proba`: each chunk's raw clips go to
        the device in one copy, then the pipeline's FFT featurization,
        standardization and graph/supports run there (no augmentation),
        then the model."""
        if self.pipeline is None:
            raise ValueError("predict_proba_raw needs a DevicePipeline — "
                             "construct the Predictor with `pipeline=`.")
        dev = self.device
        raw = np.asarray(raw, np.float32)
        n = raw.shape[0]
        t = raw.shape[-1] // (self.pipeline.time_step_size * FREQUENCY)
        if seq_lengths is None:
            seq_lengths = np.full((n,), t, np.int64)
        out = []
        for lo, hi in self._chunks(n):
            bs, r = self.batch_size, self.rows
            rb = _tensor(_pad_to(raw[lo:hi], bs)[r], np.float32, dev)
            lb = _tensor(_pad_to(np.asarray(seq_lengths[lo:hi]), bs)[r],
                         np.int64, dev)
            with torch.inference_mode():
                xb, sb = self.pipeline(rb)
            probs = self._probs(xb, lb, sb)
            out.append(probs[:hi - lo].float().cpu().numpy())
        return np.concatenate(out) if out else np.empty((0,), np.float32)

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
