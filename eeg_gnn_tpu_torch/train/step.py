"""The train steps (``eeg_gnn_tpu/train/step.py:33-154``).

One step is forward, loss (BCE for detection, CE for classification, the
masked regression loss for SSL pre-training, over the ``valid`` rows),
backward (the DCGRU encoder's and decoder's hand-written BPTT, on the card
the backward CUDA kernels), gradient clip, L2 + Adam and the cosine
learning rate. ``TrainStep(device=None)`` runs on the CUDA card and raises
without one, as ``Predictor`` does; the CPU only when asked for.

The eval step (``TrainStep.evaluate``) runs the same loss in eval mode
without autograd: the SSL loss is then the MAE.

Not ported yet (ROADMAP.md, Queue 1): the multi-step, cached and mesh
step variants and the on-device input pipeline; they raise.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.device import resolve_device
from eeg_gnn_tpu_torch.train.losses import (
    bce_with_logits,
    compute_regression_loss,
    cross_entropy,
)
from eeg_gnn_tpu_torch.train.optim import make_optimizer


SSL_TASK = "SS pre-training"


def supervised_loss_fn(model: nn.Module, task: str, input_pipeline=None,
                       cache_gather=None):
    """Loss of ``model`` on a device batch: ``loss_fn(batch, generator)
    -> (loss, logits)``; ``generator`` draws the dropout mask."""
    if input_pipeline is not None or cache_gather is not None:
        raise NotImplementedError(
            "the on-device input pipeline and dataset caches are not ported "
            "yet (ROADMAP.md, Queue 1)")
    if task == SSL_TASK:
        raise ValueError(f"task {task!r} trains through ssl_loss_fn, not "
                         "supervised_loss_fn")
    if task not in ("detection", "classification"):
        raise ValueError(f"unknown task {task!r}")

    def loss_fn(batch: Mapping[str, Any], generator=None):
        logits = model(batch["x"], batch["seq_lengths"], batch["supports"],
                       generator)
        valid = batch.get("valid")
        if task == "detection":
            return bce_with_logits(logits, batch["y"], valid), logits
        return cross_entropy(logits, batch["y"], valid), logits

    return loss_fn


# The reference trains with the literal 'MAE', which selects the RMSE branch
# of ``losses.compute_regression_loss`` (its case-sensitive dispatch quirk).
SSL_TRAIN_LOSS = "MAE"


def ssl_loss_fn(model: nn.Module, mean=None, std=None):
    """Masked regression loss of the next-window predictions of ``model``
    (a ``DCRNNNextTimePred``) on inverse-standardized signals (reference
    train_ssl.py:163-170): ``loss_fn(batch, generator, batches_seen) ->
    (loss, preds)``. ``generator`` draws the scheduled-sampling force
    vector and dropout masks; ``batches_seen`` drives the curriculum.
    Training uses ``SSL_TRAIN_LOSS`` (an RMSE); eval mode uses ``'mae'``.
    The on-device input pipeline and the dataset caches of the JAX version
    are not ported yet (ROADMAP.md, Queue 1)."""

    def loss_fn(batch: Mapping[str, Any], generator=None,
                batches_seen=None):
        preds = model(batch["x"], batch["y"], batch["supports"],
                      batches_seen=batches_seen, generator=generator)
        loss = compute_regression_loss(
            batch["y"], preds, mean=mean, std=std,
            loss_fn=SSL_TRAIN_LOSS if model.training else "mae",
            valid=batch.get("valid"))
        return loss, preds

    return loss_fn


def _tensor(v, dtype, device) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t.to(device=device, dtype=dtype)


class TrainStep:
    """The train step over ``model`` (an ``nn.Module`` whose parameters it
    updates in place).

    Args:
        cfg: experiment config: task, graph type (the filter of supports
            built from an ``adjacency``), ``lr_init``, ``l2_wd``,
            ``max_grad_norm``, ``num_epochs``.
        model: e.g. ``models.registry.build_model(cfg, generator)``; moved
            to ``device`` and put in training mode.
        steps_per_epoch: optimizer steps per epoch (the cosine schedule
            holds its value for an epoch).
        device: ``None`` (the CUDA card), or e.g. ``"cpu"``.
        generator: the ``torch.Generator`` on ``device`` of the dropout
            masks and the SSL force vectors (seed 0 when not given).
        mean, std: SSL pre-training: the scaler's statistics, which
            inverse-standardize predictions and targets before the loss
            (scalars or arrays that broadcast; None skips that).

    A call takes a batch with the JAX package's keys, as numpy arrays or
    tensors, and for SSL pre-training an optional ``batches_seen`` (the
    curriculum's sample counter). Supervised: ``x`` (B, T, N, D), ``y``
    (B,), optional ``seq_lengths`` (B,) (full T by default). SSL: ``x``
    (B, T_in, N, D) and ``y`` (B, T_out, N, D). Both: ``supports`` (S, B,
    N, N) or ``adjacency`` (B, N, N), and optional ``valid`` (a row count
    or a (B,) row mask). It returns the loss as a 0-d device tensor (no
    host sync).
    """

    def __init__(self, cfg: ExperimentConfig, model: nn.Module,
                 steps_per_epoch: int, device=None,
                 generator: Optional[torch.Generator] = None,
                 mean=None, std=None):
        self.cfg = cfg
        self.device = resolve_device(device, "TrainStep")
        self.model = model.to(self.device).train()
        self.ssl = cfg.task == SSL_TASK
        if self.ssl:
            stat = lambda v: None if v is None else _tensor(
                v, torch.float32, self.device)
            self.loss_fn = ssl_loss_fn(self.model, stat(mean), stat(std))
        else:
            self.loss_fn = supervised_loss_fn(self.model, cfg.task)
        self.optimizer = make_optimizer(
            self.model.parameters(), cfg.lr_init, cfg.l2_wd,
            cfg.max_grad_norm, cfg.num_epochs, steps_per_epoch)
        self.generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)

    def device_batch(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """The batch as device tensors, with supports built on the device
        from an ``adjacency`` (``graphs.compute_supports_torch``)."""
        from eeg_gnn_tpu_torch.graphs.supports import compute_supports_torch

        dev = self.device
        x = _tensor(batch["x"], torch.float32, dev)
        y_dtype = torch.int64 if self.cfg.task == "classification" \
            else torch.float32
        out = {"x": x, "y": _tensor(batch["y"], y_dtype, dev),
               "valid": batch.get("valid")}
        if not self.ssl:
            lens = batch.get("seq_lengths")
            out["seq_lengths"] = (
                torch.full((x.shape[0],), x.shape[1], dtype=torch.int64,
                           device=dev)
                if lens is None else _tensor(lens, torch.int64, dev))
        if isinstance(out["valid"], (np.ndarray, torch.Tensor)):
            out["valid"] = _tensor(out["valid"], None, dev)
        if batch.get("supports") is not None:
            out["supports"] = _tensor(batch["supports"], torch.float32, dev)
        elif batch.get("adjacency") is not None:
            out["supports"] = compute_supports_torch(
                _tensor(batch["adjacency"], torch.float32, dev),
                self.cfg.filter_type)
        else:
            raise ValueError("supports required: pass `supports` or "
                             "`adjacency`")
        return out

    def loss_and_grads(self, batch: Mapping[str, Any],
                       batches_seen=None) -> torch.Tensor:
        """Forward and backward: the parameters' ``.grad`` hold this
        batch's raw (unclipped) gradients afterwards."""
        self.optimizer.zero_grad()
        extra = {"batches_seen": batches_seen} if self.ssl else {}
        loss, _ = self.loss_fn(self.device_batch(batch), self.generator,
                               **extra)
        loss.backward()
        return loss.detach()

    def update(self):
        """Clip, L2 + Adam, learning-rate schedule, from ``.grad``."""
        self.optimizer.step()

    def __call__(self, batch: Mapping[str, Any],
                 batches_seen=None) -> torch.Tensor:
        loss = self.loss_and_grads(batch, batches_seen)
        self.update()
        return loss

    def evaluate(self, batch: Mapping[str, Any]):
        """The eval step (JAX ``make_eval_step``, train/step.py:400): (loss,
        outputs) on ``batch`` (keys as for a call) as device tensors,
        logits (B, C) or SSL predictions (B, T_out, N, D), with the model
        in eval mode (no dropout, no scheduled sampling; the SSL loss is
        the MAE) and no autograd; the model returns to training mode."""
        batch = self.device_batch(batch)
        self.model.eval()
        try:
            with torch.inference_mode():
                return self.loss_fn(batch)
        finally:
            self.model.train()


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                              "Queue 1: the cached and multi-step train "
                              "steps, scale-out)")


def make_multi_train_step(*args, **kwargs):
    """K optimizer steps in one program (JAX ``train/step.py:157``)."""
    _not_ported("the fused multi-step trainer")


def make_cached_train_step(*args, **kwargs):
    """Device-resident step over an HBM-cached split (JAX ``:214``)."""
    _not_ported("the cached train step")


def make_cached_epoch_step(*args, **kwargs):
    """K-step trainer over an HBM-cached split (JAX ``:268``)."""
    _not_ported("the cached epoch step")


def make_mesh_cached_train_step(*args, **kwargs):
    """Data-parallel cached step over row-sharded caches (JAX ``:345``)."""
    _not_ported("the mesh-sharded cached train step")
