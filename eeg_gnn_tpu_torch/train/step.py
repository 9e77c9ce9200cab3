"""The train steps (``eeg_gnn_tpu/train/step.py:33-154``).

One step is forward, loss (BCE for detection, CE for classification, the
masked regression loss for SSL pre-training, over the ``valid`` rows),
backward (the DCGRU encoder's and decoder's hand-written BPTT, on the card
the backward CUDA kernels), gradient clip, L2 + Adam and the cosine
learning rate. ``TrainStep(device=None)`` runs on the CUDA card and raises
without one, as ``Predictor`` does; the CPU only when asked for.

The eval step (``TrainStep.evaluate``) runs the same loss in eval mode
without autograd: the SSL loss is then the MAE.

With an ``input_pipeline`` (``data/device_pipeline.py``) a batch may
carry raw clips (``raw``, and ``raw_y`` for SSL), featurized on the
device, or rows of a dataset cache (``cache_x``, ``cache_y``, ``idx``;
``data/device_cache.py``), gathered on the device; either way the
pipeline's tail (augment, standardize, supports) runs before the model,
its draws from the step's generator.

The JAX package's multi-step and cached step programs (``lax.scan``
over K steps, to amortize a TPU dispatch) become plain loops over
``TrainStep`` here, with the numerics and launches of single steps
(``make_multi_train_step``, ``make_cached_train_step``,
``make_cached_epoch_step``); the trainer runs every cached plan through
``make_cached_epoch_step`` and ignores ``--fused_steps``. A cached step
takes no data from the host (the plan's permutation is on the device;
the losses stay there). The mesh variant raises (ROADMAP.md, Queue 1,
item 10).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.constants import FREQUENCY
from eeg_gnn_tpu_torch.device import resolve_device
from eeg_gnn_tpu_torch.train.losses import (
    bce_with_logits,
    compute_regression_loss,
    cross_entropy,
)
from eeg_gnn_tpu_torch.train.optim import make_optimizer


SSL_TASK = "SS pre-training"


def cached_batch(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor,
                 seq_len: int) -> Dict[str, Any]:
    """The train and eval steps' batch of the cached rows ``idx`` (a device
    index vector) of a split ``x`` / ``y`` held on the device: the cache
    rides along; the step gathers."""
    return {"cache_x": x, "cache_y": y, "idx": idx, "seq_len": int(seq_len)}


def _gather(cache: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return cache.index_select(0, idx)


def supervised_loss_fn(model: nn.Module, task: str, input_pipeline=None):
    """Loss of ``model`` on a device batch: ``loss_fn(batch, generator)
    -> (loss, logits)``; ``generator`` draws the pipeline's augmentation
    and the dropout mask.

    With ``input_pipeline``, a batch with ``raw`` clips is featurized on
    the device, and one with ``cache_x`` gathers its rows ``idx`` from the
    cached split, then runs the pipeline's tail. (The JAX package's
    ``cache_gather`` serves its mesh path, ROADMAP.md Queue 1 item 10.)"""
    if task == SSL_TASK:
        raise ValueError(f"task {task!r} trains through ssl_loss_fn, not "
                         "supervised_loss_fn")
    if task not in ("detection", "classification"):
        raise ValueError(f"unknown task {task!r}")

    def loss_fn(batch: Mapping[str, Any], generator=None):
        if input_pipeline is not None and batch.get("raw") is not None:
            x, supports = input_pipeline(batch["raw"], generator,
                                         model.training)
            batch = {**batch, "x": x.float(), "supports": supports}
        elif input_pipeline is not None and batch.get("cache_x") is not None:
            feats = _gather(batch["cache_x"], batch["idx"])
            x, supports = input_pipeline.features(feats, generator,
                                                  model.training)
            batch = {**batch, "x": x.float(), "supports": supports,
                     "y": _gather(batch["cache_y"], batch["idx"])}
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


def ssl_loss_fn(model: nn.Module, mean=None, std=None, input_pipeline=None):
    """Masked regression loss of the next-window predictions of ``model``
    (a ``DCRNNNextTimePred``) on inverse-standardized signals (reference
    train_ssl.py:163-170): ``loss_fn(batch, generator, batches_seen) ->
    (loss, preds)``. ``generator`` draws the pipeline's augmentation, the
    scheduled-sampling force vector and dropout masks; ``batches_seen``
    drives the curriculum. Training uses ``SSL_TRAIN_LOSS`` (an RMSE);
    eval mode uses ``'mae'``. ``input_pipeline``: as
    :func:`supervised_loss_fn`, for (``raw``, ``raw_y``) pairs or cached
    x/y feature pairs (one reflect and scale draw for both)."""

    def loss_fn(batch: Mapping[str, Any], generator=None,
                batches_seen=None):
        pair = None
        if input_pipeline is not None and batch.get("raw") is not None:
            pair = input_pipeline.ssl(batch["raw"], batch["raw_y"],
                                      generator, model.training)
        elif input_pipeline is not None and batch.get("cache_x") is not None:
            pair = input_pipeline.ssl_features(
                _gather(batch["cache_x"], batch["idx"]),
                _gather(batch["cache_y"], batch["idx"]), generator,
                model.training)
        if pair is not None:
            batch = {**batch, "x": pair[0].float(), "y": pair[1].float(),
                     "supports": pair[2]}
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
        input_pipeline: a ``DevicePipeline`` on ``device`` for raw and
            cached batches (below).

    A call takes a batch with the JAX package's keys, as numpy arrays or
    tensors, and for SSL pre-training an optional ``batches_seen`` (the
    curriculum's sample counter). Supervised: ``x`` (B, T, N, D), ``y``
    (B,), optional ``seq_lengths`` (B,) (full T by default). SSL: ``x``
    (B, T_in, N, D) and ``y`` (B, T_out, N, D). Both: ``supports`` (S, B,
    N, N) or ``adjacency`` (B, N, N), and optional ``valid`` (a row count
    or a (B,) row mask). With an ``input_pipeline``, instead of ``x`` and
    the supports: ``raw`` (B, C, L) clips (SSL: and ``raw_y``), or the
    rows ``idx`` (a device index vector) of a device-resident split
    ``cache_x`` / ``cache_y`` of constant length ``seq_len``
    (:func:`cached_batch`). It returns the loss as a 0-d
    device tensor (no host sync).
    """

    def __init__(self, cfg: ExperimentConfig, model: nn.Module,
                 steps_per_epoch: int, device=None,
                 generator: Optional[torch.Generator] = None,
                 mean=None, std=None, input_pipeline=None):
        self.cfg = cfg
        self.device = resolve_device(device, "TrainStep")
        self.model = model.to(self.device).train()
        self.ssl = cfg.task == SSL_TASK
        if self.ssl:
            stat = lambda v: None if v is None else _tensor(
                v, torch.float32, self.device)
            self.loss_fn = ssl_loss_fn(self.model, stat(mean), stat(std),
                                       input_pipeline=input_pipeline)
        else:
            self.loss_fn = supervised_loss_fn(self.model, cfg.task,
                                              input_pipeline=input_pipeline)
        self.input_pipeline = input_pipeline
        self.optimizer = make_optimizer(
            self.model.parameters(), cfg.lr_init, cfg.l2_wd,
            cfg.max_grad_norm, cfg.num_epochs, steps_per_epoch)
        self.generator = generator if generator is not None else \
            torch.Generator(device=self.device).manual_seed(0)

    def device_batch(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """The batch as device tensors, with supports built on the device
        from an ``adjacency`` (``graphs.compute_supports_torch``). Raw and
        cached batches go to the pipeline: raw clips are copied, cached
        rows stay where they are."""
        from eeg_gnn_tpu_torch.graphs.supports import compute_supports_torch

        dev = self.device
        if self.input_pipeline is not None and (
                batch.get("raw") is not None
                or batch.get("cache_x") is not None):
            return self._pipeline_batch(batch)
        x = _tensor(batch["x"], torch.float32, dev)
        y_dtype = torch.int64 if self.cfg.task == "classification" \
            else torch.float32
        out = {"x": x, "y": _tensor(batch["y"], y_dtype, dev),
               "valid": batch.get("valid")}
        if not self.ssl:
            out["seq_lengths"] = self._seq_lengths(
                batch.get("seq_lengths"), x.shape[0], x.shape[1])
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

    def _seq_lengths(self, lens, b: int, t: int) -> torch.Tensor:
        if lens is None:
            return torch.full((b,), t, dtype=torch.int64, device=self.device)
        return _tensor(lens, torch.int64, self.device)

    def _pipeline_batch(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """A raw or cached batch for the pipeline's loss branches (cached
        rows are the valid ones: no ``valid``)."""
        if batch.get("cache_x") is not None:
            out = dict(batch)
            if not self.ssl:
                out["seq_lengths"] = self._seq_lengths(
                    None, batch["idx"].shape[0], batch["seq_len"])
            return out
        valid = batch.get("valid")
        if isinstance(valid, (np.ndarray, torch.Tensor)):
            valid = _tensor(valid, None, self.device)
        raw = _tensor(batch["raw"], torch.float32, self.device)
        out = {"raw": raw, "valid": valid}
        if self.ssl:
            out["raw_y"] = _tensor(batch["raw_y"], torch.float32, self.device)
        else:
            y_dtype = torch.int64 if self.cfg.task == "classification" \
                else torch.float32
            out["y"] = _tensor(batch["y"], y_dtype, self.device)
            t = raw.shape[-1] // (self.input_pipeline.time_step_size
                                  * FREQUENCY)
            out["seq_lengths"] = self._seq_lengths(
                batch.get("seq_lengths"), raw.shape[0], t)
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


def make_multi_train_step(step: TrainStep):
    """K optimizer steps over K host batches (JAX ``train/step.py:157``):
    ``run(batches, batches_seen=None) -> losses (K,)`` on the device, K
    sequential calls of ``step``; with ``batches_seen`` (SSL's
    curriculum) each step gets the samples seen before it."""

    def run(batches, batches_seen=None):
        losses = []
        for b in batches:
            losses.append(step(b, batches_seen=batches_seen))
            if batches_seen is not None:
                batches_seen += len(b["raw"] if b.get("raw") is not None
                                    else b["x"])
        return torch.stack(losses)

    return run


def make_cached_train_step(step: TrainStep, seq_len: int, batch_size: int):
    """One optimizer step over a device-resident split (JAX
    ``train/step.py:214``), taking no data from the host: step ``counter``
    of a plan gathers the rows ``perm[counter*B : counter*B + valid]``
    (perm on the device, uploaded once a plan; the valid counts are the
    host's plan) and writes its loss into the device buffer.

    Returns ``run(x, y, perm, valid_vec, counter, seen, loss_buf) ->
    (counter + 1, seen + valid)``; ``seen`` is the samples seen before
    the step (SSL's curriculum)."""

    def run(x, y, perm, valid_vec, counter, seen, loss_buf):
        valid = int(valid_vec[counter])
        lo = counter * batch_size
        loss_buf[counter] = step(
            cached_batch(x, y, perm[lo:lo + valid], seq_len),
            batches_seen=seen)
        return counter + 1, seen + valid

    return run


def make_cached_epoch_step(step: TrainStep, seq_len: int, batch_size: int):
    """Every step of one plan over a device-resident split (JAX
    ``train/step.py:268``): :func:`make_cached_train_step` for each of
    its batches. Returns ``run(x, y, perm, valid_vec, seen) -> losses
    (K,)`` on the device."""
    one = make_cached_train_step(step, seq_len, batch_size)

    def run(x, y, perm, valid_vec, seen):
        losses = torch.zeros((len(valid_vec),), dtype=torch.float32,
                             device=step.device)
        counter = 0
        for _ in range(len(valid_vec)):
            counter, seen = one(x, y, perm, valid_vec, counter, seen, losses)
        return losses

    return run


def make_mesh_cached_train_step(*args, **kwargs):
    """Data-parallel cached step over row-sharded caches (JAX ``:345``)."""
    raise NotImplementedError(
        "the mesh-sharded cached train step is not ported yet (ROADMAP.md, "
        "Queue 1, item 10: scale-out)")
