"""The train steps (``eeg_gnn_tpu/train/step.py:33-154``).

One step is forward, loss (BCE for detection, CE for classification, the
masked regression loss for SSL pre-training, over the ``valid`` rows),
backward (the DCGRU encoder's and decoder's hand-written BPTT, on the card
the backward CUDA kernels; the baselines' through torch's autograd,
cuDNN and cuBLAS), gradient clip, L2 + Adam and the cosine learning rate.
A baseline's batch needs no supports: it reads no graph.
``TrainStep(device=None)`` runs on the CUDA card and raises
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
the losses stay there).

Data-parallel (``TrainStep(mesh=)``, ``parallel/``): each rank holds its
rows of every global batch and the replicated parameters. Its loss is
its share of the global loss (``train/losses.py``), every random draw is
made for the global batch and sliced (``parallel.mesh.global_draws``),
the backward ends in ONE all-reduce of the gradients (a flat buffer, the
loss's share riding in it), and then the clip, L2 and Adam run the same
on every rank, so the parameters stay bitwise equal across the ranks.
The Dense-CNN's BatchNorm takes the global batch's statistics
(``models/densecnn.GlobalBatchNorm1d``). The row-sharded cached step is
:func:`make_mesh_cached_train_step`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.constants import FREQUENCY
from eeg_gnn_tpu_torch.device import resolve_device
from eeg_gnn_tpu_torch.parallel import distributed
from eeg_gnn_tpu_torch.parallel.mesh import global_draws
from eeg_gnn_tpu_torch.train.losses import (
    bce_with_logits,
    compute_regression_loss,
    cross_entropy,
)
from eeg_gnn_tpu_torch.train.optim import make_optimizer
from eeg_gnn_tpu_torch.utils.profiling import span, timed


SSL_TASK = "SS pre-training"


def cached_batch(x: torch.Tensor, y: torch.Tensor, idx: torch.Tensor,
                 seq_len: int, seq: Optional[torch.Tensor] = None
                 ) -> Dict[str, Any]:
    """The train and eval steps' batch of the cached rows ``idx`` (a device
    index vector) of a split ``x`` / ``y`` held on the device: the cache
    rides along; the step gathers. ``seq``: the split's per-clip lengths
    on the device (classification's padded clips), else every clip is
    ``seq_len`` long."""
    return {"cache_x": x, "cache_y": y, "cache_seq": seq, "idx": idx,
            "seq_len": int(seq_len)}


def _gather(cache: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return cache.index_select(0, idx)


def local_cache_gather(mesh=None):
    """The gather of a row-sharded cache (JAX ``local_cache_gather``, a
    ``shard_map`` per device): each rank holds its own block of rows and
    its plan's LOCAL indices, so its gather is a plain ``index_select``
    on its own device, and the input path adds no collective."""
    return _gather


def supervised_loss_fn(model: nn.Module, task: str, input_pipeline=None,
                       mesh=None):
    """Loss of ``model`` on a device batch: ``loss_fn(batch, generator)
    -> (loss, logits)``; ``generator`` draws the pipeline's augmentation
    and the dropout mask.

    With ``input_pipeline``, a batch with ``raw`` clips is featurized on
    the device, and one with ``cache_x`` gathers its rows ``idx`` from the
    cached split, then runs the pipeline's tail: for classification's
    padded clips (``cache_seq``) it gathers their lengths too and runs
    ``classification_features`` (JAX ``train/step.py:64-71``).

    With ``mesh``, the loss is this rank's share of the global loss over
    the batch's ``global_valid`` rows (``train/losses.py``)."""
    if task == SSL_TASK:
        raise ValueError(f"task {task!r} trains through ssl_loss_fn, not "
                         "supervised_loss_fn")
    if task not in ("detection", "classification"):
        raise ValueError(f"unknown task {task!r}")

    def loss_fn(batch: Mapping[str, Any], generator=None):
        if input_pipeline is not None and batch.get("raw") is not None:
            with span("eeg.step.input"):
                x, supports = input_pipeline(batch["raw"], generator,
                                             model.training)
            batch = {**batch, "x": x.float(), "supports": supports}
        elif input_pipeline is not None and batch.get("cache_x") is not None:
            with span("eeg.step.input"):
                feats = _gather(batch["cache_x"], batch["idx"])
                y = _gather(batch["cache_y"], batch["idx"])
                if batch.get("cache_seq") is not None:
                    seq = _gather(batch["cache_seq"], batch["idx"])
                    x, supports = input_pipeline.classification_features(
                        feats, seq, generator, model.training)
                    batch = {**batch, "seq_lengths": seq}
                else:
                    x, supports = input_pipeline.features(feats, generator,
                                                          model.training)
                batch = {**batch, "x": x.float(), "supports": supports,
                         "y": y}
        with span("eeg.step.forward"):
            logits = model(batch["x"], batch["seq_lengths"],
                           batch["supports"], generator)
            valid = batch.get("valid")
            total = None if mesh is None else batch["global_valid"]
            if task == "detection":
                return bce_with_logits(logits, batch["y"], valid,
                                       total), logits
            return cross_entropy(logits, batch["y"], valid, total), logits

    return loss_fn


# The reference trains with the literal 'MAE', which selects the RMSE branch
# of ``losses.compute_regression_loss`` (its case-sensitive dispatch quirk).
SSL_TRAIN_LOSS = "MAE"


def ssl_loss_fn(model: nn.Module, mean=None, std=None, input_pipeline=None,
                mesh=None):
    """Masked regression loss of the next-window predictions of ``model``
    (a ``DCRNNNextTimePred``) on inverse-standardized signals (reference
    train_ssl.py:163-170): ``loss_fn(batch, generator, batches_seen) ->
    (loss, preds)``. ``generator`` draws the pipeline's augmentation, the
    scheduled-sampling force vector and dropout masks; ``batches_seen``
    drives the curriculum. Training uses ``SSL_TRAIN_LOSS`` (an RMSE);
    eval mode uses ``'mae'``. ``input_pipeline``: as
    :func:`supervised_loss_fn`, for (``raw``, ``raw_y``) pairs or cached
    x/y feature pairs (one reflect and scale draw for both). With
    ``mesh``, this rank's share of the global loss (its numerator and
    denominator summed over the ranks in the forward)."""

    def loss_fn(batch: Mapping[str, Any], generator=None,
                batches_seen=None):
        pair = None
        if input_pipeline is not None and batch.get("raw") is not None:
            with span("eeg.step.input"):
                pair = input_pipeline.ssl(batch["raw"], batch["raw_y"],
                                          generator, model.training)
        elif input_pipeline is not None and batch.get("cache_x") is not None:
            with span("eeg.step.input"):
                pair = input_pipeline.ssl_features(
                    _gather(batch["cache_x"], batch["idx"]),
                    _gather(batch["cache_y"], batch["idx"]), generator,
                    model.training)
        if pair is not None:
            batch = {**batch, "x": pair[0].float(), "y": pair[1].float(),
                     "supports": pair[2]}
        with span("eeg.step.forward"):
            preds = model(batch["x"], batch["y"], batch["supports"],
                          batches_seen=batches_seen, generator=generator)
            loss = compute_regression_loss(
                batch["y"], preds, mean=mean, std=std,
                loss_fn=SSL_TRAIN_LOSS if model.training else "mae",
                valid=batch.get("valid"), mesh=mesh)
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
            to ``device`` and put in training mode (a Dense-CNN's
            BatchNorm running statistics update in each step's forward).
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
        mesh: a ``parallel.Mesh``: data-parallel over its ranks (the
            module docstring); ``device`` defaults to the mesh's. The
            parameters and buffers start as rank 0's (one broadcast).

    A call takes a batch with the JAX package's keys, as numpy arrays or
    tensors, and for SSL pre-training an optional ``batches_seen`` (the
    curriculum's sample counter). Supervised: ``x`` (B, T, N, D), ``y``
    (B,), optional ``seq_lengths`` (B,) (full T by default). SSL: ``x``
    (B, T_in, N, D) and ``y`` (B, T_out, N, D); the Dense-CNN also takes
    flat (B, time, N) clips. Both: ``supports`` (S, B, N, N) or
    ``adjacency`` (B, N, N), which a baseline does not need and ignores,
    and optional ``valid`` (a row count or a (B,) row mask). With an
    ``input_pipeline``, instead of ``x`` and the supports: ``raw`` (B, C,
    L) clips (SSL: and ``raw_y``), or the rows ``idx`` (a device index
    vector) of a device-resident split ``cache_x`` / ``cache_y`` of
    constant length ``seq_len`` or of the per-clip lengths ``cache_seq``
    (:func:`cached_batch`). It returns the loss as a 0-d device tensor (no
    host sync).

    With a mesh, a batch is this rank's rows of the global batch (each
    rank the same number) and ``valid`` the GLOBAL valid count (the pad
    is the global batch's tail), or this rank's row mask with
    ``global_valid`` the global count beside it; ``batches_seen`` counts
    global rows. The returned loss is the global batch's.
    """

    @timed("eeg.setup.train_step")
    def __init__(self, cfg: ExperimentConfig, model: nn.Module,
                 steps_per_epoch: int, device=None,
                 generator: Optional[torch.Generator] = None,
                 mean=None, std=None, input_pipeline=None, mesh=None):
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            if device is not None and \
                    torch.device(device).type != mesh.device.type:
                raise ValueError(f"TrainStep on {device}, its mesh rank on "
                                 f"{mesh.device}")
            device = mesh.device
        self.device = resolve_device(device, "TrainStep")
        self.model = model.to(self.device).train()
        if mesh is not None:
            from eeg_gnn_tpu_torch.models.densecnn import global_batchnorm

            global_batchnorm(self.model, mesh)
            distributed.broadcast_(list(self.model.state_dict().values()),
                                   mesh)
        self.ssl = cfg.task == SSL_TASK
        self.reads_graph = self.ssl or cfg.model_name == "dcrnn"
        if self.ssl:
            stat = lambda v: None if v is None else _tensor(
                v, torch.float32, self.device)
            self.loss_fn = ssl_loss_fn(self.model, stat(mean), stat(std),
                                       input_pipeline=input_pipeline,
                                       mesh=mesh)
        else:
            self.loss_fn = supervised_loss_fn(self.model, cfg.task,
                                              input_pipeline=input_pipeline,
                                              mesh=mesh)
        self.input_pipeline = input_pipeline
        with timed("eeg.setup.optimizer"):
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
            return self._mesh_rows(self._pipeline_batch(batch))
        # the model's parameter dtype: float32 (a bf16 DCRNN computes in
        # bf16 inside), or float64 for a model cast to it
        dtype = next(self.model.parameters()).dtype
        x = _tensor(batch["x"], dtype, dev)
        y_dtype = torch.int64 if self.cfg.task == "classification" \
            else dtype
        out = {"x": x, "y": _tensor(batch["y"], y_dtype, dev),
               "valid": batch.get("valid")}
        if not self.ssl:
            out["seq_lengths"] = self._seq_lengths(
                batch.get("seq_lengths"), x.shape[0], x.shape[1])
        if isinstance(out["valid"], (np.ndarray, torch.Tensor)):
            out["valid"] = _tensor(out["valid"], None, dev)
        if not self.reads_graph:
            out["supports"] = None
        elif batch.get("supports") is not None:
            out["supports"] = _tensor(batch["supports"], torch.float32, dev)
        elif batch.get("adjacency") is not None:
            out["supports"] = compute_supports_torch(
                _tensor(batch["adjacency"], torch.float32, dev),
                self.cfg.filter_type)
        else:
            raise ValueError("supports required: pass `supports` or "
                             "`adjacency`")
        return self._mesh_rows(out)

    def _local_rows(self, batch: Mapping[str, Any]) -> int:
        for k in ("x", "raw", "idx"):
            if batch.get(k) is not None:
                return batch[k].shape[0]
        raise ValueError("a batch needs x, raw or idx")

    def _mesh_rows(self, out: Dict[str, Any]) -> Dict[str, Any]:
        """Under a mesh: ``valid`` as this rank's row mask and
        ``global_valid`` as the global batch's valid rows (a global count
        becomes the mask of this rank's rows of the global batch)."""
        if self.mesh is None:
            return out
        b = self._local_rows(out)
        valid = out.get("valid")
        if valid is None:
            return dict(out, global_valid=b * self.mesh.world)
        if isinstance(valid, torch.Tensor) and valid.ndim == 1:
            if out.get("global_valid") is None:
                raise ValueError("a row mask under a mesh needs "
                                 "global_valid beside it")
            return dict(out, valid=valid.to(self.device))
        count = int(valid)
        rows = self.mesh.rank * b + torch.arange(b, device=self.device)
        return dict(out, valid=rows < count, global_valid=count)

    def _seq_lengths(self, lens, b: int, t: int) -> torch.Tensor:
        if lens is None:
            return torch.full((b,), t, dtype=torch.int64, device=self.device)
        return _tensor(lens, torch.int64, self.device)

    def _pipeline_batch(self, batch: Mapping[str, Any]) -> Dict[str, Any]:
        """A raw or cached batch for the pipeline's loss branches (cached
        rows are the valid ones: no ``valid``, but under a mesh the plan's
        row mask)."""
        if batch.get("cache_x") is not None:
            out = dict(batch)
            if isinstance(out.get("valid"), np.ndarray):
                out["valid"] = _tensor(out["valid"], None, self.device)
            if not self.ssl and batch.get("cache_seq") is None:
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
        with span("eeg.step.zero_grad"):
            self.optimizer.zero_grad()
        extra = {"batches_seen": batches_seen} if self.ssl else {}
        batch = self.device_batch(batch)
        if self.mesh is None:
            loss, _ = self.loss_fn(batch, self.generator, **extra)
            with span("eeg.step.backward"):
                loss.backward()
            return loss.detach()
        b = self._local_rows(batch)
        with global_draws(self.mesh.rank * b, self.mesh.world * b):
            share, _ = self.loss_fn(batch, self.generator, **extra)
        with span("eeg.step.backward"):
            share.backward()
        # the one collective of the step: every gradient (a zero one where
        # the loss does not reach a parameter) and the loss's share
        params = list(self.model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        return distributed.all_reduce_grads([p.grad for p in params],
                                            self.mesh, extra=share)

    def update(self):
        """Clip, L2 + Adam, learning-rate schedule, from ``.grad``."""
        self.optimizer.step()

    def __call__(self, batch: Mapping[str, Any],
                 batches_seen=None) -> torch.Tensor:
        with span("eeg.step"):
            loss = self.loss_and_grads(batch, batches_seen)
            self.update()
            return loss

    def evaluate(self, batch: Mapping[str, Any]):
        """The eval step (JAX ``make_eval_step``, train/step.py:400): (loss,
        outputs) on ``batch`` (keys as for a call) as device tensors,
        logits (B, C) or SSL predictions (B, T_out, N, D), with the model
        in eval mode (no dropout, no scheduled sampling; the SSL loss is
        the MAE) and no autograd; the model returns to training mode.
        Under a mesh the outputs are this rank's rows and the loss the
        global batch's."""
        with span("eeg.eval"):
            batch = self.device_batch(batch)
            self.model.eval()
            try:
                with torch.inference_mode():
                    loss, out = self.loss_fn(batch)
                    if self.mesh is not None:
                        loss = distributed.all_reduce_sum(loss.reshape(1),
                                                          self.mesh)[0]
                    return loss, out
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

    Returns ``run(x, y, perm, valid_vec, counter, seen, loss_buf, seq=None)
    -> (counter + 1, seen + valid)``; ``seen`` is the samples seen before
    the step (SSL's curriculum); ``seq`` the split's per-clip lengths on
    the device (classification)."""

    def run(x, y, perm, valid_vec, counter, seen, loss_buf, seq=None):
        valid = int(valid_vec[counter])
        lo = counter * batch_size
        loss_buf[counter] = step(
            cached_batch(x, y, perm[lo:lo + valid], seq_len, seq),
            batches_seen=seen)
        return counter + 1, seen + valid

    return run


def make_cached_epoch_step(step: TrainStep, seq_len: int, batch_size: int):
    """Every step of one plan over a device-resident split (JAX
    ``train/step.py:268``): :func:`make_cached_train_step` for each of
    its batches. Returns ``run(x, y, perm, valid_vec, seen, seq=None) ->
    losses (K,)`` on the device."""
    one = make_cached_train_step(step, seq_len, batch_size)

    def run(x, y, perm, valid_vec, seen, seq=None):
        with span("eeg.plan"):
            losses = torch.zeros((len(valid_vec),), dtype=torch.float32,
                                 device=step.device)
            counter = 0
            for _ in range(len(valid_vec)):
                counter, seen = one(x, y, perm, valid_vec, counter, seen,
                                    losses, seq)
            return losses

    return run


def make_mesh_cached_train_step(step: TrainStep, seq_len: int,
                                batch_size: int):
    """One data-parallel optimizer step over a ROW-SHARDED device-resident
    split (JAX ``train/step.py:345``): each rank holds its block of the
    split (``data/device_cache.py``: ``shard_cache``, or ``mesh=`` of a
    ``build_*_cache``) and gathers its rows of each step from it, by the LOCAL
    indices of its columns of the plan (``mesh_epoch_plan``, placed with
    ``parallel.distributed.global_put(..., axis=1)``); the loss masks by
    the plan's row mask (per-rank padding is not a contiguous tail) over
    the global count of real rows, and the gradients are summed over the
    ranks as in the streaming step. ``step`` is a ``TrainStep`` with a
    mesh.

    Returns ``run(x, y, idx, mask, valid_vec, counter, seen, loss_buf,
    seq=None) -> (counter + 1, seen + valid_vec[counter])``: ``idx`` and
    ``mask`` (K, B / world) this rank's columns on the device,
    ``valid_vec`` (K,) the host's global real rows a step, ``seen`` the
    global samples seen before the step (SSL's curriculum)."""
    if step.mesh is None:
        raise ValueError("make_mesh_cached_train_step: the TrainStep has no "
                         "mesh (make_cached_train_step serves one device)")
    step.mesh.per_rank(batch_size)

    def run(x, y, idx, mask, valid_vec, counter, seen, loss_buf, seq=None):
        total = int(valid_vec[counter])
        batch = dict(cached_batch(x, y, idx[counter], seq_len, seq),
                     valid=mask[counter], global_valid=total)
        loss_buf[counter] = step(batch, batches_seen=seen)
        return counter + 1, seen + total

    return run


def shard_batch(batch: Mapping[str, Any], mesh,
                batch_axes: Optional[Dict[str, int]] = None
                ) -> Dict[str, Any]:
    """This rank's host rows of a batch on its device (JAX
    ``shard_batch``, where each process passes its host-local row slice):
    ``supports`` (S, B, N, N) by axis 1, everything else by axis 0
    (``batch_axes`` overrides); ``valid`` and scalars stay as they are,
    the same on every rank."""
    batch_axes = batch_axes or {}
    out = {}
    for k, v in batch.items():
        axis = batch_axes.get(k, 1 if k == "supports" else 0)
        if v is None or k == "valid" or np.ndim(v) <= axis:
            out[k] = v
        else:
            out[k] = distributed.form_global_array(v, mesh)
    return out
