"""Training/evaluation driver (``eeg_gnn_tpu/train/trainer.py``, its
streaming path): the equivalent of the reference's ``train.py`` /
``train_ssl.py`` flows for detection and seizure-type classification
(DCRNN and the LSTM, CNN-LSTM and Dense-CNN baselines) and SSL
pre-training.

Orchestration parity (train.py:30-194, train_ssl.py:24-284): model build,
warm-start / fine-tune transplant, epoch loop with per-epoch dev eval,
best/last checkpointing, dev-loss early stopping, cosine LR per epoch,
final dev+test eval with the dev-tuned decision threshold for detection.

The train step is ``train.TrainStep`` (on the card the DCGRU CUDA
kernels). Batches come from the host loaders (featurized clips, or raw
ones for the on-device pipeline with ``--device_pipeline``), or are
gathered on the device from a dataset cache (``--hbm_cache``: resident,
or rotating past the budget), whose epoch plans come from
``np.random.RandomState(cfg.rand_seed)`` as the JAX trainer's do; both
cache kinds hand the trainer an epoch as plans (``epoch_plans``: one
for a resident split, one a shard for a rotating one). ``--fused_steps``
is accepted and ignored: the JAX trainer fuses steps into one
``lax.scan`` program to amortize a TPU dispatch, which has no
counterpart here, and its numerics are those of single steps. Batches
run at their natural size: the JAX trainer pads a
partial batch to the fixed size by repeating row 0 and masks the loss by
the valid count (one XLA program); the kernels take any batch, and the
masked loss equals the unpadded one, so the port feeds the loader's
batch as it is. A step's loss stays on the device; the epoch's losses
reach the host in one copy at its end and go to ``metrics.jsonl`` with
the JAX trainer's values and ``step`` numbers (samples seen after the
step). Each epoch also writes its wall time, the train loop's time and
clips, and the time spent waiting on the loaders: the train loop's, and
the train and dev evaluation loops' together (``time/*`` scalars; a
cached split waits on no loader).

The fine-tune transplant reads the SSL checkpoint from a ``.npz`` of
either package or from a reference ``.pth.tar`` (``io/torch_import.py``).
A model with state (the Dense-CNN) checkpoints it in ``.state.npz``
files and reloads ``best.state.npz`` with ``best.npz``.

Still to port (ROADMAP.md, Queue 1): the mesh paths;
``ExperimentConfig.check_runnable`` rejects them.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from eeg_gnn_tpu_torch.config import ExperimentConfig
from eeg_gnn_tpu_torch.device import resolve_device
from eeg_gnn_tpu_torch.io.torch_import import (
    import_next_time_pred_params,
    load_torch_state_dict,
)
from eeg_gnn_tpu_torch.models.registry import build_model
from eeg_gnn_tpu_torch.train.checkpoint import (
    CheckpointSaver,
    build_finetune_params,
    load_params_like,
)
from eeg_gnn_tpu_torch.train.metrics import (
    AverageMeter,
    eval_dict,
    thresh_max_f1,
)
from eeg_gnn_tpu_torch.train.step import (
    SSL_TASK,
    TrainStep,
    cached_batch,
    make_cached_epoch_step,
)

_TORCH_SUFFIXES = (".pth.tar", ".pth", ".pt", ".tar")


def pad_batch(batch: Dict[str, np.ndarray], target: int
              ) -> Dict[str, np.ndarray]:
    """A host step batch of fewer than ``target`` rows padded to
    ``target`` by repeating row 0, with ``valid`` its true row count
    (JAX ``trainer._pad_batch``); a full batch as it is."""
    n = len(batch["x"])
    if n >= target:
        return batch
    out = dict(batch, valid=n)
    for k, axis in (("x", 0), ("y", 0), ("seq_lengths", 0),
                    ("supports", 1)):
        a = batch.get(k)
        if a is not None:
            first = np.take(a, [0], axis=axis)
            out[k] = np.concatenate(
                [a, np.repeat(first, target - n, axis=axis)], axis=axis)
    return out


class Trainer:
    """Drives training + evaluation of one task on ``model`` (a registry
    ``nn.Module``, trained in place on ``device``).

    ``input_pipeline`` (a ``DevicePipeline`` on ``device``): with
    ``cfg.device_pipeline`` the loaders yield raw clips, featurized in the
    step. ``device_caches``: {split: ``DeviceDatasetCache`` or
    ``RotatingDeviceCache``}; a cached split's batches are gathered on the
    device and its loader is not read.
    """

    def __init__(self, cfg: ExperimentConfig, loaders, scaler, log,
                 metrics_writer, model: torch.nn.Module, device=None,
                 input_pipeline=None, device_caches=None):
        self.cfg = cfg
        self.loaders = loaders
        self.log = log
        self.tbx = metrics_writer
        self.is_ssl = cfg.task == SSL_TASK
        self.device = resolve_device(device, "Trainer")
        if input_pipeline is not None and \
                input_pipeline.device.type != self.device.type:
            raise ValueError(f"the pipeline lives on {input_pipeline.device}"
                             f", the Trainer on {self.device}")
        self.device_caches = device_caches or {}
        # loader batches carry RAW clips only with --device_pipeline; with
        # --hbm_cache alone the pipeline serves the cached features
        self.raw_batches = input_pipeline is not None and cfg.raw_clips
        stats = {}
        if self.is_ssl and scaler is not None:
            stats = {"mean": scaler.mean, "std": scaler.std}
        self.step = TrainStep(
            cfg, model, steps_per_epoch=max(1, len(loaders["train"])),
            device=self.device,
            generator=torch.Generator(device=self.device).manual_seed(
                cfg.rand_seed),
            input_pipeline=input_pipeline, **stats)
        self.model = self.step.model
        # BatchNorm makes a train batch's composition part of the result
        self.pad_train = cfg.model_name == "densecnn" and not self.is_ssl
        train_cache = self.device_caches.get("train")
        if train_cache is not None:
            self.cached_epoch_step = make_cached_epoch_step(
                self.step, train_cache.seq_len, cfg.train_batch_size)
        self.loader_wait_s = 0.0  # the current epoch's, train and eval

    # -- batches -----------------------------------------------------------

    def _step_batch(self, batch) -> Dict[str, np.ndarray]:
        """A loader ``Batch`` as the train step's dict of host arrays."""
        if self.raw_batches:
            d = {"raw": batch.x, "seq_lengths": batch.seq_lengths}
            d["raw_y" if self.is_ssl else "y"] = batch.y
            return d
        return {"x": batch.x, "y": batch.y, "seq_lengths": batch.seq_lengths,
                "supports": batch.supports}

    def _batches(self, split: str):
        """The split's loader batches, adding the time spent waiting for
        each to ``self.loader_wait_s``."""
        batches = iter(self.loaders[split])
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            self.loader_wait_s += time.perf_counter() - t0
            if batch is None:
                return
            yield batch

    def _plan_to_device(self, perm: np.ndarray) -> torch.Tensor:
        """An epoch's (or shard's) row plan on the device, in one copy that
        does not make the host wait (pinned source on the card)."""
        t = torch.from_numpy(np.ascontiguousarray(perm, np.int64))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    # -- training ----------------------------------------------------------

    def _train_cached(self, cache, step: int, rng: np.random.RandomState):
        """One epoch over the device-resident train split, plan by plan (a
        rotating split's next shard copies while the current one trains):
        (valid counts, losses on the device)."""
        valid_parts, loss_parts = [], []
        for plan in cache.epoch_plans(self.cfg.train_batch_size, True, rng):
            loss_parts.append(self.cached_epoch_step(
                plan.x, plan.y, self._plan_to_device(plan.perm), plan.valid,
                step, plan.seq))
            step += int(plan.valid.sum())
            valid_parts.append(plan.valid)
        return np.concatenate(valid_parts), torch.cat(loss_parts)

    def _train_streaming(self, step: int):
        """One pass over the train loader: (sizes, losses on the
        device)."""
        sizes, losses = [], []
        for batch in self._batches("train"):
            d = self._step_batch(batch)
            if self.pad_train:
                d = pad_batch(d, self.cfg.train_batch_size)
            # SSL's curriculum reads the samples seen BEFORE this batch
            losses.append(self.step(d, batches_seen=step).reshape(1))
            step += len(batch)
            sizes.append(len(batch))
        return np.asarray(sizes, np.int64), losses

    def _train_epoch(self, step: int, cache_rng: np.random.RandomState):
        """One pass over the train split; returns (samples seen after it,
        train-loop seconds, clips)."""
        t0 = time.perf_counter()
        cache = self.device_caches.get("train")
        if cache is not None:
            sizes, losses = self._train_cached(cache, step, cache_rng)
            losses = [losses]
        else:
            sizes, losses = self._train_streaming(step)
        if losses:  # the epoch's one device-to-host copy of the losses
            host = torch.cat(losses).float().cpu().numpy()
            for s, loss in zip(step + np.cumsum(sizes), host):
                self.tbx.add_scalar("train/Loss", float(loss), int(s))
        step += int(np.sum(sizes))
        return step, time.perf_counter() - t0, int(np.sum(sizes))

    def train(self, save_dir: str) -> CheckpointSaver:
        cfg = self.cfg
        saver = CheckpointSaver(save_dir, cfg.metric_name,
                                cfg.maximize_metric, log=self.log)
        # the cached epochs' plans: the JAX trainer's RandomState
        cache_rng = np.random.RandomState(cfg.rand_seed)
        step = 0
        prev_val_loss = 1e10
        patience_count = 0
        early_stop = False
        epoch = 0
        while epoch != cfg.num_epochs and not early_stop:
            epoch += 1
            self.log.info(f"Starting epoch {epoch}...")
            t0 = time.perf_counter()
            self.loader_wait_s = 0.0
            step, train_s, clips = self._train_epoch(step, cache_rng)
            train_wait_s = self.loader_wait_s

            if epoch % cfg.eval_every == 0:
                eval_results = self.evaluate("dev")
                metric_val = eval_results.get(cfg.metric_name)
                saver.save(epoch, self.model.state_dict(),
                           self.step.optimizer, metric_val)

                if eval_results["loss"] < prev_val_loss:
                    patience_count = 0
                else:
                    patience_count += 1
                prev_val_loss = eval_results["loss"]
                if patience_count == cfg.patience:
                    early_stop = True

                self.log.info(
                    "Dev " + ", ".join(f"{k}: {v:.3f}" for k, v in
                                       eval_results.items()))
                for k, v in eval_results.items():
                    self.tbx.add_scalar(f"eval/{k}", v, step)
            epoch_s = time.perf_counter() - t0
            self.log.info(
                f"Epoch {epoch}: {clips} train clips in {train_s:.3f} s "
                f"({clips / max(train_s, 1e-9):.1f} clips/s, "
                f"{train_wait_s:.3f} s of it waiting on the loader); epoch "
                f"{epoch_s:.3f} s, {self.loader_wait_s:.3f} s of it waiting "
                "on the loaders")
            for tag, v in (("time/epoch_s", epoch_s),
                           ("time/train_s", train_s),
                           ("time/train_loader_wait_s", train_wait_s),
                           ("time/loader_wait_s", self.loader_wait_s),
                           ("time/train_clips", clips)):
                self.tbx.add_scalar(tag, v, step)
        return saver

    # -- evaluation --------------------------------------------------------

    def _eval_batches(self, split: str):
        """Yield (step batch, host labels or None, names) from the split's
        cache when there is one (resident or rotating: its unshuffled
        plans), else from its loader."""
        cache = self.device_caches.get(split)
        if cache is None:
            for batch in self._batches(split):
                yield self._step_batch(batch), batch.y, batch.names
            return
        bsz = self.cfg.test_batch_size
        for plan in cache.epoch_plans(bsz, False, np.random.RandomState(0)):
            perm_d = self._plan_to_device(plan.perm)
            for k, valid in enumerate(int(v) for v in plan.valid):
                idx = plan.perm[k * bsz:k * bsz + valid]
                yield (cached_batch(plan.x, plan.y,
                                    perm_d[k * bsz:k * bsz + valid],
                                    cache.seq_len, plan.seq),
                       None if plan.labels is None else plan.labels[idx],
                       [plan.names[i] for i in idx])

    def evaluate(self, split: str, is_test: bool = False,
                 best_thresh: float = 0.5) -> Dict[str, float]:
        cfg = self.cfg
        losses, outputs, sizes, y_true, names_all = [], [], [], [], []
        for batch, y_host, names in self._eval_batches(split):
            loss, out = self.step.evaluate(batch)
            losses.append(loss)
            sizes.append(len(names))
            if not self.is_ssl:
                outputs.append(out)
                y_true.append(np.asarray(y_host).reshape(-1).astype(int))
                names_all.extend(names)
        nll = AverageMeter()
        for loss, n in zip(torch.stack(losses).float().cpu().numpy(), sizes):
            nll.update(float(loss), n)
        if self.is_ssl:
            return {"loss": nll.avg}

        logits = torch.cat(outputs).float().cpu().numpy()
        y_true = np.concatenate(y_true)
        if cfg.num_classes == 1:
            y_prob = 1.0 / (1.0 + np.exp(-logits.reshape(-1)))
            if cfg.task == "detection" and split == "dev" and is_test:
                best_thresh = thresh_max_f1(y_true, y_prob)
            y_pred = (y_prob > best_thresh).astype(int)
        else:  # softmax over the classes, the most probable one
            e = np.exp(logits - logits.max(axis=1, keepdims=True))
            y_prob = e / e.sum(axis=1, keepdims=True)
            y_pred = y_prob.argmax(axis=1)

        scores, _, _ = eval_dict(
            y_pred=y_pred, y=y_true, y_prob=y_prob, file_names=names_all,
            average="binary" if cfg.task == "detection" else "weighted")
        results = {"loss": nll.avg, "acc": scores["acc"], "F1": scores["F1"],
                   "recall": scores["recall"], "precision": scores["precision"],
                   "best_thresh": best_thresh}
        if "auroc" in scores:
            results["auroc"] = scores["auroc"]
        return results


def warm_start(cfg: ExperimentConfig, params: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
    """The state dict a run starts from, given the model's ``params`` and
    ``cfg.load_model_path`` (train.py:128-151): with ``--fine_tune`` the
    SSL encoder-decoder of ``pretrained_num_rnn_layers`` layers, from a
    ``.npz`` of either package or a reference ``.pth.tar``, transplanted
    into ``params`` (``build_finetune_params``); else the checkpoint
    itself, in ``params``' layout (the model state, a Dense-CNN's
    running statistics, stays ``params``', as JAX's warm start keeps its
    initial state)."""
    if not cfg.fine_tune:
        return load_params_like(cfg.load_model_path, params)
    if cfg.model_name != "dcrnn":
        raise ValueError("--fine_tune transplants an SSL DCRNN encoder into "
                         f"a DCRNN, not into {cfg.model_name!r}")
    if cfg.load_model_path.endswith(_TORCH_SUFFIXES):
        pre = import_next_time_pred_params(
            load_torch_state_dict(cfg.load_model_path),
            cfg.pretrained_num_rnn_layers)
    else:
        pre_cfg = dataclasses.replace(
            cfg, task=SSL_TASK, num_rnn_layers=cfg.pretrained_num_rnn_layers)
        pre = load_params_like(cfg.load_model_path,
                               build_model(pre_cfg).state_dict())
    return build_finetune_params(params, pre, cfg.num_rnn_layers)


def run_experiment(cfg: ExperimentConfig, loaders, scaler, save_dir: str,
                   log, metrics_writer,
                   init_params: Optional[Mapping[str, torch.Tensor]] = None,
                   device=None, input_pipeline=None,
                   device_caches=None) -> Dict[str, float]:
    """Full main() flow of detection, classification and SSL
    pre-training; returns the final test results.

    ``init_params``: the model's starting state_dict (else drawn from a
    generator seeded by ``cfg.rand_seed``). ``device``: ``None`` (the CUDA
    card, raising without one) or e.g. ``"cpu"``. ``input_pipeline`` and
    ``device_caches``: see :class:`Trainer` (``cli/train.py`` builds
    them).
    """
    cfg.check_runnable()
    device = resolve_device(device, "run_experiment")
    if init_params is None:
        model = build_model(cfg, torch.Generator().manual_seed(cfg.rand_seed))
    else:
        model = build_model(cfg)
        model.load_state_dict(init_params)

    if cfg.load_model_path:
        model.load_state_dict(warm_start(cfg, model.state_dict()))

    trainer = Trainer(cfg, loaders, scaler, log, metrics_writer, model,
                      device=device, input_pipeline=input_pipeline,
                      device_caches=device_caches)

    if cfg.do_train:
        saver = trainer.train(save_dir)
        if os.path.exists(saver.best_path):
            trainer.model.load_state_dict(load_params_like(
                saver.best_path, trainer.model.state_dict(),
                with_state=True))

    if cfg.task == SSL_TASK:
        test = trainer.evaluate("test")
        log.info(f"Test set prediction MAE loss: {test['loss']:.3f}")
        return test

    dev = trainer.evaluate("dev", is_test=True)
    log.info("DEV set prediction results: "
             + ", ".join(f"{k}: {v:.3f}" for k, v in dev.items()))
    test = trainer.evaluate("test", is_test=True,
                            best_thresh=dev["best_thresh"])
    log.info("TEST set prediction results: "
             + ", ".join(f"{k}: {v:.3f}" for k, v in test.items()))
    return test
