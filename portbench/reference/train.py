"""The published training step, in plain PyTorch: the loss of a batch,
its gradients by autograd, the global-norm clip (optax's rule: scale by
max_norm / norm once norm >= max_norm), L2 decay added to the gradient,
Adam (0.9, 0.999, eps 1e-8, bias-corrected) and the cosine learning rate
held for an epoch.

:func:`train_readings` follows the first steps of a run and returns what
the benchmark compares: each step's loss, each leaf's first gradient as
Adam receives it, and each leaf's change after the steps.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import dcrnn


def cosine_lr(lr_init: float, num_epochs: int, steps_per_epoch: int,
              step: int) -> float:
    epoch = step // max(steps_per_epoch, 1)
    return lr_init * (1.0 + math.cos(math.pi * epoch / num_epochs)) / 2.0


def sampling_ratio(cl_decay_steps: int, seen: int) -> float:
    """The scheduled-sampling probability of feeding the truth back."""
    return cl_decay_steps / (cl_decay_steps + math.exp(seen / cl_decay_steps))


def batch_loss(cfg: dict, params: dict, sup, batch: dict,
               precision: str) -> torch.Tensor:
    layers, k = cfg["num_rnn_layers"], cfg["max_diffusion_step"]
    if cfg["task"] == "SS pre-training":
        pred = dcrnn.ssl_predictions(params, sup, batch["x"], batch["y"],
                                     batch["force"], layers, k, precision)
        return dcrnn.masked_rmse(pred, batch["y"], cfg["feature_mean"],
                                 cfg["feature_std"])
    logits = dcrnn.detector_logits(params, sup, batch["x"], layers, k,
                                   precision)
    return dcrnn.bce(logits, batch["y"])


def train_readings(cfg: dict, params0: dict, sup, batches: list,
                   steps_per_epoch: int, precision: str = "f32") -> dict:
    """Follow ``len(batches)`` steps from ``params0`` (name -> tensor; not
    modified). Each batch holds standardized ``x``, ``y`` (labels, or the
    standardized next windows) and, for SSL, the step's ``force`` vector.

    Returns {"loss": [per step], "grad1": {leaf: norm of the first
    gradient after clip and L2}, "change": {leaf: norm of the change after
    the steps}, "grad1_raw": {leaf: norm of the first raw gradient}}."""
    names = list(params0)
    p = {n: params0[n].detach().clone().requires_grad_(True) for n in names}
    m = {n: torch.zeros_like(v) for n, v in p.items()}
    v = {n: torch.zeros_like(t) for n, t in p.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    out = {"loss": [], "grad1": {}, "grad1_raw": {}, "change": {}}
    for i, batch in enumerate(batches):
        loss = batch_loss(cfg, p, sup, batch, precision)
        grads = torch.autograd.grad(loss, [p[n] for n in names])
        out["loss"].append(float(loss.detach()))
        if i == 0:
            out["grad1_raw"] = {n: float(g.norm()) for n, g in
                                zip(names, grads)}
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        scale = (cfg["max_grad_norm"] / norm if norm >= cfg["max_grad_norm"]
                 else torch.ones_like(norm))
        lr = cosine_lr(cfg["lr_init"], cfg["num_epochs"], steps_per_epoch, i)
        with torch.no_grad():
            for n, g in zip(names, grads):
                g = g * scale + cfg["l2_wd"] * p[n]
                if i == 0:
                    out["grad1"][n] = float(g.norm())
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                c1, c2 = 1 - b1 ** (i + 1), 1 - b2 ** (i + 1)
                denom = (v[n].sqrt() / math.sqrt(c2)).add_(eps)
                p[n].addcdiv_(m[n], denom, value=-lr / c1)
    with torch.no_grad():
        out["change"] = {n: float((p[n] - params0[n]).norm()) for n in names}
    return out
