"""Optimizer: global-norm gradient clipping, then Adam with L2 weight decay,
then a cosine-annealed learning rate held for an epoch
(``eeg_gnn_tpu/train/optim.py``; reference train.py:222-224,273-274).

Order and coupling as the JAX package's optax chain:
``clip_by_global_norm`` -> ``add_decayed_weights`` -> ``scale_by_adam`` ->
``scale_by_learning_rate``. ``torch.optim.Adam(weight_decay=...)`` adds
``wd * p`` to the gradient before the moments, which is the same L2
coupling (not AdamW). The clip follows optax's rule, ``g / norm *
max_norm`` once ``norm >= max_norm``; ``torch.nn.utils.clip_grad_norm_``
would add 1e-6 to the norm. As in optax, every parameter steps: one the
loss does not reach (the Dense-CNN's never-called ``inception_5`` and
``inception_7``) gets a zero gradient, so its L2 decay still moves it,
where ``torch.optim.Adam`` alone would skip it.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch


def cosine_annealing_lr(lr_init: float, num_epochs: int,
                        steps_per_epoch: int):
    """torch CosineAnnealingLR(T_max=num_epochs) stepped once per epoch:
    lr(step) = lr_init * (1 + cos(pi * e / T_max)) / 2 with
    e = floor(step / steps_per_epoch); eta_min = 0."""

    def schedule(step: int) -> float:
        epoch = step // max(steps_per_epoch, 1)
        return lr_init * (1.0 + math.cos(math.pi * epoch / num_epochs)) / 2.0

    return schedule


def clip_by_global_norm_(grads, max_norm: float):
    """Scale ``grads`` in place by optax's rule; returns the global norm.
    Stays on the device (no host sync)."""
    grads = [g for g in grads if g is not None]
    if not grads:
        return None
    norm = torch.stack([g.float().square().sum() for g in grads]).sum().sqrt()
    clip = norm >= max_norm
    one = torch.ones_like(norm)
    div = torch.where(clip, norm, one)
    mul = torch.where(clip, torch.full_like(norm, max_norm), one)
    for g in grads:
        g.div_(div).mul_(mul)
    return norm


class Optimizer:
    """clip -> Adam(0.9, 0.999, eps 1e-8, L2 ``l2_wd``) -> per-step
    ``LambdaLR`` holding the cosine value for an epoch.

    ``step()`` uses the gradients in the parameters' ``.grad``; step i
    (from 0) runs at ``cosine_annealing_lr(lr_init, ...)(i)``, as optax's
    schedule reads its update count.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], lr_init: float,
                 l2_wd: float, max_grad_norm: float, num_epochs: int,
                 steps_per_epoch: int):
        self.params = list(params)
        self.max_grad_norm = max_grad_norm
        self.adam = torch.optim.Adam(self.params, lr=lr_init,
                                     betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=l2_wd)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.adam, cosine_annealing_lr(1.0, num_epochs, steps_per_epoch))

    @property
    def lr(self) -> float:
        """The learning rate of the next step."""
        return self.adam.param_groups[0]["lr"]

    def zero_grad(self):
        self.adam.zero_grad(set_to_none=True)

    def step(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm_([p.grad for p in self.params],
                             self.max_grad_norm)
        self.adam.step()
        self.scheduler.step()


def make_optimizer(params, lr_init: float, l2_wd: float,
                   max_grad_norm: float, num_epochs: int,
                   steps_per_epoch: int) -> Optimizer:
    """The reference training recipe over ``params`` (the JAX package's
    ``make_optimizer``; its flat-vector fusion is a TPU dispatch trick
    with no counterpart here)."""
    return Optimizer(params, lr_init, l2_wd, max_grad_norm, num_epochs,
                     steps_per_epoch)
