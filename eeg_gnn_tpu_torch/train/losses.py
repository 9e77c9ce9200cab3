"""Loss functions (``eeg_gnn_tpu/train/losses.py``).

Detection uses BCE-with-logits, classification softmax cross entropy
(reference train.py:203-206), SSL pre-training a masked regression loss on
inverse-standardized signals (reference utils.py:431-495,
train_ssl.py:165-170). Padded batches: every loss takes an optional
``valid``, either a row count (the pad is a contiguous tail) or a
(n_rows,) boolean row mask, and averages over the valid rows only, which
equals the unpadded computation; padded rows contribute exact zeros to
the loss and to every gradient.

Data-parallel (``parallel/``): the JAX package takes each loss over the
global batch under ``jit``, so its mean runs over the global valid rows;
a per-rank mean averaged over the ranks would be another number whenever
the ranks hold different numbers of valid rows. So under a mesh each
loss returns this rank's SHARE of the global loss (the shares sum to it)
and the step sums the gradients over the ranks: BCE and cross entropy
divide this rank's masked sum by the global valid count ``total``; the
masked regression losses (a ratio, and the RMSE's square root) sum their
numerator and denominator over the ranks in the forward, through
autograd (``parallel.distributed.all_reduce_sum``), and the share is the
global value over the world size. A rank whose rows are all padding
contributes 0 and still joins the collective.
"""

from __future__ import annotations

import torch


def _row_mask(n_rows: int, valid, dtype, device):
    """(n_rows,) mask, 1.0 for valid rows: ``valid`` is a count or a
    (n_rows,) boolean mask."""
    valid = torch.as_tensor(valid, device=device)
    if valid.ndim == 1:
        return valid.to(dtype)
    return (torch.arange(n_rows, device=device) < valid).to(dtype)


def _mean(loss, valid, total):
    """The masked mean of per-row ``loss``; with ``total`` (under a mesh)
    this rank's share: its masked sum over the global valid count."""
    if total is not None:
        if valid is not None:
            loss = loss * _row_mask(loss.shape[0], valid, loss.dtype,
                                    loss.device)
        return loss.sum() / total
    if valid is None:
        return loss.mean()
    mask = _row_mask(loss.shape[0], valid, loss.dtype, loss.device)
    return (loss * mask).sum() / mask.sum()


def bce_with_logits(logits, targets, valid=None, total=None):
    """Mean binary cross-entropy on logits (torch BCEWithLogitsLoss
    semantics, in the JAX package's numerically stable form). ``total``:
    under a mesh, the global batch's valid rows; the result is then this
    rank's share."""
    logits = logits.reshape(-1)
    targets = targets.reshape(-1).to(logits.dtype)
    loss = (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))
    return _mean(loss, valid, total)


def cross_entropy(logits, targets, valid=None, total=None):
    """Mean softmax cross-entropy with integer targets (torch
    CrossEntropyLoss); ``total`` as :func:`bce_with_logits`."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, targets.long()[:, None]).reshape(-1)
    return -_mean(picked, valid, total)


def _masked(y_pred, y_true, mask_val, valid, err, mesh=None):
    """mean(err * m / mean(m)) over the entries where y_true != mask_val,
    nan-to-zero (reference utils.py:431-457); with ``valid``, the element
    mask is restricted to the valid rows and the mean is sum / sum(m),
    which is the unpadded value. Under ``mesh`` the two sums run over the
    ranks (in the forward, through autograd): the global value."""
    masks = (y_true != mask_val).to(y_pred.dtype)
    nan0 = lambda v: torch.where(torch.isnan(v), torch.zeros_like(v), v)
    if valid is None and mesh is None:
        masks = masks / masks.mean()
        return nan0(err(y_pred - y_true) * masks).mean()
    if valid is not None:
        rm = _row_mask(y_true.shape[0], valid, y_pred.dtype, y_pred.device)
        masks = masks * rm.reshape((-1,) + (1,) * (y_true.ndim - 1))
    sums = torch.stack([nan0(err(y_pred - y_true) * masks).sum(),
                        masks.sum()])
    if mesh is not None:
        from eeg_gnn_tpu_torch.parallel.distributed import all_reduce_sum

        sums = all_reduce_sum(sums, mesh)
    return sums[0] / sums[1]


def masked_mae_loss(y_pred, y_true, mask_val: float = 0.0, valid=None,
                    mesh=None):
    """MAE over the entries where y_true != mask_val, normalized by the
    mask mean (reference ``utils.masked_mae_loss``). Under ``mesh``, this
    rank's share of the global value."""
    mae = _masked(y_pred, y_true, mask_val, valid, torch.abs, mesh)
    return mae if mesh is None else mae / mesh.world


def masked_mse_loss(y_pred, y_true, mask_val: float = 0.0, valid=None,
                    mesh=None):
    """The reference's ``utils.masked_mse_loss``, which returns
    sqrt(mean(...)): an RMSE. Under ``mesh``, this rank's share of the
    global RMSE (it does not split into per-rank terms)."""
    rmse = torch.sqrt(_masked(y_pred, y_true, mask_val, valid,
                              torch.square, mesh))
    return rmse if mesh is None else rmse / mesh.world


def compute_regression_loss(y_true, y_predicted, mean=None, std=None,
                            loss_fn: str = "mae", mask_val: float = 0.0,
                            valid=None, mesh=None):
    """Masked regression loss on inverse-standardized signals (reference
    ``utils.compute_regression_loss``): both tensors become x*std + mean
    first. QUIRK kept: the dispatch is case-sensitive, so only ``'mae'``
    selects the MAE; the reference's training loop passes ``'MAE'``
    (train_ssl.py:167) and so trains on the RMSE branch, and evaluates
    with ``'mae'``."""
    if mean is not None:
        y_true = y_true * std + mean
        y_predicted = y_predicted * std + mean
    if loss_fn == "mae":
        return masked_mae_loss(y_predicted, y_true, mask_val, valid=valid,
                               mesh=mesh)
    return masked_mse_loss(y_predicted, y_true, mask_val, valid=valid,
                           mesh=mesh)
