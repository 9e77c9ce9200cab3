"""Loss functions (``eeg_gnn_tpu/train/losses.py``).

Detection uses BCE-with-logits, classification softmax cross entropy
(reference train.py:203-206), SSL pre-training a masked regression loss on
inverse-standardized signals (reference utils.py:431-495,
train_ssl.py:165-170). Padded batches: every loss takes an optional
``valid``, either a row count (the pad is a contiguous tail) or a
(n_rows,) boolean row mask, and averages over the valid rows only, which
equals the unpadded computation; padded rows contribute exact zeros to
the loss and to every gradient.
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


def bce_with_logits(logits, targets, valid=None):
    """Mean binary cross-entropy on logits (torch BCEWithLogitsLoss
    semantics, in the JAX package's numerically stable form)."""
    logits = logits.reshape(-1)
    targets = targets.reshape(-1).to(logits.dtype)
    loss = (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))
    if valid is None:
        return loss.mean()
    mask = _row_mask(loss.shape[0], valid, loss.dtype, loss.device)
    return (loss * mask).sum() / mask.sum()


def cross_entropy(logits, targets, valid=None):
    """Mean softmax cross-entropy with integer targets (torch
    CrossEntropyLoss)."""
    logp = torch.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, targets.long()[:, None]).reshape(-1)
    if valid is None:
        return -picked.mean()
    mask = _row_mask(picked.shape[0], valid, picked.dtype, picked.device)
    return -(picked * mask).sum() / mask.sum()


def _masked(y_pred, y_true, mask_val, valid, err):
    """mean(err * m / mean(m)) over the entries where y_true != mask_val,
    nan-to-zero (reference utils.py:431-457); with ``valid``, the element
    mask is restricted to the valid rows and the mean is sum / sum(m),
    which is the unpadded value."""
    masks = (y_true != mask_val).to(y_pred.dtype)
    if valid is not None:
        rm = _row_mask(y_true.shape[0], valid, y_pred.dtype, y_pred.device)
        masks = masks * rm.reshape((-1,) + (1,) * (y_true.ndim - 1))
        loss = err(y_pred - y_true) * masks
        loss = torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)
        return loss.sum() / masks.sum()
    masks = masks / masks.mean()
    loss = err(y_pred - y_true) * masks
    loss = torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)
    return loss.mean()


def masked_mae_loss(y_pred, y_true, mask_val: float = 0.0, valid=None):
    """MAE over the entries where y_true != mask_val, normalized by the
    mask mean (reference ``utils.masked_mae_loss``)."""
    return _masked(y_pred, y_true, mask_val, valid, torch.abs)


def masked_mse_loss(y_pred, y_true, mask_val: float = 0.0, valid=None):
    """The reference's ``utils.masked_mse_loss``, which returns
    sqrt(mean(...)): an RMSE."""
    return torch.sqrt(_masked(y_pred, y_true, mask_val, valid,
                              torch.square))


def compute_regression_loss(y_true, y_predicted, mean=None, std=None,
                            loss_fn: str = "mae", mask_val: float = 0.0,
                            valid=None):
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
        return masked_mae_loss(y_predicted, y_true, mask_val, valid=valid)
    return masked_mse_loss(y_predicted, y_true, mask_val, valid=valid)
