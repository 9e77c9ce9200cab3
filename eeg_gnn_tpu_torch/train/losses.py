"""Loss functions of the supervised tasks (``eeg_gnn_tpu/train/losses.py``).

Detection uses BCE-with-logits, classification softmax cross entropy
(reference train.py:203-206). Padded batches: every loss takes an optional
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
