"""Evaluation metrics and dev-threshold search, in numpy
(``eeg_gnn_tpu/train/metrics.py``).

Parity: reference ``utils.eval_dict`` (utils.py:285-319) and
``utils.thresh_max_f1`` (utils.py:322-343). The reference and the JAX
package call scikit-learn; this module computes the same quantities with
scikit-learn's semantics and without it:

- accuracy; precision, recall and F1 per label (F1 = 2 tp / (true + pred
  count)), ``zero_division`` giving 0, under ``average="binary"``
  (positive label 1) or ``"weighted"`` (labels present in y or y_pred,
  weighted by their count in y);
- ROC AUC: the trapezoid under ``roc_curve`` (thresholds at distinct
  scores, collinear points dropped); NaN when y holds one class, as
  ``roc_auc_score`` returns (with a warning) in scikit-learn 1.9, where
  older versions raised;
- the precision-recall curve ``thresh_max_f1`` walks
  (``precision_recall_curve``: every distinct score a threshold, recall
  1 when y has no positive).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def _clf_curve(y_true, y_score):
    """(fps, tps, thresholds) at each distinct score, scores descending
    (scikit-learn ``confusion_matrix_at_thresholds``)."""
    y_true = np.asarray(y_true).reshape(-1) == 1
    y_score = np.asarray(y_score).reshape(-1)
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score = y_score[order]
    y_true = y_true[order].astype(np.float64)
    distinct = np.nonzero(np.diff(y_score))[0]
    idx = np.concatenate([distinct, [y_true.size - 1]])
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def roc_auc(y_true, y_score) -> float:
    """Area under the ROC curve (scikit-learn ``roc_auc_score``, binary)."""
    if len(np.unique(np.asarray(y_true))) != 2:
        return float("nan")
    fps, tps, _ = _clf_curve(y_true, y_score)
    if fps.shape[0] > 2:  # drop collinear points (roc_curve's default)
        keep = np.where(np.concatenate(
            [[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
             [True]]))[0]
        fps, tps = fps[keep], tps[keep]
    fpr = np.concatenate([[0.0], fps]) / fps[-1]
    tpr = np.concatenate([[0.0], tps]) / tps[-1]
    return float(np.trapezoid(tpr, fpr))


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds), recall decreasing (scikit-learn
    ``precision_recall_curve``)."""
    fps, tps, thresholds = _clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return (np.concatenate([precision[::-1], [1.0]]),
            np.concatenate([recall[::-1], [0.0]]), thresholds[::-1])


def _divide(num, den):
    """num / den per entry, 0 where den is 0 (``zero_division``)."""
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def _prf(y_true, y_pred, average: str):
    """(precision, recall, F1) under ``average`` 'binary' or 'weighted'."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    if average == "binary":
        present = np.union1d(y_true, y_pred)
        if len(present) > 2 or not np.all(np.isin(present, (0, 1))):
            raise ValueError(f"average='binary' needs 0/1 labels, got "
                             f"{present.tolist()}")
        labels = np.array([1])
    elif average == "weighted":
        labels = np.union1d(y_true, y_pred)
    else:
        raise ValueError(f"unsupported average {average!r}")
    tp = np.array([np.sum((y_true == k) & (y_pred == k)) for k in labels])
    pred = np.array([np.sum(y_pred == k) for k in labels])
    true = np.array([np.sum(y_true == k) for k in labels])
    precision = _divide(tp, pred)
    recall = _divide(tp, true)
    f1 = _divide(2 * tp, true + pred)
    if average == "binary":
        return float(precision[0]), float(recall[0]), float(f1[0])
    if true.sum() == 0:
        return 0.0, 0.0, 0.0
    return tuple(float(np.average(v, weights=true))
                 for v in (precision, recall, f1))


def eval_dict(y_pred, y, y_prob=None, file_names=None, average="macro"):
    """Accuracy / F1 / precision / recall (+AUROC for binary) score dict."""
    scores = {}
    pred_dict = defaultdict(list)
    true_dict = defaultdict(list)
    if file_names is not None:
        for idx, f_name in enumerate(file_names):
            pred_dict[f_name] = y_pred[idx]
            true_dict[f_name] = y[idx]
    if y is not None:
        y_arr = np.asarray(y).reshape(-1)
        y_pred_arr = np.asarray(y_pred).reshape(-1)
        scores["acc"] = float(np.mean(y_arr == y_pred_arr))
        precision, recall, f1 = _prf(y_arr, y_pred_arr, average)
        scores["F1"] = f1
        scores["precision"] = precision
        scores["recall"] = recall
        if (
            y_prob is not None
            and len(set(y_arr.tolist())) <= 2
            and np.asarray(y_prob).ndim == 1
        ):
            # binary case only; the reference reaches this branch solely
            # with 1-D detection probabilities (train.py:380,414-418)
            scores["auroc"] = roc_auc(y_arr, y_prob)
    return scores, pred_dict, true_dict


def thresh_max_f1(y_true, y_prob):
    """F1-maximizing decision threshold from the PR curve (binary only)."""
    if len(set(np.asarray(y_true).tolist())) > 2:
        raise NotImplementedError

    precision, recall, thresholds = precision_recall_curve(y_true, y_prob)
    fscore, thresh_filt = [], []
    for idx in range(len(thresholds)):
        denom = precision[idx] + recall[idx]
        curr_f1 = (2 * precision[idx] * recall[idx]) / denom if denom else np.nan
        if not np.isnan(curr_f1):
            fscore.append(curr_f1)
            thresh_filt.append(thresholds[idx])
    return thresh_filt[int(np.argmax(np.asarray(fscore)))]


class AverageMeter:
    """Running average (reference utils.py:178-202)."""

    def __init__(self):
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, num_samples=1):
        self.count += num_samples
        self.sum += val * num_samples
        self.avg = self.sum / self.count
