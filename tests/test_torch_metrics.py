"""The port's numpy metrics (``eeg_gnn_tpu_torch/train/metrics.py``)
against the JAX package's, which call scikit-learn: ``eval_dict``
(accuracy, F1, precision, recall under 'binary' and 'weighted', ROC AUC)
and ``thresh_max_f1``, on hypothesis-drawn labels and scores with ties
and one-class cases, at atol 1e-12 (NaN where the JAX metric is NaN).
"""

import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from eeg_gnn_tpu.train import metrics as jm
from eeg_gnn_tpu_torch.train import metrics as tm

TOL = 1e-12
# hypothesis keeps no example database: the tests write no file

# scores on a coarse grid, so ties between clips are common
_scores = st.lists(st.integers(0, 8), min_size=1, max_size=40)


def _case(draw_labels, draw_scores):
    n = min(len(draw_labels), len(draw_scores))
    y = np.asarray(draw_labels[:n])
    prob = np.asarray(draw_scores[:n], np.float32) / 8
    return y, prob


def _close(got, want):
    if isinstance(want, float) and np.isnan(want):
        return np.isnan(got)
    return abs(got - want) <= TOL


def _jax(fn, *args, **kw):
    with warnings.catch_warnings():  # sklearn's undefined-metric warnings
        warnings.simplefilter("ignore")
        return fn(*args, **kw)


@settings(max_examples=300, deadline=None, database=None)
@given(st.lists(st.integers(0, 1), min_size=1, max_size=40), _scores,
       st.floats(0.0, 1.0))
def test_binary_eval_dict_matches_jax(labels, scores, thresh):
    y, prob = _case(labels, scores)
    pred = (prob > thresh).astype(int)
    got, got_p, got_t = tm.eval_dict(pred, y, prob, [str(i) for i in y],
                                     average="binary")
    want, want_p, want_t = _jax(jm.eval_dict, pred, y, prob,
                                [str(i) for i in y], average="binary")
    assert sorted(got) == sorted(want)
    for k in want:
        assert _close(got[k], float(want[k])), (k, got[k], want[k])
    assert got_p == want_p and got_t == want_t


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(st.integers(0, 3), min_size=1, max_size=40),
       st.lists(st.integers(0, 3), min_size=1, max_size=40))
def test_weighted_eval_dict_matches_jax(labels, preds):
    n = min(len(labels), len(preds))
    y, pred = np.asarray(labels[:n]), np.asarray(preds[:n])
    got, _, _ = tm.eval_dict(pred, y, average="weighted")
    want, _, _ = _jax(jm.eval_dict, pred, y, average="weighted")
    assert sorted(got) == sorted(want)
    for k in want:
        assert _close(got[k], float(want[k])), (k, got[k], want[k])


@settings(max_examples=300, deadline=None, database=None)
@given(st.lists(st.integers(0, 1), min_size=1, max_size=40), _scores)
def test_thresh_max_f1_matches_jax(labels, scores):
    y, prob = _case(labels, scores)
    assert tm.thresh_max_f1(y, prob) == _jax(jm.thresh_max_f1, y, prob)


@settings(max_examples=300, deadline=None, database=None)
@given(st.lists(st.integers(0, 1), min_size=1, max_size=60),
       st.lists(st.floats(0.0, 1.0, width=32), min_size=1, max_size=60))
def test_roc_auc_and_pr_curve_match_sklearn(labels, scores):
    from sklearn.metrics import precision_recall_curve, roc_auc_score

    n = min(len(labels), len(scores))
    y, prob = np.asarray(labels[:n]), np.asarray(scores[:n], np.float32)
    assert _close(tm.roc_auc(y, prob), float(_jax(roc_auc_score, y, prob)))
    got = tm.precision_recall_curve(y, prob)
    want = _jax(precision_recall_curve, y, prob)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


@pytest.mark.parametrize("y,prob", [
    ([0, 0, 0], [0.1, 0.2, 0.3]),          # no positive: AUROC NaN
    ([1, 1], [0.4, 0.4]),                  # no negative, one tie
    ([0, 1, 0, 1], [0.5, 0.5, 0.5, 0.5]),  # all scores tied
    ([1, 0, 1, 0, 1], [0.9, 0.9, 0.1, 0.1, 0.5]),
])
def test_edge_cases_match_jax(y, prob):
    y, prob = np.asarray(y), np.asarray(prob, np.float32)
    for thresh in (0.0, 0.5, 0.95):
        pred = (prob > thresh).astype(int)
        got, _, _ = tm.eval_dict(pred, y, prob, average="binary")
        want, _, _ = _jax(jm.eval_dict, pred, y, prob, average="binary")
        for k in want:
            assert _close(got[k], float(want[k])), (k, got[k], want[k])
    assert tm.thresh_max_f1(y, prob) == _jax(jm.thresh_max_f1, y, prob)


def test_binary_average_rejects_more_than_two_labels():
    with pytest.raises(ValueError):
        tm.eval_dict(np.array([0, 1, 2]), np.array([0, 1, 2]),
                     average="binary")
    with pytest.raises(NotImplementedError):
        tm.thresh_max_f1(np.array([0, 1, 2]), np.array([0.1, 0.2, 0.3]))


def test_average_meter_matches_jax():
    got, want = tm.AverageMeter(), jm.AverageMeter()
    for v, n in ((0.5, 3), (1.25, 7), (0.1, 1)):
        got.update(v, n)
        want.update(v, n)
    assert (got.avg, got.sum, got.count) == (want.avg, want.sum, want.count)
