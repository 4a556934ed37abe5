"""Scorers: the port of ``dask_ml_tpu/metrics/scorer.py`` (``make_scorer``,
``get_scorer``, ``check_scoring``, the passthrough scorer and the
reference's ``SCORERS``)."""

from __future__ import annotations

from functools import partial

from .classification import (
    accuracy_score, balanced_accuracy_score, f1_score, log_loss, precision_score, recall_score,
    roc_auc_score)
from .regression import mean_absolute_error, mean_squared_error, r2_score

__all__ = ["SCORERS", "check_scoring", "get_scorer", "make_scorer"]


def _passthrough_scorer(estimator, X, y=None, **kwargs):
    return estimator.score(X, y, **kwargs)


def make_scorer(score_func, greater_is_better: bool = True, **kwargs):
    """``scorer(estimator, X, y) = ±score_func(y, estimator.predict(X))``."""
    sign = 1.0 if greater_is_better else -1.0

    def scorer(estimator, X, y):
        return sign * score_func(y, estimator.predict(X), **kwargs)

    scorer._score_func = score_func
    scorer._sign = sign
    return scorer


def _neg_log_loss_scorer(estimator, X, y):
    return -log_loss(y, estimator.predict_proba(X))


def _roc_auc_scorer(estimator, X, y):
    """The AUC of ``decision_function`` where the estimator has one, else of
    the positive class's probability."""
    if hasattr(estimator, "decision_function"):
        s = estimator.decision_function(X)
    else:
        s = estimator.predict_proba(X)[:, 1]
    return roc_auc_score(y, s)


SCORERS = {
    "accuracy": make_scorer(accuracy_score),
    "f1": make_scorer(f1_score),
    "f1_macro": make_scorer(partial(f1_score, average="macro")),
    "f1_micro": make_scorer(partial(f1_score, average="micro")),
    "f1_weighted": make_scorer(partial(f1_score, average="weighted")),
    "precision": make_scorer(precision_score),
    "precision_macro": make_scorer(partial(precision_score, average="macro")),
    "recall": make_scorer(recall_score),
    "recall_macro": make_scorer(partial(recall_score, average="macro")),
    "roc_auc": _roc_auc_scorer,
    "balanced_accuracy": make_scorer(balanced_accuracy_score),
    "neg_mean_squared_error": make_scorer(mean_squared_error, greater_is_better=False),
    "neg_root_mean_squared_error": make_scorer(partial(mean_squared_error, squared=False),
                                               greater_is_better=False),
    "neg_mean_absolute_error": make_scorer(mean_absolute_error, greater_is_better=False),
    "r2": make_scorer(r2_score),
    "neg_log_loss": _neg_log_loss_scorer,
}


def get_scorer(scoring):
    """A scoring name or callable as a ``scorer(estimator, X, y)``."""
    if callable(scoring):
        return scoring
    if scoring in SCORERS:
        return SCORERS[scoring]
    raise ValueError(f"{scoring!r} is not a valid scoring value. Valid options: "
                     f"{sorted(SCORERS)}")


def check_scoring(estimator, scoring=None):
    """The estimator's own ``score`` when ``scoring`` is None, else
    :func:`get_scorer`'s."""
    if scoring is None:
        if hasattr(estimator, "score"):
            return _passthrough_scorer
        raise TypeError(f"{estimator!r} has no score method; pass scoring explicitly")
    return get_scorer(scoring)
