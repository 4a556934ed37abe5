"""Scorers: the port of ``dask_ml_tpu/metrics/scorer.py`` (``make_scorer``,
``get_scorer``, ``check_scoring``, the passthrough scorer), for the names
whose metrics the port has: ``accuracy`` and ``r2``.  The reference's other
names raise ``NotImplementedError`` until their metrics are ported."""

from __future__ import annotations

from .classification import accuracy_score
from .regression import r2_score

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


SCORERS = {
    "accuracy": make_scorer(accuracy_score),
    "r2": make_scorer(r2_score),
}

#: the reference's other scorer names, whose metrics are not ported yet
_NOT_PORTED = ("f1", "f1_macro", "f1_micro", "f1_weighted", "precision", "precision_macro",
               "recall", "recall_macro", "roc_auc", "balanced_accuracy",
               "neg_mean_squared_error", "neg_root_mean_squared_error",
               "neg_mean_absolute_error", "neg_log_loss")


def get_scorer(scoring):
    """A scoring name or callable as a ``scorer(estimator, X, y)``."""
    if callable(scoring):
        return scoring
    if scoring in SCORERS:
        return SCORERS[scoring]
    if scoring in _NOT_PORTED:
        raise NotImplementedError(
            f"the {scoring!r} scorer is not ported yet (ROADMAP: [port-rest] metrics)")
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
