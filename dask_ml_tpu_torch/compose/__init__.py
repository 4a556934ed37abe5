"""Composition: a copy of scikit-learn's ``Pipeline`` and ``make_pipeline``,
which the reference's grid search takes from scikit-learn and the port
runs without."""

from ._pipeline import Pipeline, make_pipeline

__all__ = ["Pipeline", "make_pipeline"]
