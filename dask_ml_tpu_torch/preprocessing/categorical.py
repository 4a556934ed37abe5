"""DataFrame categorical transformers: the port of
``dask_ml_tpu/preprocessing/categorical.py`` (reference:
``dask_ml/preprocessing/data.py`` :: ``Categorizer``, ``DummyEncoder``).

They take pandas DataFrames only and stay on the host: category
inventories and dtypes live with the frame.  pandas is imported when one
of them is used, and its absence raises an ``ImportError`` that says so.
"""

from __future__ import annotations

import numpy as np

from ..base import TorchEstimator, TransformerMixin


def _pandas():
    try:
        import pandas as pd
    except ImportError as e:  # the port itself runs without pandas
        raise ImportError("Categorizer and DummyEncoder take pandas DataFrames, "
                          "and pandas is not installed") from e
    return pd


def _check_frame(X, caller: str):
    pd = _pandas()
    if not isinstance(X, pd.DataFrame):
        raise TypeError(f"{caller} expects a pandas DataFrame, got {type(X).__name__}")
    return pd, X


class Categorizer(TransformerMixin, TorchEstimator):
    """Convert object/string columns of a DataFrame to categorical dtype:
    ``fit`` records a ``CategoricalDtype`` a selected column
    (``categories_``), ``transform`` casts with them."""

    def __init__(self, categories=None, columns=None):
        self.categories = categories
        self.columns = columns

    def fit(self, X, y=None):
        pd, X = _check_frame(X, "Categorizer")
        if self.categories is not None:
            self.categories_ = dict(self.categories)
            self.columns_ = pd.Index(self.categories_)
            return self
        columns = pd.Index(self.columns) if self.columns is not None else X.columns
        categories = {}
        for c in columns:
            dt = X[c].dtype
            if isinstance(dt, pd.CategoricalDtype):
                categories[c] = dt
            elif dt == object or pd.api.types.is_string_dtype(dt):
                categories[c] = pd.CategoricalDtype(pd.unique(X[c].dropna()))
        self.categories_ = categories
        self.columns_ = pd.Index(categories)
        return self

    def transform(self, X, y=None):
        _, X = _check_frame(X, "Categorizer")
        X = X.copy()
        for c, dtype in self.categories_.items():
            X[c] = X[c].astype(dtype)
        return X


class DummyEncoder(TransformerMixin, TorchEstimator):
    """One-hot expand the categorical columns of a DataFrame (get_dummies);
    the columns must be categorical already (``Categorizer`` first).
    ``inverse_transform`` reassembles the frame."""

    def __init__(self, columns=None, drop_first=False):
        self.columns = columns
        self.drop_first = drop_first

    def fit(self, X, y=None):
        pd, X = _check_frame(X, "DummyEncoder")
        if self.columns is None:
            columns = X.columns[[isinstance(X[c].dtype, pd.CategoricalDtype) for c in X.columns]]
        else:
            columns = pd.Index(self.columns)
            for c in columns:
                if not isinstance(X[c].dtype, pd.CategoricalDtype):
                    raise ValueError(f"Column {c!r} is not categorical; run Categorizer first")
        self.columns_ = X.columns
        self.categorical_columns_ = columns
        self.non_categorical_columns_ = X.columns.difference(columns)
        self.dtypes_ = {c: X[c].dtype for c in columns}
        self.transformed_columns_ = pd.get_dummies(
            X.head(1), columns=list(columns), drop_first=self.drop_first).columns
        return self

    def transform(self, X, y=None):
        pd, X = _check_frame(X, "DummyEncoder")
        X = X.copy()
        for c in self.categorical_columns_:
            X[c] = X[c].astype(self.dtypes_[c])
        out = pd.get_dummies(X, columns=list(self.categorical_columns_),
                             drop_first=self.drop_first)
        return out.reindex(columns=self.transformed_columns_, fill_value=0)

    def inverse_transform(self, X):
        pd, X = _check_frame(X, "DummyEncoder")
        parts = {c: X[c] for c in self.non_categorical_columns_}
        for c in self.categorical_columns_:
            cats = list(self.dtypes_[c].categories)
            dummy_cols = [f"{c}_{cat}" for cat in cats]
            if self.drop_first:
                dummy_cols = dummy_cols[1:]
            block = X.reindex(columns=dummy_cols, fill_value=0).to_numpy()
            if self.drop_first:
                first = (block.sum(axis=1) == 0).astype(block.dtype)[:, None]
                block = np.concatenate([first, block], axis=1)
            parts[c] = pd.Categorical.from_codes(block.argmax(axis=1), dtype=self.dtypes_[c])
        return pd.DataFrame(parts, index=X.index).reindex(columns=self.columns_)
