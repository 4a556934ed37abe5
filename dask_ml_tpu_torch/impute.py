"""SimpleImputer: the port of ``dask_ml_tpu/impute.py``.

mean, median and constant are NaN-aware masked reductions on the device;
the median is exact (``preprocessing.data._nanquantile``: the average of
the two middle values of an even count, as ``jnp.nanmedian``, where
``torch.nanmedian`` takes the lower one).  most_frequent is a sort-based
mode a column.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import OneToOneFeatureMixin, TorchEstimator, TransformerMixin
from .core.sharded import ShardedRows
from .preprocessing.data import _ingest_float, _like_input, _masked_or_plain, _nanquantile

_STRATEGIES = ("mean", "median", "most_frequent", "constant")


def _column_modes(x):
    """Per-column mode ignoring NaN (the reference's ``_column_modes``):
    sort (NaN last), number the runs of equal values, count each run's
    non-NaN entries and take the first longest run, so of tied values the
    smallest wins and NaN never does.  An all-NaN column gives NaN."""
    s = torch.sort(x, dim=0).values
    new_run = torch.ones_like(s, dtype=torch.int64)
    new_run[1:] = (s[1:] != s[:-1]).to(torch.int64)
    run_id = torch.cumsum(new_run, dim=0) - 1
    counts = torch.zeros_like(run_id).scatter_add_(0, run_id, (~torch.isnan(s)).to(torch.int64))
    best = torch.argmax(counts, dim=0)  # the first of equal maxima
    first = torch.argmax((run_id == best[None, :]).to(torch.int8), dim=0)
    return torch.gather(s, 0, first[None, :])[0]


class SimpleImputer(OneToOneFeatureMixin, TransformerMixin, TorchEstimator):
    def __init__(self, missing_values=np.nan, strategy="mean",
                 fill_value=None, copy=True, add_indicator=False):
        self.missing_values = missing_values
        self.strategy = strategy
        self.fill_value = fill_value
        self.copy = copy
        self.add_indicator = add_indicator

    def _missing_is_nan(self) -> bool:
        return self.missing_values is np.nan or (
            isinstance(self.missing_values, float) and np.isnan(self.missing_values))

    def _is_missing(self, x):
        if self._missing_is_nan():
            return torch.isnan(x)
        return x == self.missing_values

    def _indicator_features(self, missing, mask):
        had = torch.any(missing & (mask[:, None] > 0), dim=0)
        return np.flatnonzero(had.cpu().numpy())

    def fit(self, X, y=None):
        if self.strategy not in _STRATEGIES:
            raise ValueError(f"strategy must be one of {_STRATEGIES}, got {self.strategy!r}")
        if self.strategy == "constant" and self.fill_value is None:
            raise ValueError("strategy='constant' requires fill_value")
        X = _ingest_float(self, X)
        x, mask = X.data, X.mask
        missing = self._is_missing(x)
        self.n_features_in_ = x.shape[1]
        if self.strategy == "constant":
            self.statistics_ = torch.full((x.shape[1],), float(self.fill_value), dtype=x.dtype,
                                          device=x.device)
        else:
            # NaN out both the missing entries and the padded rows
            xm = torch.where(missing | (mask[:, None] == 0), torch.full_like(x, float("nan")), x)
            if self.strategy == "mean":
                self.statistics_ = torch.nanmean(xm, dim=0)
            elif self.strategy == "median":
                self.statistics_ = _nanquantile(xm, [0.5])[0]
            else:
                self.statistics_ = _column_modes(xm)
            if bool(torch.any(torch.isnan(self.statistics_))):
                raise ValueError("One or more columns had no observed values to impute from")
        if self.add_indicator:
            self.indicator_features_ = self._indicator_features(missing, mask)
        return self

    def get_feature_names_out(self, input_features=None):
        """The input names, then ``missingindicator_<name>`` for each
        indicator column when ``add_indicator`` is on."""
        names = super().get_feature_names_out(input_features)
        if self.add_indicator and getattr(self, "indicator_features_", None) is not None:
            extra = [f"missingindicator_{names[i]}" for i in self.indicator_features_]
            names = np.concatenate([names, np.asarray(extra, dtype=object)])
        return names

    def transform(self, X):
        x, _ = _masked_or_plain(X)
        missing = self._is_missing(x)
        out = torch.where(missing, self.statistics_[None, :], x)
        feats = getattr(self, "indicator_features_", None)
        if self.add_indicator and feats is not None:
            ind = missing[:, torch.as_tensor(feats, device=x.device)].to(x.dtype)
            out = torch.cat([out, ind], dim=1)
        return _like_input(X, out)

    def inverse_transform(self, X):
        """``missing_values`` back where the indicator columns say a value
        was imputed; needs ``add_indicator=True``, and drops the indicator
        block."""
        if not self.add_indicator:
            raise ValueError("inverse_transform needs add_indicator=True: without the "
                             "indicator columns the imputed positions are unrecoverable")
        x, _ = _masked_or_plain(X)
        d = self.statistics_.shape[0]
        feats = np.asarray(getattr(self, "indicator_features_", np.arange(0)), dtype=int)
        expected = d + feats.size
        if x.shape[1] != expected:
            raise ValueError(
                f"X has {x.shape[1]} columns; inverse_transform expects {expected} ({d} "
                f"imputed features + {feats.size} indicator columns, in transform's output "
                f"layout)")
        vals, ind = x[:, :d], x[:, d:]
        missing = torch.zeros(vals.shape, dtype=torch.bool, device=x.device)
        if feats.size:
            missing[:, torch.as_tensor(feats, device=x.device)] = ind > 0.5
        fill = float("nan") if self._missing_is_nan() else float(self.missing_values)
        out = torch.where(missing, torch.full_like(vals, fill), vals)
        if isinstance(X, ShardedRows):  # the column count changed
            return ShardedRows(data=out, mask=X.mask, n_samples=X.n_samples)
        return out
