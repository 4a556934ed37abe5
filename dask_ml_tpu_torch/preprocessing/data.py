"""Scalers, the quantile transform, ``Normalizer`` and ``PolynomialFeatures``:
the port of ``dask_ml_tpu/preprocessing/data.py``, with its ingest and
transform-output helpers.

Each fit is a masked reduction over the padded rows.  Quantiles are exact
(a sort a column) up to ``DASK_ML_TPU_TORCH_EXACT_QUANTILE_MAX_ROWS`` rows
(4,000,000 by default) and past it the refining histogram sketch, whose
passes are K12 (``ops/histogram.py``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..base import OneToOneFeatureMixin, TorchEstimator, TransformerMixin
from ..core.sharded import ShardedRows, host_to_device, masked_mean, masked_var
from ..ops.histogram import BINS, hist_pass_counts
from ..utils import chan_merge, check_array, handle_zeros_in_scale

# elements a chunk of the column-wise interpolation
_CHUNK_ELEMS = 1 << 26


def _as_float(x):
    return x if x.is_floating_point() else x.to(torch.float32)


def _masked_or_plain(X):
    """(data, mask) for either a ShardedRows or a plain array.  A tensor
    stays on its own device; host input goes to the active device, float64
    as float32 (as ``shard_rows`` takes it)."""
    if isinstance(X, ShardedRows):
        return _as_float(X.data), X.mask
    if not isinstance(X, torch.Tensor):
        X = host_to_device(X)
    x = _as_float(X)
    return x, torch.ones(x.shape[0], dtype=torch.float32, device=x.device)


def _ingest_float(est, X) -> ShardedRows:
    """check_array + shard, casting integer input to float32."""
    X = check_array(X)
    if not isinstance(X, ShardedRows):
        X = est._ingest(X)
    if not X.data.is_floating_point():
        X = ShardedRows(data=X.data.to(torch.float32), mask=X.mask,
                        n_samples=X.n_samples)
    return X


def _like_input(X, out):
    """Wrap transform output like the input (sharded in, sharded out)."""
    if isinstance(X, ShardedRows):
        return ShardedRows(data=out, mask=X.mask, n_samples=X.n_samples)
    return out


def _is_frame(X) -> bool:
    """Whether ``X`` is a pandas DataFrame, asked without importing pandas."""
    return any(c.__name__ == "DataFrame" and c.__module__.startswith("pandas")
               for c in type(X).__mro__)


def _approx_rows_threshold() -> int:
    """Padded rows past which quantiles take the histogram sketch."""
    return int(os.environ.get("DASK_ML_TPU_TORCH_EXACT_QUANTILE_MAX_ROWS", 4_000_000))


def _sketch_pass(x, mask, lo_f, hi_f, targets, interior, has_interior):
    """One histogram over [lo_f, hi_f] of each feature (K12), and on the
    device: the per-prob interpolated values (d, p), the next window (the
    bins bracketing the interior quantiles, widened a bin each side) and
    the bin width."""
    width = torch.clamp_min(hi_f - lo_f, 1e-30)
    counts, below = hist_pass_counts(x, mask, lo_f, hi_f, width)
    cdf = torch.cumsum(counts, dim=1)  # (d, bins)
    t = (targets - below[None, :]).T.contiguous()  # (d, p) ranks in this window
    b = torch.clamp(torch.searchsorted(cdf, t), 0, BINS - 1)
    prev = torch.where(b > 0, torch.gather(cdf, 1, torch.clamp_min(b - 1, 0)),
                       torch.zeros_like(t))
    cnt = torch.clamp_min(torch.gather(cdf, 1, b) - prev, 1e-30)
    frac = torch.clamp((t - prev) / cnt, 0.0, 1.0)
    binw = width / BINS
    vals = lo_f[:, None] + (b.to(x.dtype) + frac) * binw[:, None]
    bmin = torch.where(interior[None, :], b, torch.full_like(b, BINS - 1)).amin(dim=1)
    bmax = torch.where(interior[None, :], b, torch.zeros_like(b)).amax(dim=1)
    nlo = torch.where(has_interior, lo_f + (bmin.to(x.dtype) - 1.0) * binw, lo_f)
    nhi = torch.where(has_interior, lo_f + (bmax.to(x.dtype) + 2.0) * binw, lo_f + width)
    return vals.T, nlo, nhi, binw


def _hist_quantiles(x, mask, probs, *, refinements=3, with_width=False):
    """Approximate per-feature quantiles (p, d) by the reference's refining
    histogram sketch: the masked min/max, then ``1 + refinements`` K12
    passes of 4096 bins, each focused on the bins that bracket the interior
    quantiles of the last.  Everything between passes stays on the device:
    no host read.  Interior values are clipped to the data's range; p = 0
    and p = 1 are the exact masked min and max.  ``with_width`` also
    returns the last pass's bin width (d,)."""
    valid = mask[:, None] > 0
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    lo = torch.where(valid, x, inf).amin(dim=0)
    hi = torch.where(valid, x, -inf).amax(dim=0)
    probs = torch.as_tensor(probs, dtype=x.dtype).to(x.device)
    targets = probs[:, None] * torch.sum(mask).to(x.dtype)  # (p, 1), broadcast over d
    interior = (probs > 0.0) & (probs < 1.0)
    has_interior = torch.any(interior)
    vals, lo_r, hi_r, binw = _sketch_pass(x, mask, lo, hi, targets, interior, has_interior)
    for _ in range(refinements):
        vals, lo_r, hi_r, binw = _sketch_pass(x, mask, lo_r, hi_r, targets, interior,
                                              has_interior)
    vals = torch.minimum(torch.maximum(vals, lo[None, :]), hi[None, :])
    ends = torch.where((probs <= 0.0)[:, None], lo[None, :], hi[None, :])
    vals = torch.where(interior[:, None], vals, ends)
    return (vals, binw) if with_width else vals


def _nanquantile(a, probs):
    """Per-column quantiles (p, d) of ``a`` (n, d) ignoring NaN, as
    ``jnp.nanquantile``'s linear method: a sort down the rows (NaN last),
    the valid count a column, then low·(1 − w) + high·w at q·(count − 1).
    It has no row limit (``torch.nanquantile`` refuses more than 2^24)."""
    q = torch.as_tensor(probs, dtype=a.dtype).to(a.device)
    s = torch.sort(a, dim=0).values
    counts = torch.sum(~torch.isnan(s), dim=0).to(q.dtype)  # (d,)
    pos = q[:, None] * (counts[None, :] - 1.0)  # (p, d)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    top = counts[None, :] - 1.0
    low = torch.clamp_min(torch.minimum(low, top), 0.0).to(torch.int64)
    high = torch.clamp_min(torch.minimum(high, top), 0.0).to(torch.int64)
    return torch.gather(s, 0, low) * low_w + torch.gather(s, 0, high) * high_w


def _masked_quantiles(x, mask, probs, method: str = "auto"):
    """Per-feature quantiles (p, d) ignoring padded rows: exact up to the
    row threshold (or with ``method="exact"``), the histogram sketch past
    it."""
    if method == "exact" or (method == "auto" and x.shape[0] <= _approx_rows_threshold()):
        xm = torch.where(mask[:, None] > 0, x, torch.full_like(x, float("nan")))
        return _nanquantile(xm, probs)
    return _hist_quantiles(x, mask, probs)


def _linspace01(n: int):
    """``jnp.linspace(0, 1, n)``'s float32 values: i · (1 / (n − 1)), the
    reciprocal rounded to float32 first (as XLA compiles the division by a
    constant), then 1."""
    if n <= 1:
        return torch.zeros(n, dtype=torch.float32)
    step = torch.tensor(np.float32(1.0) / np.float32(n - 1))
    return torch.cat([torch.arange(n - 1, dtype=torch.float32) * step,
                      torch.ones(1, dtype=torch.float32)])


def _interp_cols(x, xp, fp):
    """``jnp.interp`` down each column: ``x`` (n, c), the sorted references
    ``xp`` and the values ``fp`` (m, c).  searchsorted on the right,
    clipped to [1, m − 1]; where |dx| <= spacing(eps) the left value; fp[0]
    left of xp[0] and fp[−1] right of xp[−1].  So a value equal to a run of
    tied references maps to the last of the run."""
    m = xp.shape[0]
    xT, xpT, fpT = x.T.contiguous(), xp.T.contiguous(), fp.T.contiguous()
    if m == 1:
        return fpT[:, :1].expand_as(xT).T
    i = torch.clamp(torch.searchsorted(xpT, xT, right=True), 1, m - 1)
    xp_lo, fp_lo = torch.gather(xpT, 1, i - 1), torch.gather(fpT, 1, i - 1)
    dx = torch.gather(xpT, 1, i) - xp_lo
    df = torch.gather(fpT, 1, i) - fp_lo
    delta = xT - xp_lo
    eps = torch.finfo(x.dtype).eps ** 2  # spacing(eps): eps is a power of 2
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp_lo, fp_lo + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df)
    f = torch.where(xT < xpT[:, :1], fpT[:, :1], f)
    f = torch.where(xT > xpT[:, -1:], fpT[:, -1:], f)
    return f.T


class StandardScaler(OneToOneFeatureMixin, TransformerMixin, TorchEstimator):
    """Standardize features to zero mean, unit variance."""

    def __init__(self, copy=True, with_mean=True, with_std=True):
        self.copy = copy
        self.with_mean = with_mean
        self.with_std = with_std

    def fit(self, X, y=None):
        for a in ("_pf_mean", "_pf_m2", "n_samples_seen_"):
            if hasattr(self, a):
                delattr(self, a)
        return self.partial_fit(X, y)

    def partial_fit(self, X, y=None):
        """Incremental fit over row blocks: the Chan merge of per-feature
        (mean, M2) moments, weighted by the exact integer
        ``n_samples_seen_``, so ``fit`` and a ``partial_fit`` stream over
        its blocks give the same statistics."""
        X = _ingest_float(self, X)
        data, mask = X.data, X.mask
        nb = int(X.n_samples)
        mb = masked_mean(data, mask)
        vb = masked_var(data, mask)
        if not hasattr(self, "_pf_mean"):
            self._pf_mean, self._pf_m2 = mb, vb * nb
            self.n_samples_seen_ = nb
        else:
            _n, self._pf_mean, self._pf_m2 = chan_merge(
                float(self.n_samples_seen_), self._pf_mean, self._pf_m2, float(nb), mb, vb)
            self.n_samples_seen_ += nb
        self.mean_ = self._pf_mean if self.with_mean else None
        if self.with_std:
            var = self._pf_m2 / max(self.n_samples_seen_, 1)
            self.var_ = var
            self.scale_ = handle_zeros_in_scale(torch.sqrt(var))
        else:
            self.var_ = None
            self.scale_ = None
        self.n_features_in_ = data.shape[1]
        return self

    def transform(self, X, y=None, copy=None):
        x, _ = _masked_or_plain(X)
        if self.with_mean:
            x = x - self.mean_
        if self.with_std:
            x = x / self.scale_
        return _like_input(X, x)

    def inverse_transform(self, X, copy=None):
        x, _ = _masked_or_plain(X)
        if self.with_std:
            x = x * self.scale_
        if self.with_mean:
            x = x + self.mean_
        return _like_input(X, x)


class MinMaxScaler(OneToOneFeatureMixin, TransformerMixin, TorchEstimator):
    """Scale features to a given range (default [0, 1])."""

    def __init__(self, feature_range=(0, 1), copy=True):
        self.feature_range = feature_range
        self.copy = copy

    def fit(self, X, y=None):
        for a in ("data_min_", "data_max_", "n_samples_seen_"):
            if hasattr(self, a):
                delattr(self, a)
        return self.partial_fit(X, y)

    def partial_fit(self, X, y=None):
        """Incremental fit: running per-feature min/max over row blocks."""
        X = _ingest_float(self, X)
        data, mask = X.data, X.mask
        big = torch.finfo(data.dtype).max
        valid = mask[:, None] > 0
        data_min = torch.where(valid, data, torch.full_like(data, big)).amin(dim=0)
        data_max = torch.where(valid, data, torch.full_like(data, -big)).amax(dim=0)
        if hasattr(self, "data_min_"):
            data_min = torch.minimum(self.data_min_, data_min)
            data_max = torch.maximum(self.data_max_, data_max)
            self.n_samples_seen_ += int(X.n_samples)
        else:
            self.n_samples_seen_ = int(X.n_samples)
        lo, hi = self.feature_range
        self.data_min_ = data_min
        self.data_max_ = data_max
        self.data_range_ = data_max - data_min
        self.scale_ = (hi - lo) / handle_zeros_in_scale(self.data_range_)
        self.min_ = lo - data_min * self.scale_
        self.n_features_in_ = data.shape[1]
        return self

    def transform(self, X, y=None, copy=None):
        x, _ = _masked_or_plain(X)
        return _like_input(X, x * self.scale_ + self.min_)

    def inverse_transform(self, X, copy=None):
        x, _ = _masked_or_plain(X)
        return _like_input(X, (x - self.min_) / self.scale_)


class RobustScaler(OneToOneFeatureMixin, TransformerMixin, TorchEstimator):
    """Scale by median and IQR (outlier-robust)."""

    def __init__(self, with_centering=True, with_scaling=True, quantile_range=(25.0, 75.0),
                 copy=True):
        self.with_centering = with_centering
        self.with_scaling = with_scaling
        self.quantile_range = quantile_range
        self.copy = copy

    def fit(self, X, y=None):
        X = _ingest_float(self, X)
        data, mask = X.data, X.mask
        q_min, q_max = self.quantile_range
        if not 0 <= q_min <= q_max <= 100:
            raise ValueError(f"Invalid quantile_range: {self.quantile_range}")
        qs = _masked_quantiles(data, mask, [q_min / 100.0, 0.5, q_max / 100.0])
        self.center_ = qs[1] if self.with_centering else None
        self.scale_ = handle_zeros_in_scale(qs[2] - qs[0]) if self.with_scaling else None
        self.n_features_in_ = data.shape[1]
        return self

    def transform(self, X, y=None):
        x, _ = _masked_or_plain(X)
        if self.with_centering:
            x = x - self.center_
        if self.with_scaling:
            x = x / self.scale_
        return _like_input(X, x)

    def inverse_transform(self, X):
        x, _ = _masked_or_plain(X)
        if self.with_scaling:
            x = x * self.scale_
        if self.with_centering:
            x = x + self.center_
        return _like_input(X, x)


class QuantileTransformer(OneToOneFeatureMixin, TransformerMixin, TorchEstimator):
    """Map features to a uniform or normal distribution via quantiles.

    Quantiles are taken over all the rows on the device: exactly up to the
    ``DASK_ML_TPU_TORCH_EXACT_QUANTILE_MAX_ROWS`` threshold, by the
    histogram sketch past it.  ``subsample``, ``random_state`` and
    ``ignore_implicit_zeros`` are accepted, as the reference accepts them,
    and have no effect.
    """

    def __init__(self, n_quantiles=1000, output_distribution="uniform",
                 ignore_implicit_zeros=False, subsample=int(1e5),
                 random_state=None, copy=True):
        self.n_quantiles = n_quantiles
        self.output_distribution = output_distribution
        self.ignore_implicit_zeros = ignore_implicit_zeros
        self.subsample = subsample
        self.random_state = random_state
        self.copy = copy

    def fit(self, X, y=None):
        if self.output_distribution not in ("uniform", "normal"):
            raise ValueError(f"Invalid output_distribution: {self.output_distribution!r}")
        X = _ingest_float(self, X)
        n_q = min(self.n_quantiles, X.n_samples)
        self.n_quantiles_ = n_q
        self.references_ = _linspace01(n_q).to(X.data.device)
        self.quantiles_ = _masked_quantiles(X.data, X.mask, self.references_).to(X.data.dtype)
        self.n_features_in_ = X.data.shape[1]
        return self

    def _map(self, x, forward: bool):
        n, d = x.shape
        refs = self.references_.to(x.dtype)[:, None]
        out = torch.empty_like(x)
        step = max(1, _CHUNK_ELEMS // max(n, 1))
        for j in range(0, d, step):
            q = self.quantiles_[:, j:j + step]
            r = refs.expand_as(q)
            out[:, j:j + step] = (_interp_cols(x[:, j:j + step], q, r) if forward
                                  else _interp_cols(x[:, j:j + step], r, q))
        return out

    def transform(self, X):
        x, _ = _masked_or_plain(X)
        out = self._map(x, forward=True)
        if self.output_distribution == "normal":
            out = torch.special.ndtri(torch.clamp(out, 1e-7, 1 - 1e-7))
        return _like_input(X, out)

    def inverse_transform(self, X):
        x, _ = _masked_or_plain(X)
        if self.output_distribution == "normal":
            x = torch.special.ndtr(x)
        return _like_input(X, self._map(x, forward=False))


class PolynomialFeatures(TransformerMixin, TorchEstimator):
    """Polynomial feature expansion: the column products in scikit-learn's
    output order.  ``preserve_dataframe`` returns a DataFrame for a
    DataFrame input, as the reference does."""

    def __init__(self, degree=2, interaction_only=False, include_bias=True,
                 preserve_dataframe=False):
        self.degree = degree
        self.interaction_only = interaction_only
        self.include_bias = include_bias
        self.preserve_dataframe = preserve_dataframe

    @staticmethod
    def _combinations(n_features, degree, interaction_only, include_bias):
        from itertools import chain, combinations, combinations_with_replacement

        comb = combinations if interaction_only else combinations_with_replacement
        start = 0 if include_bias else 1
        return list(chain.from_iterable(
            comb(range(n_features), d) for d in range(start, degree + 1)))

    def fit(self, X, y=None):
        if _is_frame(X):
            n = X.shape[1]
            self.feature_names_in_ = np.asarray(X.columns, dtype=object)
        else:
            x, _ = _masked_or_plain(check_array(X))
            n = x.shape[1]
        self.n_features_in_ = n
        self.combinations_ = self._combinations(
            n, self.degree, self.interaction_only, self.include_bias)
        self.n_output_features_ = len(self.combinations_)
        powers = np.zeros((self.n_output_features_, n), dtype=np.int64)
        for i, combo in enumerate(self.combinations_):
            for j in combo:
                powers[i, j] += 1
        self.powers_ = powers
        return self

    def get_feature_names_out(self, input_features=None):
        if input_features is None:
            input_features = getattr(self, "feature_names_in_",
                                     [f"x{j}" for j in range(self.n_features_in_)])
        names = []
        for row in self.powers_:
            terms = [(f"{input_features[j]}" if p == 1 else f"{input_features[j]}^{p}")
                     for j, p in enumerate(row) if p > 0]
            names.append(" ".join(terms) if terms else "1")
        return np.asarray(names, dtype=object)

    def transform(self, X, y=None):
        frame_in = _is_frame(X)
        x, _ = _masked_or_plain(X.to_numpy(dtype=np.float64) if frame_in else X)
        if x.shape[1] != self.n_features_in_:
            raise ValueError(f"X has {x.shape[1]} features; expected {self.n_features_in_}")
        cols = [(torch.ones(x.shape[0], dtype=x.dtype, device=x.device) if not combo
                 else torch.prod(x[:, list(combo)], dim=1))
                for combo in self.combinations_]
        out = torch.stack(cols, dim=1)
        if frame_in and self.preserve_dataframe:
            import pandas as pd

            return pd.DataFrame(out.cpu().numpy(), index=X.index,
                                columns=self.get_feature_names_out())
        return _like_input(X, out)


class MaxAbsScaler(OneToOneFeatureMixin, TransformerMixin, TorchEstimator):
    """Scale each feature by its maximum absolute value (no centering, so
    zeros stay zero)."""

    def __init__(self, copy=True):
        self.copy = copy

    def fit(self, X, y=None):
        for a in ("max_abs_", "n_samples_seen_"):
            if hasattr(self, a):
                delattr(self, a)
        return self.partial_fit(X, y)

    def partial_fit(self, X, y=None):
        """Incremental fit: running per-feature max |x| over row blocks."""
        X = _ingest_float(self, X)
        data, mask = X.data, X.mask
        mabs = torch.where(mask[:, None] > 0, torch.abs(data),
                           torch.zeros_like(data)).amax(dim=0)
        if hasattr(self, "max_abs_"):
            mabs = torch.maximum(self.max_abs_, mabs)
            self.n_samples_seen_ += int(X.n_samples)
        else:
            self.n_samples_seen_ = int(X.n_samples)
        self.max_abs_ = mabs
        self.scale_ = handle_zeros_in_scale(mabs)
        self.n_features_in_ = data.shape[1]
        return self

    def transform(self, X, y=None, copy=None):
        x, _ = _masked_or_plain(X)
        return _like_input(X, x / self.scale_)

    def inverse_transform(self, X, copy=None):
        x, _ = _masked_or_plain(X)
        return _like_input(X, x * self.scale_)


class Normalizer(OneToOneFeatureMixin, TransformerMixin, TorchEstimator):
    """Scale each row to unit norm (l1, l2 or max); rows of zeros stay
    zero.  Stateless: ``fit`` records the width only."""

    def __init__(self, norm="l2", copy=True):
        self.norm = norm
        self.copy = copy

    def fit(self, X, y=None):
        if self.norm not in ("l1", "l2", "max"):
            raise ValueError(f"Invalid norm: {self.norm!r}")
        X = check_array(X)
        self.n_features_in_ = X.data.shape[1] if isinstance(X, ShardedRows) else X.shape[1]
        return self

    def transform(self, X, y=None, copy=None):
        if self.norm not in ("l1", "l2", "max"):
            raise ValueError(f"Invalid norm: {self.norm!r}")
        d, _ = _masked_or_plain(X)
        if self.norm == "l1":
            n = torch.sum(torch.abs(d), dim=1, keepdim=True)
        elif self.norm == "l2":
            n = torch.sqrt(torch.sum(d * d, dim=1, keepdim=True))
        else:
            n = torch.amax(torch.abs(d), dim=1, keepdim=True)
        return _like_input(X, d / torch.where(n > 0, n, torch.ones_like(n)))
