"""Regression metrics: the port of ``dask_ml_tpu/metrics/regression.py`` for
torch tensors (reference: ``dask_ml/metrics/regression.py``).  Each is a
masked reduction over the padded rows in float32, with sample weights;
two-dimensional targets take the uniform average over the outputs, and a
constant target follows scikit-learn's rule."""

from __future__ import annotations

import numpy as np
import torch

from ..core.mesh import get_device
from ..core.sharded import ShardedRows


def _lengths(a):
    if isinstance(a, ShardedRows):
        return a.n_samples, a.padded
    n = len(a) if not hasattr(a, "shape") else a.shape[0]  # lists welcome
    return n, n


def _device(*arrays):
    for a in arrays:
        if isinstance(a, ShardedRows):
            return a.data.device
        if isinstance(a, torch.Tensor):
            return a.device
    return get_device()


def _as_float(a, device):
    if isinstance(a, ShardedRows):
        a = a.data
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a, dtype=np.float32))
    return a.to(device=device, dtype=torch.float32)


def _align(y_true, y_pred):
    """(true, pred, mask) as float32 tensors of the same padded length on
    one device: a plain side is zero-padded up to a ShardedRows side's
    padded length (its pad rows are masked out)."""
    n_t, pad_t = _lengths(y_true)
    n_p, pad_p = _lengths(y_pred)
    if n_t != n_p:
        raise ValueError(f"y_true and y_pred have different lengths: {n_t} vs {n_p}")
    padded = max(pad_t, pad_p)
    device = _device(y_pred, y_true)

    def to_padded(a):
        x = _as_float(a, device)
        if x.shape[0] < padded:
            x = torch.cat([x, x.new_zeros((padded - x.shape[0],) + tuple(x.shape[1:]))])
        return x

    if isinstance(y_true, ShardedRows) and pad_t == padded:
        mask = y_true.mask.to(device)
    elif isinstance(y_pred, ShardedRows) and pad_p == padded:
        mask = y_pred.mask.to(device)
    else:
        mask = torch.ones(padded, dtype=torch.float32, device=device)
    return to_padded(y_true), to_padded(y_pred), mask


def _apply_weight(mask, sample_weight):
    if sample_weight is None:
        return mask
    w = _as_float(sample_weight, mask.device)
    if w.shape[0] < mask.shape[0]:  # host weights for padded rows: zeros on the pad
        w = torch.cat([w, w.new_zeros(mask.shape[0] - w.shape[0])])
    elif w.shape[0] > mask.shape[0]:  # padded weights for plain arrays
        w = w[: mask.shape[0]]
    return mask * w


def r2_score(y_true, y_pred, sample_weight=None, compute=True):
    """Coefficient of determination, weighted; a constant ``y_true`` scores
    1.0 when the fit is perfect and 0.0 otherwise (sklearn's rule)."""
    t, p, mask = _align(y_true, y_pred)
    w = _apply_weight(mask, sample_weight)
    mean_t = torch.sum(t * w) / torch.sum(w)
    ss_res = torch.sum((t - p) ** 2 * w)
    ss_tot = torch.sum((t - mean_t) ** 2 * w)
    eps = torch.finfo(ss_tot.dtype).tiny
    out = torch.where(
        ss_tot > eps,
        1.0 - ss_res / torch.where(ss_tot > eps, ss_tot, 1.0),
        torch.where(ss_res > eps, 0.0, 1.0),
    )
    return float(out) if compute else out


def _per_row(t, p, fn):
    """fn of the residual per row: the mean over the outputs of 2-D targets."""
    if t.ndim > 1 or p.ndim > 1:
        return torch.mean(fn(t.reshape(t.shape[0], -1) - p.reshape(p.shape[0], -1)), dim=1)
    return fn(t - p)


def _weighted_mean(per, w, compute):
    out = torch.sum(per * w) / torch.sum(w)
    return float(out) if compute else out


def mean_squared_error(y_true, y_pred, sample_weight=None, squared: bool = True, compute=True):
    """The weighted mean squared error; its root with ``squared=False``."""
    t, p, mask = _align(y_true, y_pred)
    w = _apply_weight(mask, sample_weight)
    out = torch.sum(_per_row(t, p, torch.square) * w) / torch.sum(w)
    if not squared:
        out = torch.sqrt(out)
    return float(out) if compute else out


def mean_absolute_error(y_true, y_pred, sample_weight=None, compute=True):
    t, p, mask = _align(y_true, y_pred)
    return _weighted_mean(_per_row(t, p, torch.abs), _apply_weight(mask, sample_weight),
                          compute)


def mean_squared_log_error(y_true, y_pred, sample_weight=None, compute=True):
    t, p, mask = _align(y_true, y_pred)
    per = (torch.log1p(t) - torch.log1p(p)) ** 2
    return _weighted_mean(per, _apply_weight(mask, sample_weight), compute)


def _as_2d(a):
    return a.reshape(a.shape[0], -1) if a.ndim > 1 else a[:, None]


def mean_absolute_percentage_error(y_true, y_pred, sample_weight=None, compute=True):
    """|y − p| / max(|y|, eps) averaged, eps float64's machine epsilon
    (scikit-learn's; exact in float32), so a zero target weighs as there."""
    t, p, mask = _align(y_true, y_pred)
    eps = float(np.finfo(np.float64).eps)
    ape = torch.abs(_as_2d(t) - _as_2d(p)) / torch.clamp(torch.abs(_as_2d(t)), min=eps)
    return _weighted_mean(torch.mean(ape, dim=1), _apply_weight(mask, sample_weight), compute)


def median_absolute_error(y_true, y_pred, sample_weight=None, compute=True):
    """The median |y − p| over the real rows (pad rows sort last as inf);
    2-D targets average the outputs' medians."""
    t, p, mask = _align(y_true, y_pred)
    if sample_weight is not None:
        raise NotImplementedError(
            "median_absolute_error does not support sample_weight (scikit-learn computes a "
            "weighted percentile)")
    err = torch.abs(_as_2d(t) - _as_2d(p))
    err = torch.where(mask[:, None] > 0, err, torch.full_like(err, float("inf")))
    n_real = torch.sum(mask > 0)
    s = torch.sort(err, dim=0).values
    hi = n_real // 2
    lo = torch.clamp((n_real - 1) // 2, min=0)
    out = torch.mean((s[lo] + s[hi]) / 2.0)
    return float(out) if compute else out


def explained_variance_score(y_true, y_pred, sample_weight=None, compute=True):
    """1 − Var[y − p] / Var[y] per output (weighted variances), averaged
    over the outputs, with scikit-learn's rule for a constant target."""
    t, p, mask = _align(y_true, y_pred)
    w = _apply_weight(mask, sample_weight)[:, None]
    td, pd = _as_2d(t), _as_2d(p)
    wsum = torch.sum(w)
    resid = td - pd
    mean_r = torch.sum(resid * w, dim=0) / wsum
    var_r = torch.sum((resid - mean_r) ** 2 * w, dim=0) / wsum
    mean_t = torch.sum(td * w, dim=0) / wsum
    var_t = torch.sum((td - mean_t) ** 2 * w, dim=0) / wsum
    eps = torch.finfo(var_t.dtype).tiny
    per_output = torch.where(
        var_t > eps,
        1.0 - var_r / torch.where(var_t > eps, var_t, 1.0),
        torch.where(var_r > eps, 0.0, 1.0),
    )
    out = torch.mean(per_output)
    return float(out) if compute else out
