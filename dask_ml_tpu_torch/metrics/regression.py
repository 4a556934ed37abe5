"""``r2_score`` of ``dask_ml_tpu/metrics/regression.py``, for torch tensors
(reference: ``dask_ml/metrics/regression.py``): one masked reduction over
the padded rows, with sample weights and sklearn's rule for a constant
target."""

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
