"""``accuracy_score`` of ``dask_ml_tpu/metrics/classification.py``, for torch
tensors (reference: ``dask_ml/metrics/classification.py``): one masked
reduction over the padded rows, with sample weights."""

from __future__ import annotations

import numpy as np
import torch

from ..core.sharded import ShardedRows
from .regression import _apply_weight, _device, _lengths


def _as_tensor(a, device):
    """Labels as a tensor on ``device``, keeping their numeric type."""
    if isinstance(a, ShardedRows):
        a = a.data
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return a.to(device)


def _align(y_true, y_pred):
    """(true, pred, mask) of one padded length on one device: a plain side
    is zero-padded up to a ShardedRows side's padded length."""
    n_t, pad_t = _lengths(y_true)
    n_p, pad_p = _lengths(y_pred)
    if n_t != n_p:
        raise ValueError(f"y_true and y_pred have different lengths: {n_t} vs {n_p}")
    padded = max(pad_t, pad_p)
    device = _device(y_pred, y_true)

    def to_padded(a):
        x = _as_tensor(a, device)
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


def accuracy_score(y_true, y_pred, normalize: bool = True, sample_weight=None, compute=True):
    """Fraction (or weighted count) of correct predictions."""
    t, p, mask = _align(y_true, y_pred)
    w = _apply_weight(mask, sample_weight)
    hits = torch.sum((t == p).to(torch.float32) * w)
    result = hits / torch.sum(w) if normalize else hits
    return float(result) if compute else result
