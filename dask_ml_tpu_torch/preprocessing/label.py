"""LabelEncoder: the port of ``dask_ml_tpu/preprocessing/label.py``.

The class inventory is computed on the host (labels are few); the encode
of numeric labels in a ``ShardedRows`` stays on their device, with one
scalar read (the count of unseen labels).
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import TorchEstimator, TransformerMixin
from ..core.sharded import ShardedRows, host_to_device, unshard


def _host_labels(y) -> np.ndarray:
    if isinstance(y, (ShardedRows, torch.Tensor)):
        return unshard(y)
    return np.asarray(y)


class LabelEncoder(TransformerMixin, TorchEstimator):
    """``use_categorical`` is accepted, as the reference accepts it, and has
    no effect: the class inventory always comes from the label values."""

    def __init__(self, use_categorical: bool = True):
        self.use_categorical = use_categorical

    def fit(self, y):
        vals = _host_labels(y)
        if vals.ndim != 1:
            raise ValueError("y should be a 1d array")
        self.classes_ = np.unique(vals)
        self.dtype_ = vals.dtype
        return self

    def fit_transform(self, y):
        return self.fit(y).transform(y)

    def transform(self, y):
        numeric = np.issubdtype(self.classes_.dtype, np.number)
        if isinstance(y, ShardedRows) and numeric:
            classes = torch.as_tensor(self.classes_).to(y.data.device, y.data.dtype)
            idx = torch.clamp(torch.searchsorted(classes, y.data), 0, len(classes) - 1)
            ok = (classes[idx] == y.data) | (y.mask == 0)
            if int(torch.sum(~ok)):
                diff = np.setdiff1d(unshard(y), self.classes_)
                raise ValueError(f"y contains previously unseen labels: {diff.tolist()}")
            return ShardedRows(data=idx, mask=y.mask, n_samples=y.n_samples)
        vals = _host_labels(y)
        diff = np.setdiff1d(vals, self.classes_)
        if diff.size:
            raise ValueError(f"y contains previously unseen labels: {diff.tolist()}")
        if numeric:
            classes = host_to_device(self.classes_)
            return torch.searchsorted(classes, host_to_device(vals).to(classes.dtype))
        return host_to_device(np.searchsorted(self.classes_, vals))

    def inverse_transform(self, y):
        idx = _host_labels(y)
        if idx.size and (idx.min() < 0 or idx.max() >= len(self.classes_)):
            raise ValueError("y contains out-of-range encoded labels")
        return self.classes_[idx]
