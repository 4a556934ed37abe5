"""GaussianNB: the port of ``dask_ml_tpu/naive_bayes.py``.

A block's per-class moments are K9 (``ops/naive_bayes.py ::
class_moments``), merged into the running ones by the Chan update; the
joint log-likelihood under ``predict`` and ``predict_proba`` is K9b
(``gaussian_jll``), which never forms the (n, k, d) broadcast.  Labels
given as a tensor stay on their device: their classes, their indices and
the check that each is a known class cost one scalar read.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import ClassifierMixin, TorchEstimator
from .core.sharded import ShardedRows, as_sharded, masked_var, unshard
from .ops.naive_bayes import class_moments, gaussian_jll
from .preprocessing.data import _ingest_float, _masked_or_plain
from .utils import chan_merge, reweight_rows, safe_denominator


def _labels(y):
    """The true rows of ``y``: a tensor where it is one, else numpy."""
    if isinstance(y, ShardedRows):
        return y.unpad()
    return y if isinstance(y, torch.Tensor) else np.asarray(y)


class GaussianNB(ClassifierMixin, TorchEstimator):

    def __init__(self, priors=None, var_smoothing=1e-9):
        self.priors = priors
        self.var_smoothing = var_smoothing

    def fit(self, X, y=None, sample_weight=None):
        for a in ("classes_", "class_count_", "theta_", "_m2", "_max_var"):
            if hasattr(self, a):
                delattr(self, a)
        yv = _labels(y)
        classes = (torch.unique(yv).cpu().numpy() if isinstance(yv, torch.Tensor)
                   else np.unique(yv))
        return self.partial_fit(X, yv, classes=classes, sample_weight=sample_weight)

    def _class_index(self, yv, padded, device):
        """int32 class indices of the labels, zero-padded to ``padded`` rows
        on ``device``; raises on a label that is not in ``classes_``."""
        k = len(self.classes_)
        if isinstance(yv, torch.Tensor) and np.issubdtype(self.classes_.dtype, np.number):
            yd = yv.to(device)
            cls = torch.as_tensor(self.classes_).to(device, yd.dtype)
            idx = torch.clamp(torch.searchsorted(cls, yd), 0, k - 1)
            if int(torch.sum(cls[idx] != yd)):
                bad = np.setdiff1d(unshard(yv), self.classes_)
                raise ValueError(f"y contains labels not in classes_: {bad.tolist()}")
        else:
            yh = unshard(yv) if isinstance(yv, torch.Tensor) else yv
            idx_h = np.searchsorted(self.classes_, yh)
            bad = (idx_h >= k) | (self.classes_[np.minimum(idx_h, k - 1)] != yh)
            if bad.any():
                raise ValueError(f"y contains labels not in classes_: "
                                 f"{np.unique(yh[bad]).tolist()}")
            idx = torch.from_numpy(idx_h.astype(np.int32)).to(device)
        out = torch.zeros(padded, dtype=torch.int32, device=device)
        out[: idx.shape[0]] = idx.to(torch.int32)
        return out

    def partial_fit(self, X, y=None, classes=None, sample_weight=None):
        """Incremental fit over row blocks: the per-class Chan merge of
        (weight, mean, M2), so ``fit`` and a ``partial_fit`` stream over its
        blocks give the same statistics.  ``sample_weight`` folds into the
        mask (weighted class counts and moments)."""
        X = _ingest_float(self, X)
        yv = _labels(y)
        if yv.shape[0] != X.n_samples:
            raise ValueError("X and y have different lengths")
        if not hasattr(self, "classes_"):
            if classes is None:
                raise ValueError("classes must be passed on the first partial_fit call")
            self.classes_ = np.unique(np.asarray(classes))
            k, d = len(self.classes_), X.data.shape[1]
            self.class_count_ = torch.zeros(k, dtype=torch.float32, device=X.data.device)
            self.theta_ = torch.zeros(k, d, dtype=X.data.dtype, device=X.data.device)
            self._m2 = torch.zeros(k, d, dtype=X.data.dtype, device=X.data.device)
            self._max_var = 0.0
        elif classes is not None and not np.array_equal(np.unique(np.asarray(classes)),
                                                        self.classes_):
            raise ValueError(
                f"classes={np.asarray(classes).tolist()} is not the same as on the first "
                f"call to partial_fit ({self.classes_.tolist()})")
        labels = self._class_index(yv, X.padded, X.data.device)
        weights = reweight_rows(X, sample_weight=sample_weight).mask
        nb, means_b, var_b = class_moments(X.data, labels, weights.to(torch.float32),
                                           len(self.classes_))
        n2, self.theta_, self._m2 = chan_merge(self.class_count_[:, None], self.theta_,
                                               self._m2, nb[:, None], means_b, var_b)
        n = n2[:, 0]
        self.class_count_ = n
        # var_smoothing is keyed to the largest feature variance seen
        self._max_var = max(self._max_var, float(torch.max(masked_var(X.data, X.mask))))
        eps = self.var_smoothing * self._max_var
        self.var_ = self._m2 / safe_denominator(n)[:, None] + eps
        if self.priors is not None:
            self.class_prior_ = torch.as_tensor(np.asarray(self.priors, np.float32),
                                                device=n.device)
        else:
            self.class_prior_ = n / safe_denominator(torch.sum(n))
        self.n_features_in_ = X.data.shape[1]
        return self

    def _jll(self, X, predict=False):
        x, _ = _masked_or_plain(X)
        n = X.n_samples if isinstance(X, ShardedRows) else x.shape[0]
        out = gaussian_jll(x.contiguous(), self.theta_, self.var_, self.class_prior_, predict)
        return out[:n]

    def predict(self, X):
        idx = self._jll(X, predict=True).cpu().numpy()
        return self.classes_[idx]

    def predict_proba(self, X):
        return torch.softmax(self._jll(X), dim=1)

    def predict_log_proba(self, X):
        return torch.log(self.predict_proba(X))

    def score(self, X, y, sample_weight=None):
        """Mean accuracy, weighted by ``sample_weight`` where given.  A
        tensor ``y`` with numeric classes is scored on its device (one
        scalar read); other labels on the host."""
        y = as_sharded(y)
        if isinstance(y, ShardedRows) and np.issubdtype(self.classes_.dtype, np.number):
            idx = self._jll(X, predict=True)
            yd = y.unpad().to(idx.device)
            cls = torch.as_tensor(self.classes_).to(idx.device, yd.dtype)
            hit = (cls[idx] == yd).to(torch.float64)
            if sample_weight is None:
                return float(torch.mean(hit))
            w = torch.as_tensor(sample_weight).to(idx.device, torch.float64)
            return float(torch.sum(hit * w) / torch.sum(w))
        yv = unshard(y) if isinstance(y, ShardedRows) else np.asarray(y)
        hits = self.predict(X) == yv
        if sample_weight is None:
            return float(hits.mean())
        return float(np.average(hits, weights=np.asarray(sample_weight)))
