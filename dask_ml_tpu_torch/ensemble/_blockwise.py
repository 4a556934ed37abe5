"""Blockwise voting ensembles: the port of ``dask_ml_tpu/ensemble/_blockwise.py``.

One clone of the sub-estimator is fitted a block of rows (``n_blocks``
equal slices), and the ensemble predicts by hard or soft vote (classifier)
or by the mean (regressor).

* Same-configuration SGD members (``model_selection._packing.pack_key``)
  train together: each epoch is one launch of K5′
  (``ops/ensemble.py :: group_step``, ``csrc/sgd.cu :: sgd_group_step``),
  every member stepping on its own window of X read in place, where the
  reference stacks copies of the windows.  Nothing is read back to the
  host in an epoch unless a ``tol`` is set (then the members' mean loss).
* Other members fit a block at a time: device estimators one after
  another, any other object with ``fit``/``predict`` (a scikit-learn tree)
  in a thread pool.
* With SGD members, ``predict``, ``predict_proba`` and ``score`` run on the
  device: a host X is uploaded once, the votes are counted there, and one
  (n,) result comes back.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..base import ClassifierMixin, RegressorMixin, TorchEstimator, clone
from ..core.mesh import adopt_scope, current_scope
from ..core.sharded import ShardedRows, as_sharded, host_to_device, unshard
from ..linear_model._sgd import EpochStopper, SGDClassifier, SGDRegressor
from ..model_selection._packing import pack_key
from ..model_selection._search import _uses_device_estimator
from ..ops import ensemble as k5p
from ..utils import check_max_iter

__all__ = ["BlockwiseVotingClassifier", "BlockwiseVotingRegressor"]


def _to_host(a):
    if a is None:
        return None
    return unshard(a) if isinstance(a, (ShardedRows, torch.Tensor)) else np.asarray(a)


def _device_classes(y: ShardedRows) -> np.ndarray:
    """The class inventory of device labels, with only the unique values
    read back: pad rows take the first label, so padding mints no class."""
    yd = torch.where(y.mask > 0, y.data, y.data[0])
    return torch.unique(yd).cpu().numpy()


def _spans(n, n_blocks):
    bounds = np.linspace(0, n, n_blocks + 1, dtype=int)
    return [(int(lo), int(hi)) for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]


class _BlockwiseBase(TorchEstimator):
    def __init__(self, estimator, n_blocks=8):
        self.estimator = estimator
        self.n_blocks = n_blocks

    def _fit_blocks(self, X, y, **kwargs):
        if self.n_blocks < 1:
            raise ValueError("n_blocks must be >= 1")
        X, y = as_sharded(X), as_sharded(y)
        if self._try_fit_packed(X, y, kwargs):
            return self

        Xh, yh = _to_host(X), _to_host(y)
        spans = _spans(Xh.shape[0], self.n_blocks)
        members = [clone(self.estimator) for _ in spans]
        scope = current_scope()

        def fit_one(pair):
            est, (lo, hi) = pair
            with adopt_scope(scope):
                if yh is not None:
                    est.fit(Xh[lo:hi], yh[lo:hi], **kwargs)
                else:
                    est.fit(Xh[lo:hi], **kwargs)
            return est

        if _uses_device_estimator(self.estimator):
            # a device fit takes the whole card: one after another
            members = [fit_one(pair) for pair in zip(members, spans)]
        else:
            with ThreadPoolExecutor(max_workers=min(8, max(4, len(members)))) as pool:
                members = list(pool.map(fit_one, zip(members, spans)))
        self.estimators_ = members
        self.n_features_in_ = Xh.shape[1]
        return self

    def _try_fit_packed(self, X, y, kwargs) -> bool:
        """Same-key SGD members as one stack, an epoch one K5′ launch:
        member i steps on block i, read where X lies (a ``ShardedRows``
        never goes to the host).  False where the sub-estimator cannot be
        packed (the caller fits a block at a time)."""
        probe = clone(self.estimator)
        if y is None or pack_key(probe) is None or self.n_blocks < 2:
            return False
        if getattr(probe, "class_weight", None) is not None:
            # the packed epoch applies the validity mask only; a member's own
            # fit applies the weights
            return False
        if (getattr(probe, "learning_rate", None) == "adaptive"
                or getattr(probe, "early_stopping", False)):
            # no per-member eta decay or held-out split in the packed epoch
            return False

        if isinstance(X, ShardedRows):
            data = X.data.to(torch.float32)
            mask_full = X.mask
        else:
            data = host_to_device(np.asarray(X, dtype=np.float32))
            mask_full = torch.ones(data.shape[0], dtype=torch.float32, device=data.device)
        device = data.device
        if isinstance(y, ShardedRows):
            ydata = y.data if isinstance(X, ShardedRows) else y.unpad()
            ydata = ydata.to(device)
        else:
            ydata = host_to_device(np.asarray(y), device, keep_float64=True)
        n = data.shape[0]
        if ydata.shape[0] < n:  # host y against a padded X: align the lengths
            ydata = torch.cat([ydata, ydata.new_zeros(n - ydata.shape[0])])
        spans = _spans(n, self.n_blocks)
        members = [clone(self.estimator) for _ in spans]
        # every window is as long as the longest span, pulled left to stay
        # in bounds (the last may overlap its neighbour); a member's mask is
        # X's over its window, zero outside the block's own rows
        size = max(hi - lo for lo, hi in spans)
        starts = tuple(min(lo, n - size) for lo, _ in spans)
        masks = torch.stack([mask_full[st:st + size] for st in starts]).to(torch.float32)
        for b, ((lo, hi), st) in enumerate(zip(spans, starts)):
            masks[b, :lo - st] = 0.0
            masks[b, hi - st:] = 0.0

        if isinstance(members[0], SGDClassifier):
            if "classes" in kwargs:
                classes = np.sort(np.asarray(kwargs["classes"]))
            elif isinstance(y, ShardedRows):
                classes = _device_classes(y)
            else:
                classes = np.unique(np.asarray(y))
            for m in members:
                m._set_classes(classes)
            # ±1 one-vs-all targets made on the device
            enc = members[0]._encode_targets_device(ydata, mask_full)
        else:
            enc = ydata.to(torch.float32).reshape(-1, 1)

        m0 = members[0]
        M, d, K = len(members), data.shape[1], enc.shape[1]
        for m in members:
            m._validate()
            m.n_features_in_ = int(d)
        coef = torch.zeros((M, d, K), dtype=torch.float32, device=device)
        intercept = torch.zeros((M, K), dtype=torch.float32, device=device)
        t = torch.zeros(M, dtype=torch.float32, device=device)
        hypers = torch.stack([m._hyper(device) for m in members])
        out = torch.empty((M, 2), dtype=torch.float32, device=device)
        k5p.group_offsets(starts, device)  # the windows' device copy, before the epochs

        check_max_iter(m0.max_iter)
        stop = EpochStopper(m0.tol, getattr(m0, "n_iter_no_change", 5))
        for epoch in range(m0.max_iter):
            k5p.group_step(data, enc, starts, masks, coef, intercept, t, hypers, loss=m0.loss,
                           penalty=m0.penalty, schedule=m0.learning_rate,
                           fit_intercept=m0.fit_intercept, out=out)
            # a host read only while a tol check is active
            if stop.active and stop.update(float(torch.mean(out[:, 0]))):
                break
        for i, m in enumerate(members):
            m._state = {"coef": coef[i].clone(), "intercept": intercept[i].clone(),
                        "t": t[i].clone()}
            m.n_iter_ = epoch + 1
        self.estimators_ = members
        self.n_features_in_ = int(d)
        return True

    def _on_device(self) -> bool:
        """Whether every member is one of the port's SGD estimators, whose
        predictions the ensemble combines on the device."""
        return all(isinstance(e, (SGDClassifier, SGDRegressor)) for e in self.estimators_)

    def _device_input(self, X):
        """X as the members' device predict takes it: a ``ShardedRows`` or a
        tensor where it lies, a host array uploaded once."""
        if isinstance(X, (ShardedRows, torch.Tensor)):
            return X
        return host_to_device(np.asarray(X, dtype=np.float32),
                              self.estimators_[0]._device())


class BlockwiseVotingClassifier(ClassifierMixin, _BlockwiseBase):
    def __init__(self, estimator, voting="hard", classes=None, n_blocks=8):
        self.voting = voting
        self.classes = classes
        super().__init__(estimator, n_blocks=n_blocks)

    def fit(self, X, y, **kwargs):
        if self.voting not in ("hard", "soft"):
            raise ValueError(f"voting must be 'hard' or 'soft', got {self.voting!r}")
        y = as_sharded(y)
        self._fit_blocks(X, y, **kwargs)
        # classes_ sorted: the votes are counted by class index
        if self.classes is not None:
            self.classes_ = np.unique(np.asarray(self.classes))
        elif isinstance(y, ShardedRows):
            self.classes_ = _device_classes(y)
        else:
            self.classes_ = np.unique(np.asarray(y))
        return self

    def _columns(self, est):
        """Each of a member's classes' index in ``classes_``; a class outside
        it raises."""
        k = len(self.classes_)
        cols = np.searchsorted(self.classes_, est.classes_)
        if (cols >= k).any() or (self.classes_[np.minimum(cols, k - 1)] != est.classes_).any():
            raise ValueError(
                f"block estimator saw classes {est.classes_} outside {self.classes_}")
        return cols

    def _proba_sum(self, X):
        """Σ over the members of their probabilities in ``classes_``'
        columns, in float64: an (n, k) tensor on the device with SGD
        members, else a host array."""
        if self._on_device():
            Xd = self._device_input(X)
            acc = None
            for est in self.estimators_:
                cols = torch.from_numpy(self._columns(est))
                p = est.predict_proba(Xd).to(torch.float64)
                if acc is None:
                    acc = torch.zeros((p.shape[0], len(self.classes_)), dtype=torch.float64,
                                      device=p.device)
                acc[:, cols.to(p.device)] += p
            return acc
        Xh = _to_host(X)
        acc = np.zeros((Xh.shape[0], len(self.classes_)))
        for est in self.estimators_:
            acc[:, self._columns(est)] += np.asarray(est.predict_proba(Xh))
        return acc

    def _vote_index(self, X):
        """Each row's class index in ``classes_``: the most votes, a tie to
        the lowest index (``np.argmax``'s rule).  A device tensor with SGD
        members, else a host array."""
        if self.voting == "soft":
            acc = self._proba_sum(X)
            return torch.argmax(acc, dim=1) if isinstance(acc, torch.Tensor) else np.argmax(acc, 1)
        k = len(self.classes_)
        if self._on_device():
            Xd = self._device_input(X)
            counts = None
            for est in self.estimators_:
                local = est._pred_idx(est._linear(Xd))
                idx = torch.from_numpy(self._columns(est)).to(local.device)[local]
                if counts is None:
                    counts = torch.zeros((idx.shape[0], k), dtype=torch.float32,
                                         device=idx.device)
                counts.scatter_add_(1, idx[:, None], torch.ones_like(counts[:, :1]))
            return torch.argmax(counts, dim=1)
        Xh = _to_host(X)
        votes = np.stack([np.asarray(est.predict(Xh)) for est in self.estimators_])  # (m, n)
        idx = np.searchsorted(self.classes_, votes)
        counts = np.apply_along_axis(lambda col: np.bincount(col, minlength=k), 0, idx)
        return np.argmax(counts, axis=0)

    def predict(self, X):
        idx = self._vote_index(X)
        if isinstance(idx, torch.Tensor):
            idx = idx.cpu().numpy()
        return self.classes_[idx]

    def predict_proba(self, X):
        if self.voting != "soft":
            raise AttributeError("predict_proba requires voting='soft'")
        acc = self._proba_sum(X)
        if isinstance(acc, torch.Tensor):
            acc = acc.cpu().numpy()
        return acc / len(self.estimators_)

    def score(self, X, y):
        """Mean accuracy; with SGD members and numeric classes the
        predictions stay on the device and one scalar is read."""
        from ..metrics import accuracy_score

        idx = self._vote_index(X)
        if isinstance(idx, torch.Tensor) and np.issubdtype(self.classes_.dtype, np.number):
            pred = torch.from_numpy(self.classes_).to(idx.device)[idx]
            return accuracy_score(as_sharded(y), pred)
        if isinstance(idx, torch.Tensor):
            idx = idx.cpu().numpy()
        yh = _to_host(y)
        return accuracy_score(yh, self.classes_[idx].astype(yh.dtype))


class BlockwiseVotingRegressor(RegressorMixin, _BlockwiseBase):
    def fit(self, X, y, **kwargs):
        return self._fit_blocks(X, y, **kwargs)

    def predict(self, X):
        """The members' mean prediction: a device tensor with SGD members,
        else a host array."""
        if self._on_device():
            Xd = self._device_input(X)
            return torch.stack([est.predict(Xd) for est in self.estimators_]).mean(dim=0)
        Xh = _to_host(X)
        return np.stack([np.asarray(est.predict(Xh)) for est in self.estimators_]).mean(axis=0)

    def score(self, X, y):
        from ..metrics import r2_score

        return r2_score(as_sharded(y), self.predict(X))
