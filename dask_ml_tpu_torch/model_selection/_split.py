"""Splitters: the port of ``dask_ml_tpu/model_selection/_split.py``
(``train_test_split``, ``ShuffleSplit``, ``KFold``), and copies of what the
reference's grid search takes from scikit-learn, which the port runs
without: ``StratifiedKFold``, ``check_cv`` and the ``KFold`` that
``check_cv`` makes (the first ``n % k`` folds one row longer, where the
reference's ``KFold`` cuts at ``linspace``), with the same folds from the
same ``RandomState`` draws.

Splits are index-based on the host, drawn from the same
``check_random_state(...).permutation`` as the reference's, so both
packages split the same rows.  A :class:`ShardedRows` input is gathered on
its device (the index set padded to the logical shard count and masked, as
the reference pads and masks it); a tensor is indexed where it lies.
``stratify=`` needs scikit-learn's ``StratifiedShuffleSplit`` in the
reference and is not ported yet.
"""

from __future__ import annotations

import numbers
import warnings
from collections.abc import Iterable

import numpy as np
import torch

from ..core.mesh import get_n_shards
from ..core.sharded import ShardedRows, pad_rows
from ..utils import check_random_state

__all__ = ["KFold", "ShuffleSplit", "StratifiedKFold", "check_cv", "train_test_split"]


def _n_samples(a):
    if isinstance(a, ShardedRows):
        return a.n_samples
    if isinstance(a, torch.Tensor):
        return a.shape[0]
    return np.asarray(a).shape[0]


def _take(a, idx):
    """The rows ``idx`` of an array-like; a ShardedRows stays one, gathered
    on its device."""
    if isinstance(a, ShardedRows):
        idx, k = pad_rows(np.asarray(idx, dtype=np.int64), get_n_shards())
        rows = torch.from_numpy(idx).to(a.data.device)
        mask = (torch.arange(idx.shape[0], device=a.data.device) < k).to(torch.float32)
        return ShardedRows(data=a.data.index_select(0, rows), mask=mask, n_samples=k)
    if isinstance(a, torch.Tensor):
        return a.index_select(0, torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(a.device))
    if hasattr(a, "iloc"):  # pandas stays pandas
        return a.iloc[idx]
    return np.asarray(a)[idx]


def _as_count(v, n):
    """A float in (0, 1] is a fraction of n; an int a count (sklearn's rule)."""
    if isinstance(v, float) and v <= 1.0:
        return int(round(v * n))
    return int(v)


def _resolve_sizes(n, train_size, test_size):
    if train_size is None and test_size is None:
        test_size = 0.25
    n_test = n - _as_count(train_size, n) if test_size is None else _as_count(test_size, n)
    n_train = n - n_test if train_size is None else _as_count(train_size, n)
    if n_train + n_test > n:
        raise ValueError(f"train_size + test_size = {n_train + n_test} > n_samples = {n}")
    if n_train <= 0 or n_test <= 0:
        raise ValueError(f"Degenerate split: n_train={n_train}, n_test={n_test}")
    return n_train, n_test


class ShuffleSplit:
    """Random permutation splits."""

    def __init__(self, n_splits=10, test_size=None, train_size=None, blockwise=True,
                 random_state=None):
        self.n_splits = n_splits
        self.test_size = test_size
        self.train_size = train_size
        self.blockwise = blockwise
        self.random_state = random_state

    def split(self, X, y=None, groups=None):
        n = _n_samples(X)
        n_train, n_test = _resolve_sizes(n, self.train_size, self.test_size)
        rng = check_random_state(self.random_state)
        for _ in range(self.n_splits):
            perm = rng.permutation(n)
            yield np.sort(perm[:n_train]), np.sort(perm[n_train:n_train + n_test])

    def get_n_splits(self, X=None, y=None, groups=None):
        return self.n_splits


class KFold:
    """Contiguous K folds, shuffled first with ``shuffle``."""

    def __init__(self, n_splits=5, shuffle=False, random_state=None):
        self.n_splits = n_splits
        self.shuffle = shuffle
        self.random_state = random_state

    def split(self, X, y=None, groups=None):
        n = _n_samples(X)
        if self.n_splits < 2:
            raise ValueError("n_splits must be >= 2")
        if self.n_splits > n:
            raise ValueError(f"n_splits={self.n_splits} > n_samples={n}")
        idx = np.arange(n)
        if self.shuffle:
            check_random_state(self.random_state).shuffle(idx)
        bounds = np.linspace(0, n, self.n_splits + 1, dtype=int)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            yield np.sort(np.concatenate([idx[:lo], idx[hi:]])), np.sort(idx[lo:hi])

    def get_n_splits(self, X=None, y=None, groups=None):
        return self.n_splits


def train_test_split(*arrays, test_size=None, train_size=None, random_state=None, shuffle=True,
                     blockwise=True, stratify=None, **options):
    """Split each array into (train, test), in the order of ``arrays``."""
    if not arrays:
        raise ValueError("At least one array required")
    if options:
        raise TypeError(f"Unexpected kwargs: {sorted(options)}")
    n = _n_samples(arrays[0])
    for a in arrays[1:]:
        if _n_samples(a) != n:
            raise ValueError("All arrays must have the same length")
    n_train, n_test = _resolve_sizes(n, train_size, test_size)
    if stratify is not None:
        raise NotImplementedError(
            "stratify= is not ported yet (ROADMAP: [port-search] stratify=)")
    if shuffle:
        perm = check_random_state(random_state).permutation(n)
        train_idx, test_idx = np.sort(perm[:n_train]), np.sort(perm[n_train:n_train + n_test])
    else:
        train_idx, test_idx = np.arange(n_train), np.arange(n_train, n_train + n_test)
    out = []
    for a in arrays:
        out += [_take(a, train_idx), _take(a, test_idx)]
    return out


def type_of_target(y) -> str:
    """scikit-learn's ``type_of_target`` for what ``check_cv`` asks of it:
    ``binary`` (at most two values), ``multiclass`` (more, all integral or
    not floating), ``continuous`` (a non-integral float), ``*-multioutput``
    for 2-D targets of several columns, and ``unknown`` past that."""
    y = np.asarray(y)
    if y.ndim not in (1, 2) or (y.dtype == object and y.size and not isinstance(y.flat[0], str)):
        return "unknown"
    if not min(y.shape):
        return "binary" if y.ndim == 1 else "unknown"
    suffix = "-multioutput" if y.ndim == 2 and y.shape[1] > 1 else ""
    if y.dtype.kind == "f" and np.any(y != y.astype(np.int64)):
        return "continuous" + suffix
    if np.unique(y).shape[0] > 2 or (y.ndim == 2 and y.shape[1] > 1):
        return "multiclass" + suffix
    return "binary"


class _EvenKFold(KFold):
    """scikit-learn's ``KFold``, which ``check_cv`` makes for an integer
    ``cv``: contiguous folds, the first ``n % n_splits`` one row longer,
    after one ``shuffle`` of the indices with ``shuffle``."""

    def split(self, X, y=None, groups=None):
        n = _n_samples(X)
        if self.n_splits > n:
            raise ValueError(f"Cannot have number of splits n_splits={self.n_splits} greater "
                             f"than the number of samples: n_samples={n}.")
        idx = np.arange(n)
        if self.shuffle:
            check_random_state(self.random_state).shuffle(idx)
        sizes = np.full(self.n_splits, n // self.n_splits, dtype=int)
        sizes[: n % self.n_splits] += 1
        start = 0
        for size in sizes:
            test = np.zeros(n, dtype=bool)
            test[idx[start:start + size]] = True
            start += size
            yield np.flatnonzero(~test), np.flatnonzero(test)


class StratifiedKFold:
    """K folds that keep each class's share (scikit-learn's
    ``StratifiedKFold``): a class's rows, in their order, go to the folds in
    blocks sized by a round robin over the sorted labels; with ``shuffle``
    each class's fold assignment is shuffled by one ``RandomState``."""

    def __init__(self, n_splits=5, *, shuffle=False, random_state=None):
        if int(n_splits) != n_splits or n_splits < 2:
            raise ValueError(f"k-fold cross-validation requires at least one train/test split "
                             f"by setting n_splits=2 or more, got n_splits={n_splits}.")
        self.n_splits = int(n_splits)
        self.shuffle = shuffle
        self.random_state = random_state

    def _test_folds(self, y):
        rng = check_random_state(self.random_state)
        y = np.asarray(y)
        kind = type_of_target(y)
        if kind not in ("binary", "multiclass"):
            raise ValueError(f"Supported target types are: ('binary', 'multiclass'). "
                             f"Got {kind!r} instead.")
        y = y.ravel()
        # classes numbered by first appearance
        _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
        _, class_perm = np.unique(y_idx, return_inverse=True)
        y_encoded = class_perm[y_inv]
        n_classes = len(y_idx)
        y_counts = np.bincount(y_encoded)
        if np.all(self.n_splits > y_counts):
            raise ValueError(f"n_splits={self.n_splits} cannot be greater than the number of "
                             "members in each class.")
        if self.n_splits > y_counts.min():
            warnings.warn(f"The least populated class in y has only {y_counts.min()} members, "
                          f"which is less than n_splits={self.n_splits}.", UserWarning)
        y_order = np.sort(y_encoded)
        allocation = np.asarray([np.bincount(y_order[i::self.n_splits], minlength=n_classes)
                                 for i in range(self.n_splits)])
        test_folds = np.empty(len(y), dtype="i")
        for k in range(n_classes):
            folds_for_class = np.arange(self.n_splits).repeat(allocation[:, k])
            if self.shuffle:
                rng.shuffle(folds_for_class)
            test_folds[y_encoded == k] = folds_for_class
        return test_folds

    def split(self, X, y, groups=None):
        n = _n_samples(X)
        if self.n_splits > n:
            raise ValueError(f"Cannot have number of splits n_splits={self.n_splits} greater "
                             f"than the number of samples: n_samples={n}.")
        folds = self._test_folds(y)
        idx = np.arange(n)
        for i in range(self.n_splits):
            yield idx[folds != i], idx[folds == i]

    def get_n_splits(self, X=None, y=None, groups=None):
        return self.n_splits


class _IterableCV:
    """A list of (train, test) index pairs as a splitter."""

    def __init__(self, cv):
        self.cv = list(cv)

    def split(self, X=None, y=None, groups=None):
        for train, test in self.cv:
            yield train, test

    def get_n_splits(self, X=None, y=None, groups=None):
        return len(self.cv)


def check_cv(cv=5, y=None, *, classifier=False):
    """A splitter from ``cv``, as scikit-learn's ``check_cv`` makes it: an
    int (None is 5) gives :class:`StratifiedKFold` for a classifier with a
    binary or multiclass ``y``, else scikit-learn's ``KFold``; an object
    with ``split`` is returned as it is; an iterable of (train, test) pairs
    is wrapped."""
    cv = 5 if cv is None else cv
    if isinstance(cv, numbers.Integral):
        if classifier and y is not None and type_of_target(y) in ("binary", "multiclass"):
            return StratifiedKFold(cv)
        return _EvenKFold(cv)
    if not hasattr(cv, "split") or isinstance(cv, str):
        if not isinstance(cv, Iterable) or isinstance(cv, str):
            raise ValueError("Expected `cv` as an integer, a cross-validation object, or an "
                             f"iterable yielding (train, test) splits as arrays of indices. "
                             f"Got {cv}.")
        return _IterableCV(cv)
    return cv
