"""Splitters: the port of ``dask_ml_tpu/model_selection/_split.py``
(``train_test_split``, ``ShuffleSplit``, ``KFold``).

Splits are index-based on the host, drawn from the same
``check_random_state(...).permutation`` as the reference's, so both
packages split the same rows.  A :class:`ShardedRows` input is gathered on
its device (the index set padded to the logical shard count and masked, as
the reference pads and masks it); a tensor is indexed where it lies.
``stratify=`` needs scikit-learn's ``StratifiedShuffleSplit`` in the
reference and is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.mesh import get_n_shards
from ..core.sharded import ShardedRows, pad_rows
from ..utils import check_random_state

__all__ = ["KFold", "ShuffleSplit", "train_test_split"]


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
