"""Parameter grids and samplers without scikit-learn.

The reference's searches draw their candidates with scikit-learn
(``dask_ml_tpu/model_selection/_incremental.py :: _get_params``).  The port
runs where scikit-learn is not installed, so this module carries a copy of
the parts it calls, with the same draws from the same numpy
``RandomState``, so that both packages sample the same candidates:

- ``sklearn.model_selection.ParameterGrid`` (its iteration order, its
  ``__len__`` and its ``__getitem__`` index order);
- ``sklearn.model_selection.ParameterSampler`` (without replacement from a
  grid of lists, with replacement as soon as one entry is a distribution
  with ``.rvs``, drawn as ``v.rvs(random_state=rng)``);
- ``sklearn.utils.random.sample_without_replacement`` with its ``"auto"``
  method: a permutation for ratios in (0.01, 0.99), else tracking selection
  below a ratio of 0.2 and reservoir sampling from it up.
"""

from __future__ import annotations

import operator
import warnings
from collections.abc import Iterable, Mapping, Sequence
from functools import partial, reduce
from itertools import product

import numpy as np

from ..utils import check_random_state

__all__ = ["ParameterGrid", "ParameterSampler", "sample_without_replacement"]


class ParameterGrid:
    """The grid of every combination of the listed values (a dict of
    lists, or a list of such dicts, one sub-grid each), keys sorted."""

    def __init__(self, param_grid):
        if not isinstance(param_grid, (Mapping, Iterable)):
            raise TypeError(f"Parameter grid should be a dict or a list, got: {param_grid!r} "
                            f"of type {type(param_grid).__name__}")
        if isinstance(param_grid, Mapping):
            param_grid = [param_grid]
        for grid in param_grid:
            if not isinstance(grid, dict):
                raise TypeError(f"Parameter grid is not a dict ({grid!r})")
            for key, value in grid.items():
                if isinstance(value, np.ndarray) and value.ndim > 1:
                    raise ValueError(f"Parameter array for {key!r} should be one-dimensional, "
                                     f"got: {value!r} with shape {value.shape}")
                if isinstance(value, str) or not isinstance(value, (np.ndarray, Sequence)):
                    raise TypeError(
                        f"Parameter grid for parameter {key!r} needs to be a list or a numpy "
                        f"array, but got {value!r} (of type {type(value).__name__}) instead. "
                        "Single values need to be wrapped in a list with one element.")
                if len(value) == 0:
                    raise ValueError(f"Parameter grid for parameter {key!r} need to be a "
                                     f"non-empty sequence, got: {value!r}")
        self.param_grid = param_grid

    def __iter__(self):
        for p in self.param_grid:
            items = sorted(p.items())
            if not items:
                yield {}
            else:
                keys, values = zip(*items)
                for v in product(*values):
                    yield dict(zip(keys, v))

    def __len__(self):
        prod = partial(reduce, operator.mul)
        return sum(prod(len(v) for v in p.values()) if p else 1 for p in self.param_grid)

    def __getitem__(self, ind):
        """``list(self)[ind]``, without building the list."""
        for sub_grid in self.param_grid:
            if not sub_grid:
                if ind == 0:
                    return {}
                ind -= 1
                continue
            # reversed: the most frequently cycling parameter comes first
            keys, values_lists = zip(*sorted(sub_grid.items())[::-1])
            sizes = [len(v_list) for v_list in values_lists]
            total = np.prod(sizes)
            if ind >= total:
                ind -= total
            else:
                out = {}
                for key, v_list, n in zip(keys, values_lists, sizes):
                    ind, offset = divmod(ind, n)
                    out[key] = v_list[offset]
                return out
        raise IndexError("ParameterGrid index out of range")


def _check_input(n_population, n_samples):
    if n_population < 0:
        raise ValueError(f"n_population should be greater than 0, got {n_population}.")
    if n_samples > n_population:
        raise ValueError("n_population should be greater or equal than n_samples, got "
                         f"n_samples > n_population ({n_samples} > {n_population})")


def _tracking_selection(n_population, n_samples, rng):
    out = np.empty((n_samples,), dtype=int)
    selected = set()
    for i in range(n_samples):
        j = rng.randint(n_population)
        while j in selected:
            j = rng.randint(n_population)
        selected.add(j)
        out[i] = j
    return out


def _reservoir_sampling(n_population, n_samples, rng):
    out = np.arange(n_samples, dtype=int)
    for i in range(n_samples, n_population):
        j = rng.randint(0, i + 1)
        if j < n_samples:
            out[j] = i
    return out


def sample_without_replacement(n_population, n_samples, random_state=None):
    """``n_samples`` distinct integers of ``[0, n_population)`` by the
    ``"auto"`` method (their order is the method's, not a random one)."""
    n_population, n_samples = int(n_population), int(n_samples)
    _check_input(n_population, n_samples)
    ratio = n_samples / n_population if n_population != 0 else 1.0
    rng = check_random_state(random_state)
    if 0.01 < ratio < 0.99:
        return rng.permutation(n_population)[:n_samples]
    if ratio < 0.2:
        return _tracking_selection(n_population, n_samples, rng)
    return _reservoir_sampling(n_population, n_samples, rng)


class ParameterSampler:
    """``n_iter`` candidates drawn from ``param_distributions`` (a dict, or
    a list of dicts of which one is drawn a candidate): without replacement
    from the grid when every entry is a list, else each entry drawn
    independently (``.rvs`` for a distribution, a uniform pick for a
    list)."""

    def __init__(self, param_distributions, n_iter, *, random_state=None):
        if not isinstance(param_distributions, (Mapping, Iterable)):
            raise TypeError("Parameter distribution is not a dict or a list, got: "
                            f"{param_distributions!r} of type "
                            f"{type(param_distributions).__name__}")
        if isinstance(param_distributions, Mapping):
            param_distributions = [param_distributions]
        for dist in param_distributions:
            if not isinstance(dist, dict):
                raise TypeError(f"Parameter distribution is not a dict ({dist!r})")
            for key in dist:
                if not isinstance(dist[key], Iterable) and not hasattr(dist[key], "rvs"):
                    raise TypeError(f"Parameter grid for parameter {key!r} is not iterable or "
                                    f"a distribution (value={dist[key]})")
        self.n_iter = n_iter
        self.random_state = random_state
        self.param_distributions = param_distributions

    def _is_all_lists(self):
        return all(all(not hasattr(v, "rvs") for v in dist.values())
                   for dist in self.param_distributions)

    def __iter__(self):
        rng = check_random_state(self.random_state)
        if self._is_all_lists():
            param_grid = ParameterGrid(self.param_distributions)
            grid_size = len(param_grid)
            n_iter = self.n_iter
            if grid_size < n_iter:
                warnings.warn(
                    f"The total space of parameters {grid_size} is smaller than "
                    f"n_iter={self.n_iter}. Running {grid_size} iterations. For exhaustive "
                    "searches, use GridSearchCV.", UserWarning)
                n_iter = grid_size
            for i in sample_without_replacement(grid_size, n_iter, random_state=rng):
                yield param_grid[i]
        else:
            for _ in range(self.n_iter):
                dist = rng.choice(self.param_distributions)
                params = {}
                for k, v in sorted(dist.items()):
                    params[k] = v.rvs(random_state=rng) if hasattr(v, "rvs") \
                        else v[rng.randint(len(v))]
                yield params

    def __len__(self):
        if self._is_all_lists():
            return min(self.n_iter, len(ParameterGrid(self.param_distributions)))
        return self.n_iter
