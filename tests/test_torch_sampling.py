"""The port's parameter sampling (``dask_ml_tpu_torch/model_selection/
_sampling.py``), its copy of scikit-learn's ``ParameterGrid``,
``ParameterSampler`` and ``sample_without_replacement``, against the
installed scikit-learn: the same candidates, in the same order, for the
same ``random_state``.  ``sample_without_replacement`` is held over many
seeds at ratios on both sides of 0.01, 0.2 and 0.99 (its "auto" method's
three routes); the sampler over grids of lists (without replacement) and
over scipy distributions (with replacement), a list of sub-grids, and the
grid smaller than ``n_iter``.  Exact equality throughout."""

import warnings

import numpy as np
import pytest
from scipy import stats
from sklearn.model_selection import ParameterGrid as SkGrid
from sklearn.model_selection import ParameterSampler as SkSampler
from sklearn.utils.random import sample_without_replacement as sk_swr

from dask_ml_tpu_torch.model_selection._sampling import (
    ParameterGrid, ParameterSampler, sample_without_replacement)

# (n_population, n_samples): ratios at and around 0.01, 0.2 and 0.99
RATIOS = [(1000, 1), (1000, 10), (1000, 11), (200, 39), (200, 40), (200, 41), (1000, 199),
          (1000, 200), (1000, 201), (100, 98), (100, 99), (100, 100), (1000, 995), (5, 0),
          (1, 1), (20, 3)]


def _params(seq):
    return [{k: (v.item() if isinstance(v, np.generic) else v) for k, v in p.items()}
            for p in seq]


@pytest.mark.parametrize("n_population,n_samples", RATIOS)
def test_sample_without_replacement_matches_sklearn(n_population, n_samples):
    for seed in range(12):
        got = sample_without_replacement(n_population, n_samples, random_state=seed)
        want = sk_swr(n_population, n_samples, random_state=seed)
        np.testing.assert_array_equal(got, want)
        assert len(set(got.tolist())) == n_samples


def test_sample_without_replacement_shares_the_generator_as_sklearn_does():
    ours, theirs = np.random.RandomState(3), np.random.RandomState(3)
    for n_pop, n in RATIOS:
        np.testing.assert_array_equal(sample_without_replacement(n_pop, n, random_state=ours),
                                      sk_swr(n_pop, n, random_state=theirs))


def test_sample_without_replacement_rejects_what_sklearn_rejects():
    with pytest.raises(ValueError, match="greater or equal"):
        sample_without_replacement(3, 4)
    with pytest.raises(ValueError, match="greater than 0"):
        sample_without_replacement(-1, 0)


GRIDS = [
    {"a": [1, 2, 3], "b": ["x", "y"]},
    {"alpha": np.logspace(-7, 0, 200), "penalty": ["l2"]},
    {"alpha": np.logspace(-5, 1, 30)},
    [{"kernel": ["linear"]}, {"kernel": ["rbf"], "gamma": [1, 10, 100]}, {}],
    {"c": list(range(7)), "d": [True, False], "e": np.arange(11)},
]


@pytest.mark.parametrize("grid", GRIDS, ids=range(len(GRIDS)))
def test_parameter_grid_matches_sklearn(grid):
    ours, theirs = ParameterGrid(grid), SkGrid(grid)
    assert len(ours) == len(theirs)
    assert _params(ours) == _params(theirs)
    for i in range(len(theirs)):
        assert _params([ours[i]]) == _params([theirs[i]])
    with pytest.raises(IndexError):
        ours[len(theirs)]


@pytest.mark.parametrize("n_iter", [1, 2, 5, 9, 15, 27, 34, 81, 150])
@pytest.mark.parametrize("grid", GRIDS, ids=range(len(GRIDS)))
def test_parameter_sampler_over_lists_matches_sklearn(grid, n_iter):
    for seed in (0, 1, 7, 42):
        with warnings.catch_warnings(record=True) as ours_w:
            warnings.simplefilter("always")
            ours = list(ParameterSampler(grid, n_iter, random_state=seed))
        with warnings.catch_warnings(record=True) as sk_w:
            warnings.simplefilter("always")
            theirs = list(SkSampler(grid, n_iter, random_state=seed))
        assert _params(ours) == _params(theirs)
        assert len(ours_w) == len(sk_w)
        assert len(ParameterSampler(grid, n_iter)) == len(SkSampler(grid, n_iter))


def test_parameter_sampler_with_distributions_matches_sklearn():
    dists = [
        {"alpha": stats.loguniform(1e-6, 1e-1), "l1_ratio": stats.uniform(0, 1),
         "penalty": ["l2", "l1", "elasticnet"]},
        [{"alpha": stats.loguniform(1e-5, 1)}, {"eta0": stats.uniform(0.01, 0.5),
                                                "learning_rate": ["constant", "invscaling"]}],
        {"n": stats.randint(1, 100), "m": [1, 2]},
    ]
    for dist in dists:
        for seed in range(6):
            rng_a, rng_b = np.random.RandomState(seed), np.random.RandomState(seed)
            ours = list(ParameterSampler(dist, 25, random_state=rng_a))
            theirs = list(SkSampler(dist, 25, random_state=rng_b))
            assert _params(ours) == _params(theirs)
            assert rng_a.randint(1 << 30) == rng_b.randint(1 << 30)  # same draws consumed


@pytest.mark.parametrize("bad", [1, [1], {"a": 1}, {"a": []}, {"a": np.ones((2, 2))},
                                 {"a": "abc"}])
def test_parameter_grid_rejects_what_sklearn_rejects(bad):
    with pytest.raises((TypeError, ValueError)) as ours:
        ParameterGrid(bad)
    with pytest.raises((TypeError, ValueError)) as theirs:
        SkGrid(bad)
    assert ours.type is theirs.type
