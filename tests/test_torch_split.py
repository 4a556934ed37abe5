"""The port's copies of scikit-learn's splitters (``StratifiedKFold``,
``check_cv`` and the ``KFold`` it makes, ``type_of_target``) and of its
``is_classifier``, held against scikit-learn itself on the same labels:
the reference's grid search takes them from scikit-learn, so the port's
folds must be those folds, index for index."""

import numpy as np
import pytest

from sklearn.model_selection import KFold as SkKFold
from sklearn.model_selection import StratifiedKFold as SkStratifiedKFold
from sklearn.model_selection import check_cv as sk_check_cv
from sklearn.utils.multiclass import type_of_target as sk_type_of_target

from dask_ml_tpu_torch.base import is_classifier
from dask_ml_tpu_torch.compose import make_pipeline
from dask_ml_tpu_torch.decomposition import PCA
from dask_ml_tpu_torch.linear_model import LinearRegression, LogisticRegression
from dask_ml_tpu_torch.model_selection import KFold, StratifiedKFold, check_cv
from dask_ml_tpu_torch.model_selection._split import type_of_target


def _labels(kind):
    rng = np.random.RandomState(sum(map(ord, kind)))
    if kind == "binary":
        return rng.randint(0, 2, 101)
    if kind == "3-class":
        return rng.randint(0, 3, 100)
    if kind == "imbalanced":
        y = np.zeros(200, int)
        y[rng.choice(200, 17, replace=False)] = 1
        return y
    if kind == "strings":
        return np.array(["spam", "eggs", "ham"])[rng.randint(0, 3, 90)]
    if kind == "float labels":
        return rng.randint(0, 2, 77).astype(np.float32)
    raise ValueError(kind)


def _same(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for (tr, te), (str_, ste) in zip(got, want):
        np.testing.assert_array_equal(tr, str_)
        np.testing.assert_array_equal(te, ste)


KINDS = ["binary", "3-class", "imbalanced", "strings", "float labels"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shuffle,seed", [(False, None), (True, 0), (True, 42)])
@pytest.mark.parametrize("n_splits", [2, 3, 5])
def test_stratified_kfold_splits_as_scikit_learn(kind, shuffle, seed, n_splits):
    y = _labels(kind)
    X = np.zeros((len(y), 1))
    _same(StratifiedKFold(n_splits, shuffle=shuffle, random_state=seed).split(X, y),
          SkStratifiedKFold(n_splits, shuffle=shuffle, random_state=seed).split(X, y))


def test_stratified_kfold_draws_from_a_shared_random_state_as_scikit_learn():
    y = _labels("3-class")
    X = np.zeros((len(y), 1))
    mine, theirs = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(2):  # a RandomState instance is drawn on from split to split
        _same(StratifiedKFold(3, shuffle=True, random_state=mine).split(X, y),
              SkStratifiedKFold(3, shuffle=True, random_state=theirs).split(X, y))


@pytest.mark.parametrize("kind", KINDS + ["continuous", "none"])
@pytest.mark.parametrize("classifier", [True, False])
@pytest.mark.parametrize("cv", [None, 3, 4])
def test_check_cv_makes_scikit_learns_splitter(kind, classifier, cv):
    if kind == "continuous":
        y = np.random.RandomState(0).normal(size=103)
    elif kind == "none":
        y = None
    else:
        y = _labels(kind)
    n = 103 if y is None else len(y)
    X = np.zeros((n, 2))
    mine = check_cv(cv, y, classifier=classifier)
    theirs = sk_check_cv(cv, y, classifier=classifier)
    assert type(mine).__name__.endswith(type(theirs).__name__)
    assert mine.get_n_splits() == theirs.get_n_splits()
    _same(mine.split(X, y), theirs.split(X, y))


def test_check_cv_passes_splitters_and_wraps_iterables():
    kf = KFold(3)
    assert check_cv(kf) is kf
    pairs = [(np.arange(5), np.arange(5, 10)), (np.arange(5, 10), np.arange(5))]
    cv = check_cv(pairs)
    assert cv.get_n_splits() == 2
    _same(cv.split(), sk_check_cv(pairs).split())
    with pytest.raises(ValueError, match="Expected `cv`"):
        check_cv("five")


def test_the_reference_kfold_and_check_cvs_kfold_cut_differently():
    """The port's ``KFold`` is the reference's (cuts at ``linspace``);
    ``check_cv`` makes scikit-learn's (the first n % k folds one longer)."""
    X = np.zeros((10, 1))
    assert [len(te) for _, te in KFold(3).split(X)] == [3, 3, 4]
    assert [len(te) for _, te in check_cv(3).split(X)] == [4, 3, 3]
    _same(check_cv(3).split(X), SkKFold(3).split(X))


@pytest.mark.parametrize("y", [
    [0, 1, 1, 0], [1.0, 2.0], [0.1, 0.6], [1, 0, 2], ["a", "b", "a"], ["a", "b", "c"], [],
    np.array([[1, 2], [3, 1]]), np.array([[1.5, 2.0], [3.0, 1.6]]), np.array([[1], [2], [2]])])
def test_type_of_target_agrees_where_check_cv_reads_it(y):
    assert type_of_target(y) == sk_type_of_target(y)


def test_stratified_kfold_refuses_as_scikit_learn():
    y = np.array([0] * 5 + [1] * 2)
    X = np.zeros((7, 1))
    with pytest.warns(UserWarning, match="least populated class"):
        list(StratifiedKFold(3).split(X, y))
    with pytest.raises(ValueError, match="cannot be greater than the number of members"):
        list(StratifiedKFold(6).split(X, np.array([0, 0, 1, 1, 2, 2, 3])))
    with pytest.raises(ValueError, match="Supported target types"):
        list(StratifiedKFold(2).split(np.zeros((4, 1)), np.array([0.5, 1.5, 2.5, 3.1])))
    with pytest.raises(ValueError, match="n_splits=2 or more"):
        StratifiedKFold(1)


def test_is_classifier_reads_the_estimator_type():
    for est in (LogisticRegression(), LinearRegression(), PCA(),
                make_pipeline(PCA(), LogisticRegression()), make_pipeline(LinearRegression())):
        want = getattr(est, "_estimator_type", None) == "classifier"
        assert is_classifier(est) is want
    assert is_classifier(LogisticRegression()) and not is_classifier(LinearRegression())
    assert is_classifier(make_pipeline(PCA(), LogisticRegression()))
