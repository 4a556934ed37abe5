"""The port's binary ``LogisticRegression`` against the JAX reference's,
on the CPU: the reference on the 8 virtual CPU devices of the tier-1
conftest, the port at 8 logical shards, the same seeded numpy inputs.

Tolerances as in ``test_torch_solvers.py``: ``coef_`` and ``intercept_``
to ‖Δβ‖∞ ≤ 1e-4·‖β_ref‖∞ with equal ``n_iter_``; ``predict`` equal (no
row of these inputs has a margin within 1e-4 of 0); ``predict_proba`` to
atol 1e-4; ``score`` equal.  Each ADMM fit here runs its inner solves at
fixed work (``inner_tol=0``): at the default inner tolerance the
reference's own β moves by up to ~3e-4·‖β‖∞ when the rows of each shard
are permuted (see ``test_torch_solvers.py``).
"""

import numpy as np
import pytest
import torch

from dask_ml_tpu.linear_model import LogisticRegression as RefLogisticRegression
from dask_ml_tpu_torch import LogisticRegression, logistic_regression_from_reference
from dask_ml_tpu_torch.base import clone
from dask_ml_tpu_torch.core import mesh
from dask_ml_tpu_torch.linear_model import LinearRegression, PoissonRegression

FIXED_INNER = {"inner_tol": 0.0, "inner_iter": 30}


@pytest.fixture(autouse=True)
def _cpu():
    mesh.set_device("cpu")
    mesh.set_n_shards(8)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    mesh.set_device(None)
    mesh.set_n_shards(1)
    torch.set_num_threads(threads)


def _data(seed, n=2003, d=6):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d)
    y = (1.0 / (1.0 + np.exp(-(X @ w + 0.3))) > rng.uniform(size=n)).astype(np.int64)
    return X, y


def _as_np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _hold(port, ref, X, y, sample_weight=None):
    beta_ref = np.append(np.asarray(ref.coef_), ref.intercept_)
    beta = np.append(_as_np(port.coef_), port.intercept_)
    assert np.abs(beta - beta_ref).max() <= 1e-4 * np.abs(beta_ref).max()
    np.testing.assert_array_equal(port.n_iter_, np.asarray(ref.n_iter_))
    np.testing.assert_array_equal(port.classes_, np.asarray(ref.classes_))
    margin = np.asarray(ref.decision_function(X))
    assert np.abs(margin).min() > 1e-4  # no row whose label a rounding could flip
    np.testing.assert_array_equal(port.predict(X), np.asarray(ref.predict(X)))
    np.testing.assert_allclose(_as_np(port.predict_proba(X)),
                               np.asarray(ref.predict_proba(X)), rtol=0, atol=1e-4)
    assert port.score(X, y, sample_weight=sample_weight) == ref.score(
        X, y, sample_weight=sample_weight)


@pytest.mark.parametrize("labels", ["int", "str"])
@pytest.mark.parametrize("solver", ["admm", "lbfgs"])
def test_binary_fit_matches_reference(labels, solver):
    X, y = _data(0)
    if labels == "str":
        y = np.where(y == 1, "yes", "no")
    else:
        y = np.where(y == 1, 7, 3)
    kw = dict(solver=solver, C=2.0)
    if solver == "admm":
        kw["solver_kwargs"] = FIXED_INNER
    ref = RefLogisticRegression(**kw).fit(X, y)
    port = LogisticRegression(**kw).fit(X, y)
    _hold(port, ref, X, y)
    # a log-probability is about -|margin| where it is small, and margins
    # carry the coefficients' 1e-4·‖β‖∞ times ‖x‖₁: hold it relatively
    np.testing.assert_allclose(_as_np(port.predict_log_proba(X)),
                               np.asarray(ref.predict_log_proba(X)), rtol=1e-3, atol=1e-4)


def test_sample_weight_matches_reference():
    X, y = _data(1)
    sw = np.random.RandomState(2).uniform(0.2, 3.0, X.shape[0]).astype(np.float32)
    kw = dict(C=0.5, solver_kwargs=FIXED_INNER)
    ref = RefLogisticRegression(**kw).fit(X, y, sample_weight=sw)
    port = LogisticRegression(**kw).fit(X, y, sample_weight=sw)
    _hold(port, ref, X, y, sample_weight=sw)
    unweighted = LogisticRegression(**kw).fit(X, y)
    assert np.abs(_as_np(unweighted.coef_) - _as_np(port.coef_)).max() > 1e-3


def test_warm_start_matches_reference():
    X, y = _data(3)
    X2, y2 = _data(4)
    kw = dict(warm_start=True, max_iter=4, solver_kwargs=FIXED_INNER)
    ref = RefLogisticRegression(**kw).fit(X, y).fit(X2, y2)
    port = LogisticRegression(**kw).fit(X, y)
    first = _as_np(port.betas_).copy()
    port.fit(X2, y2)
    _hold(port, ref, X2, y2)
    cold = LogisticRegression(**dict(kw, warm_start=False)).fit(X2, y2)
    assert np.abs(_as_np(cold.betas_) - _as_np(port.betas_)).max() > 1e-4
    assert first.shape == _as_np(port.betas_).shape


def test_tensor_labels_stay_on_their_device():
    X, y = _data(5)
    kw = dict(solver_kwargs=FIXED_INNER)
    port_np = LogisticRegression(**kw).fit(X, y)
    port_t = LogisticRegression(**kw).fit(torch.from_numpy(X), torch.from_numpy(y))
    np.testing.assert_array_equal(port_t.classes_, port_np.classes_)
    assert torch.equal(port_t.betas_, port_np.betas_)
    assert port_t.score(torch.from_numpy(X), torch.from_numpy(y)) == port_np.score(X, y)


def test_from_reference_predicts_what_the_reference_does():
    X, y = _data(6)
    y = np.where(y == 1, "b", "a")
    ref = RefLogisticRegression(solver_kwargs=FIXED_INNER).fit(X, y)
    arrays = {k: np.asarray(getattr(ref, k))
              for k in ("coef_", "intercept_", "classes_", "betas_", "n_iter_")}
    port = logistic_regression_from_reference(arrays)
    np.testing.assert_allclose(_as_np(port.decision_function(X)),
                               np.asarray(ref.decision_function(X)), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(port.predict(X), np.asarray(ref.predict(X)))
    np.testing.assert_allclose(_as_np(port.predict_proba(X)),
                               np.asarray(ref.predict_proba(X)), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(port.n_iter_, np.asarray(ref.n_iter_))
    with pytest.raises(ValueError, match="missing"):
        logistic_regression_from_reference({"coef_": arrays["coef_"]})


@pytest.mark.parametrize("case", ["three_classes", "class_weight", "fit_checkpoint",
                                  "newton", "multinomial_l1", "bf16", "linear", "poisson"])
def test_unported_paths_raise(case):
    X, y = _data(7, n=64)
    est, fit_X, fit_y = LogisticRegression(), X, y
    if case == "three_classes":
        fit_y = np.arange(64) % 3
    elif case == "class_weight":
        est = LogisticRegression(class_weight="balanced")
    elif case == "fit_checkpoint":
        est = LogisticRegression(fit_checkpoint=object())
    elif case == "newton":
        est = LogisticRegression(solver="newton")
    elif case == "multinomial_l1":
        est = LogisticRegression(multi_class="multinomial", penalty="l1")
    elif case == "bf16":
        fit_X = torch.from_numpy(X).bfloat16()
    elif case == "linear":
        est = LinearRegression()
    elif case == "poisson":
        est = PoissonRegression()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        est.fit(fit_X, fit_y)


def test_estimator_contract():
    est = LogisticRegression(C=3.0, solver="lbfgs")
    assert est.get_params()["C"] == 3.0
    assert clone(est).get_params() == est.get_params()
    assert "C=3.0" in repr(est)
    assert est._estimator_type == "classifier"
    with pytest.raises(ValueError, match="Unknown solver"):
        LogisticRegression(solver="sgd").fit(*_data(8, n=32))
    with pytest.raises(ValueError, match="at least 2 classes"):
        LogisticRegression().fit(np.ones((16, 2), np.float32), np.zeros(16))
