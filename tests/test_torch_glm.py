"""The port's ``LogisticRegression`` (binary, one-vs-rest, multinomial,
weighted) against the JAX reference's, on the CPU: the reference on the 8
virtual CPU devices of the tier-1 conftest, the port at 8 logical shards,
the same seeded numpy inputs.

Tolerances as in ``test_torch_solvers.py``: ``coef_`` and ``intercept_``
to ‖Δβ‖∞ ≤ 1e-4·‖β_ref‖∞ with equal ``n_iter_``; ``predict`` equal (no
row of these inputs has a margin within 1e-4 of 0); ``predict_proba`` to
atol 1e-4; ``score`` equal.  Each ADMM fit here runs its inner solves at
fixed work (``inner_tol=0``): at the default inner tolerance the
reference's own β moves by up to ~3e-4·‖β‖∞ when the rows of each shard
are permuted (see ``test_torch_solvers.py``).  Multi-class ADMM fits run
the outer loop at fixed work too (``tol=0``, ``reltol=0``: see
``test_torch_multiclass.py``), and a multi-class ``predict`` is held on
the rows whose two largest reference margins are more than 1e-3 apart
(a rounding may flip the others), ``score`` to the share of the others.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dask_ml_tpu.linear_model import LogisticRegression as RefLogisticRegression
from dask_ml_tpu.utils import effective_mask as ref_effective_mask
from dask_ml_tpu.utils import host_class_weight_rows as ref_host_class_weight_rows
from dask_ml_tpu_torch import LogisticRegression, logistic_regression_from_reference
from dask_ml_tpu_torch.base import clone
from dask_ml_tpu_torch.core import mesh
from dask_ml_tpu_torch.linear_model import LinearRegression, PoissonRegression
from dask_ml_tpu_torch.solvers import packed_solve
from dask_ml_tpu_torch.utils import effective_mask, host_class_weight_rows

FIXED_INNER = {"inner_tol": 0.0, "inner_iter": 30}
# multi-class ADMM at fixed work: 5 rounds of 30 inner iterations
FIXED_ADMM = dict(solver="admm", tol=0.0, max_iter=5,
                  solver_kwargs={"inner_tol": 0.0, "inner_iter": 30, "reltol": 0.0})


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
    np.testing.assert_allclose(_as_np(port.decision_function(X)), margin, rtol=0,
                               atol=1e-4 * np.abs(beta_ref).max() * (np.abs(X).sum(1).max() + 1))
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


@pytest.mark.parametrize("case", ["fit_checkpoint", "newton", "bf16", "linear", "poisson",
                                  "packed_gradient_descent"])
def test_unported_paths_raise(case):
    X, y = _data(7, n=64)
    est, fit_X, fit_y = LogisticRegression(), X, y
    if case == "fit_checkpoint":
        est = LogisticRegression(fit_checkpoint=object())
    elif case == "newton":
        est = LogisticRegression(solver="newton")
    elif case == "bf16":
        fit_X = torch.from_numpy(X).bfloat16()
    elif case == "linear":
        est = LinearRegression()
    elif case == "poisson":
        est = PoissonRegression()
    elif case == "packed_gradient_descent":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            packed_solve("gradient_descent", X, np.stack([y, 1 - y]).astype(np.float32))
        return
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


# ------------------------------------------------------------- multi-class

def _multi_data(seed, n=2003, d=6, K=3):
    """Labels drawn from a true softmax model: argmax_k(X·W_kᵀ + Gumbel)."""
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = rng.standard_normal((K, d))
    y = np.argmax(X @ W.T + rng.gumbel(size=(n, K)), axis=1)
    return X, y


def _hold_multi(port, ref, X, y, sample_weight=None):
    """coef_, intercept_ and the margins to 1e-4·‖β‖∞, n_iter_ equal, the
    probabilities to atol 1e-4, predict and score off near-ties."""
    rb = np.asarray(ref.betas_)
    assert np.abs(_as_np(port.betas_) - rb).max() <= 1e-4 * np.abs(rb).max()
    np.testing.assert_allclose(_as_np(port.coef_), np.asarray(ref.coef_), rtol=0,
                               atol=1e-4 * np.abs(rb).max())
    np.testing.assert_allclose(np.asarray(port.intercept_), np.asarray(ref.intercept_),
                               rtol=0, atol=1e-4 * np.abs(rb).max())
    np.testing.assert_array_equal(port.n_iter_, np.asarray(ref.n_iter_))
    np.testing.assert_array_equal(port.classes_, np.asarray(ref.classes_))
    assert port._multinomial == bool(getattr(ref, "_multinomial", False))
    margin = np.asarray(ref.decision_function(X))
    np.testing.assert_allclose(_as_np(port.decision_function(X)), margin, rtol=0,
                               atol=1e-4 * np.abs(rb).max() * (np.abs(X).sum(1).max() + 1))
    top2 = np.sort(margin, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-3
    assert clear.mean() > 0.99
    pred = port.predict(X)
    np.testing.assert_array_equal(pred[clear], np.asarray(ref.predict(X))[clear])
    np.testing.assert_allclose(_as_np(port.predict_proba(X)), np.asarray(ref.predict_proba(X)),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(_as_np(port.predict_log_proba(X)),
                               np.asarray(ref.predict_log_proba(X)), rtol=1e-3, atol=1e-4)
    assert abs(port.score(X, y, sample_weight=sample_weight)
               - ref.score(X, y, sample_weight=sample_weight)) <= (~clear).mean()


@pytest.mark.parametrize("labels", ["int", "str"])
@pytest.mark.parametrize("multi_class", ["ovr", "multinomial"])
@pytest.mark.parametrize("solver", ["lbfgs", "admm"])
def test_multiclass_fit_matches_reference(solver, multi_class, labels):
    # seeds clear of the stall-exit near-ties of tolerance-driven lbfgs
    # (ROADMAP Queue 3: one-vs-rest at seed 0 is one)
    X, y = _multi_data(1 if multi_class == "multinomial" else 2 if solver == "lbfgs" else 0)
    y = np.array(["ant", "bee", "cat"])[y] if labels == "str" else y * 4 + 3
    kw = dict(FIXED_ADMM) if solver == "admm" else dict(solver="lbfgs")
    kw.update(multi_class=multi_class, C=2.0)
    ref = RefLogisticRegression(**kw).fit(X, y)
    port = LogisticRegression(**kw).fit(X, y)
    assert port.coef_.shape == (3, X.shape[1]) and port.intercept_.shape == (3,)
    _hold_multi(port, ref, X, y)


@pytest.mark.parametrize("penalty,solver", [("l2", "lbfgs"), ("l2", "admm"), ("l1", "admm")])
def test_two_class_multinomial_matches_reference(penalty, solver):
    # under L2 the sigmoid at half the penalty; otherwise a true two-class
    # softmax, collapsed to W[1] - W[0]
    X, y = _data(9)
    kw = dict(FIXED_ADMM) if solver == "admm" else dict(solver="lbfgs")
    kw.update(multi_class="multinomial", penalty=penalty, C=0.5)
    ref = RefLogisticRegression(**kw).fit(X, y)
    port = LogisticRegression(**kw).fit(X, y)
    assert port.coef_.shape == (X.shape[1],) and isinstance(port.intercept_, float)
    _hold(port, ref, X, y)
    np.testing.assert_allclose(_as_np(port.predict_log_proba(X)),
                               np.asarray(ref.predict_log_proba(X)), rtol=1e-3, atol=1e-4)
    ovr = LogisticRegression(**dict(kw, multi_class="ovr")).fit(X, y)
    assert np.abs(_as_np(ovr.betas_) - _as_np(port.betas_)).max() > 1e-3


@pytest.mark.parametrize("class_weight", ["balanced", {"bee": 3.0, "ant": 0.5}])
@pytest.mark.parametrize("multi_class", ["ovr", "multinomial"])
def test_class_weight_host_labels_match_reference(class_weight, multi_class):
    X, y = _multi_data(1)
    y = np.array(["ant", "bee", "cat"])[y]
    kw = dict(solver="lbfgs", multi_class=multi_class, class_weight=class_weight)
    sw = np.random.RandomState(3).uniform(0.5, 2.0, X.shape[0]).astype(np.float32)
    ref = RefLogisticRegression(**kw).fit(X, y, sample_weight=sw)
    port = LogisticRegression(**kw).fit(X, y, sample_weight=sw)
    _hold_multi(port, ref, X, y, sample_weight=sw)
    plain = LogisticRegression(**dict(kw, class_weight=None)).fit(X, y, sample_weight=sw)
    assert np.abs(_as_np(plain.betas_) - _as_np(port.betas_)).max() > 1e-3
    with pytest.raises(ValueError, match="not in the fitted classes"):
        LogisticRegression(class_weight={"dog": 2.0}).fit(X, y)


@pytest.mark.parametrize("class_weight", ["balanced", {1: 2.5}])
def test_class_weight_tensor_labels_match_reference(class_weight):
    # binary and three-class labels as tensors: the weights are resolved
    # on the labels' device
    for K, seed in ((2, 4), (3, 5)):
        X, y = _multi_data(seed, K=K)
        kw = dict(FIXED_ADMM, class_weight=class_weight)
        ref = RefLogisticRegression(**kw).fit(X, y)
        port = LogisticRegression(**kw).fit(torch.from_numpy(X), torch.from_numpy(y))
        host = LogisticRegression(**kw).fit(X, y)
        assert torch.equal(port.betas_, host.betas_)
        if K == 2:
            _hold(port, ref, X, y)
        else:
            _hold_multi(port, ref, X, y)
        assert port.score(torch.from_numpy(X), torch.from_numpy(y)) == port.score(X, y)


@pytest.mark.parametrize("multi_class", ["ovr", "multinomial"])
def test_multiclass_warm_start_matches_reference(multi_class):
    X, y = _multi_data(6)
    X2, y2 = _multi_data(7)
    kw = dict(FIXED_ADMM, max_iter=3, warm_start=True, multi_class=multi_class)
    ref = RefLogisticRegression(**kw).fit(X, y).fit(X2, y2)
    port = LogisticRegression(**kw).fit(X, y).fit(X2, y2)
    _hold_multi(port, ref, X2, y2)
    cold = LogisticRegression(**dict(kw, warm_start=False)).fit(X2, y2)
    assert np.abs(_as_np(cold.betas_) - _as_np(port.betas_)).max() > 1e-4
    # another problem geometry cold-starts: a multinomial fit after an OvR one
    other = "ovr" if multi_class == "multinomial" else "multinomial"
    switched = LogisticRegression(**kw).fit(X, y)
    switched.set_params(multi_class=other).fit(X2, y2)
    fresh = LogisticRegression(**dict(kw, multi_class=other)).fit(X2, y2)
    assert torch.equal(switched.betas_, fresh.betas_)


@pytest.mark.parametrize("multi_class", ["ovr", "multinomial"])
def test_multiclass_from_reference_predicts_what_the_reference_does(multi_class):
    X, y = _multi_data(8)
    y = np.array(["ant", "bee", "cat"])[y]
    ref = RefLogisticRegression(solver="lbfgs", multi_class=multi_class).fit(X, y)
    arrays = {k: np.asarray(getattr(ref, k))
              for k in ("coef_", "intercept_", "classes_", "betas_", "n_iter_")}
    with pytest.raises(ValueError, match="multinomial"):
        logistic_regression_from_reference(arrays)
    port = logistic_regression_from_reference(arrays, multinomial=ref._multinomial)
    np.testing.assert_allclose(_as_np(port.decision_function(X)),
                               np.asarray(ref.decision_function(X)), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port.predict(X), np.asarray(ref.predict(X)))
    np.testing.assert_allclose(_as_np(port.predict_proba(X)),
                               np.asarray(ref.predict_proba(X)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_as_np(port.predict_log_proba(X)),
                               np.asarray(ref.predict_log_proba(X)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port.intercept_, np.asarray(ref.intercept_), rtol=1e-6)
    assert port.score(X, y) == ref.score(X, y)
    flagged = logistic_regression_from_reference(dict(arrays, _multinomial=ref._multinomial))
    assert flagged._multinomial == ref._multinomial


@pytest.mark.parametrize("class_weight", ["balanced", {2: 3.0, 0: 0.5}])
def test_class_weight_rows_match_reference(class_weight):
    # the per-row weights themselves, host and device branches: a class
    # absent from the labels keeps its place in the table
    rng = np.random.RandomState(11)
    classes = np.array([0, 1, 2, 5])
    y = rng.choice([0, 1, 2], size=203, p=[0.6, 0.3, 0.1]).astype(np.float32)
    sw = rng.uniform(0.5, 2.0, 203).astype(np.float32)
    host = host_class_weight_rows(class_weight, classes, y)
    np.testing.assert_allclose(host, ref_host_class_weight_rows(class_weight, classes, y),
                               rtol=1e-6)
    mask = np.ones(208, np.float32)
    mask[203:] = 0.0
    y_pad = np.pad(y, (0, 5))
    ref = ref_effective_mask(jnp.asarray(mask), jnp.asarray(y_pad), sample_weight=sw,
                             class_weight=class_weight, classes=classes, n_samples=203)
    port = effective_mask(torch.from_numpy(mask), torch.from_numpy(y_pad), sample_weight=sw,
                          class_weight=class_weight, classes=classes, n_samples=203)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6)
    np.testing.assert_allclose(port.numpy()[:203], host * sw, rtol=1e-6)
    with pytest.raises(ValueError, match="dict or 'balanced'"):
        host_class_weight_rows("even", classes, y)
