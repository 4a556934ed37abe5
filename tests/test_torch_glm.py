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

``LinearRegression`` and ``PoissonRegression`` (and ``LogisticRegression``
by ``gradient_descent``, ``proximal_grad`` and ``newton``) are held the
same way: β to 1e-4·‖β‖∞ with equal ``n_iter_``, ``predict`` to the
margins' bound above (relatively for Poisson's exp), ``score`` (R², minus
the deviance) to 1e-5 and rtol 1e-5.  The single-lane solvers stop by
their relative-decrease rule at the estimators' ``tol=1e-4``, well above
the float32 rounding of the objective (``test_torch_glm_solvers.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu.linear_model import LinearRegression as RefLinearRegression
from dask_ml_tpu.linear_model import LogisticRegression as RefLogisticRegression
from dask_ml_tpu.linear_model import PoissonRegression as RefPoissonRegression
from dask_ml_tpu.metrics import r2_score as ref_r2_score
from dask_ml_tpu.utils import effective_mask as ref_effective_mask
from dask_ml_tpu.utils import host_class_weight_rows as ref_host_class_weight_rows
from dask_ml_tpu_torch import (
    LogisticRegression, linear_regression_from_reference, logistic_regression_from_reference,
    poisson_regression_from_reference)
from dask_ml_tpu_torch.base import clone
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.metrics.regression import r2_score
from dask_ml_tpu_torch.linear_model import LinearRegression, PoissonRegression
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


@pytest.mark.parametrize("case", ["fit_checkpoint", "bf16_multinomial"])
def test_unported_paths_raise(case):
    X, y = _data(7, n=64)
    est, fit_X, fit_y = LogisticRegression(), X, y
    if case == "fit_checkpoint":
        est = LogisticRegression(fit_checkpoint=object())
    elif case == "bf16_multinomial":
        # bf16 X reaches K2 only; K2-MN takes float32
        est = LogisticRegression(solver="lbfgs", multi_class="multinomial")
        fit_X, fit_y = torch.from_numpy(X).bfloat16(), np.arange(64) % 3
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


# ------------------------------------------------- regression estimators

SOLVERS = ["admm", "lbfgs", "gradient_descent", "proximal_grad", "newton"]


def _reg_data(kind, seed, n=2003, d=6):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d)
    if kind == "linear":
        y = (X @ w + 0.5 + rng.standard_normal(n)).astype(np.float32)
    else:
        y = rng.poisson(np.exp(X @ (0.3 * w) + 0.2)).astype(np.float32)
    return X, y


def _reg_kwargs(kind, solver):
    if solver != "admm":
        return dict(solver=solver)
    if kind == "linear":
        return dict(solver="admm", solver_kwargs=FIXED_INNER)
    # Poisson ADMM at fixed work (test_torch_glm_solvers.py says why)
    return dict(solver="admm", tol=0.0, max_iter=5,
                solver_kwargs={"inner_tol": 0.0, "inner_iter": 10, "reltol": 0.0})


def _hold_regression(port, ref, X, y, sample_weight=None):
    beta_ref = np.append(np.asarray(ref.coef_), ref.intercept_)
    beta = np.append(_as_np(port.coef_), port.intercept_)
    scale = np.abs(beta_ref).max()
    assert np.abs(beta - beta_ref).max() <= 1e-4 * scale
    np.testing.assert_array_equal(port.n_iter_, np.asarray(ref.n_iter_))
    bound = 1e-4 * scale * (np.abs(X).sum(1).max() + 1)
    got, want = _as_np(port.predict(X)), np.asarray(ref.predict(X))
    if isinstance(port, PoissonRegression):
        np.testing.assert_allclose(got, want, rtol=bound, atol=0)
        np.testing.assert_allclose(port.get_deviance(X, y, sample_weight),
                                   ref.get_deviance(X, y, sample_weight), rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=bound)
    np.testing.assert_allclose(port.score(X, y, sample_weight=sample_weight),
                               ref.score(X, y, sample_weight=sample_weight), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "sample_weight"])
@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("kind", ["linear", "poisson"])
def test_regression_fit_matches_reference(kind, solver, weighted):
    X, y = _reg_data(kind, 0)
    sw = (np.random.RandomState(5).uniform(0.2, 3.0, X.shape[0]).astype(np.float32)
          if weighted else None)
    kw = _reg_kwargs(kind, solver)
    Ref, Port = ((RefLinearRegression, LinearRegression) if kind == "linear"
                 else (RefPoissonRegression, PoissonRegression))
    ref = Ref(**kw).fit(X, y, sample_weight=sw)
    port = Port(**kw).fit(X, y, sample_weight=sw)
    assert port.coef_.shape == (X.shape[1],) and isinstance(port.intercept_, float)
    _hold_regression(port, ref, X, y, sample_weight=sw)
    if weighted:
        plain = Port(**kw).fit(X, y)
        assert np.abs(_as_np(plain.coef_) - _as_np(port.coef_)).max() > 1e-3


@pytest.mark.parametrize("kind", ["linear", "poisson"])
def test_regression_warm_start_and_bf16_match_reference(kind):
    X, y = _reg_data(kind, 1)
    X2, y2 = _reg_data(kind, 2)
    Ref, Port = ((RefLinearRegression, LinearRegression) if kind == "linear"
                 else (RefPoissonRegression, PoissonRegression))
    kw = dict(solver="gradient_descent", warm_start=True, max_iter=3, tol=0.0)
    ref = Ref(**kw).fit(X, y).fit(X2, y2)
    port = Port(**kw).fit(X, y).fit(X2, y2)
    _hold_regression(port, ref, X2, y2)
    cold = Port(**dict(kw, warm_start=False)).fit(X2, y2)
    assert np.abs(_as_np(cold.betas_) - _as_np(port.betas_)).max() > 1e-4
    # a bfloat16 X (the reference's shard_rows(X, dtype=bfloat16)): float32 β
    ref = Ref(solver="lbfgs").fit(ref_shard_rows(X, dtype=jnp.bfloat16), y)
    port = Port(solver="lbfgs").fit(shard_rows(X, dtype=torch.bfloat16), y)
    assert port.coef_.dtype == torch.float32
    _hold_regression(port, ref, X, y)


@pytest.mark.parametrize("multiclass", [False, True], ids=["binary", "ovr"])
@pytest.mark.parametrize("solver", ["gradient_descent", "proximal_grad", "newton"])
def test_logistic_new_solvers_match_reference(solver, multiclass):
    kw = dict(solver=solver, C=2.0)
    if multiclass:
        X, y = _multi_data(2)
        ref = RefLogisticRegression(**kw).fit(X, y)
        port = LogisticRegression(**kw).fit(X, y)
        _hold_multi(port, ref, X, y)
    else:
        X, y = _data(0)
        ref = RefLogisticRegression(**kw).fit(X, y)
        port = LogisticRegression(**kw).fit(X, y)
        _hold(port, ref, X, y)


def test_bf16_logistic_matches_reference():
    X, y = _data(1)
    ref = RefLogisticRegression(solver="lbfgs").fit(ref_shard_rows(X, dtype=jnp.bfloat16), y)
    port = LogisticRegression(solver="lbfgs").fit(shard_rows(X, dtype=torch.bfloat16), y)
    assert port.coef_.dtype == torch.float32
    _hold(port, ref, X, y)
    Xb = shard_rows(X, dtype=torch.bfloat16)  # predict widens a bf16 X
    np.testing.assert_array_equal(port.predict(Xb), np.asarray(ref.predict(X)))


@pytest.mark.parametrize("kind", ["linear", "poisson"])
def test_regression_from_reference_predicts_what_the_reference_does(kind):
    X, y = _reg_data(kind, 3)
    Ref = RefLinearRegression if kind == "linear" else RefPoissonRegression
    convert = (linear_regression_from_reference if kind == "linear"
               else poisson_regression_from_reference)
    ref = Ref(solver="lbfgs").fit(X, y)
    arrays = {k: np.asarray(getattr(ref, k)) for k in ("coef_", "intercept_", "n_iter_")}
    port = convert(arrays)
    np.testing.assert_allclose(_as_np(port.predict(X)), np.asarray(ref.predict(X)), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(port.score(X, y), ref.score(X, y), rtol=1e-5)
    np.testing.assert_array_equal(port.n_iter_, np.asarray(ref.n_iter_))
    assert port.intercept_ == float(np.float32(ref.intercept_))
    with pytest.raises(ValueError, match="missing"):
        convert({"coef_": arrays["coef_"]})
    no_icpt = convert(dict(arrays, intercept_=0.0), fit_intercept=False)
    assert tuple(no_icpt.betas_.shape) == (1, X.shape[1]) and no_icpt.intercept_ == 0.0


def test_r2_score_matches_reference():
    rng = np.random.RandomState(4)
    t = rng.standard_normal(203).astype(np.float32)
    p = (t + 0.3 * rng.standard_normal(203)).astype(np.float32)
    sw = rng.uniform(0.5, 2.0, 203).astype(np.float32)
    assert r2_score(t, p) == pytest.approx(ref_r2_score(t, p), rel=1e-6)
    assert r2_score(t, p, sample_weight=sw) == pytest.approx(
        ref_r2_score(t, p, sample_weight=sw), rel=1e-6)
    # padded rows of a ShardedRows side are masked out
    assert r2_score(shard_rows(t), torch.from_numpy(p)) == pytest.approx(
        ref_r2_score(ref_shard_rows(t), p), rel=1e-6)
    # a constant target: 1.0 for a perfect fit, else 0.0
    c = np.full(20, 2.5, np.float32)
    assert r2_score(c, c) == ref_r2_score(c, c) == 1.0
    assert r2_score(c, c + 1.0) == ref_r2_score(c, c + 1.0) == 0.0
    with pytest.raises(ValueError, match="different lengths"):
        r2_score(t, p[:10])


def test_regressor_contract():
    for cls in (LinearRegression, PoissonRegression):
        est = cls(C=3.0, solver="newton")
        assert est._estimator_type == "regressor"
        assert clone(est).get_params() == est.get_params()
        with pytest.raises(NotImplementedError, match="fit_checkpoint"):
            cls(fit_checkpoint=object()).fit(*_reg_data("linear", 0, n=32))
        with pytest.raises(ValueError, match="Unknown solver"):
            cls(solver="sgd").fit(*_reg_data("linear", 0, n=32))
