"""The port's SGD (``dask_ml_tpu_torch/linear_model/_sgd.py`` and K4's plain
version, ``ops/sgd.py``) against the JAX reference's, on the CPU: the
reference on the 8 virtual CPU devices of the tier-1 conftest, the port on
the CPU at 8 logical shards where the input is a ``ShardedRows``, the same
seeded numpy inputs.

Tolerances.  One step (``sgd_step``, ``_eval_loss_fn``): the mean loss to
rtol 1e-5; the new coef and intercept to 1e-5·eta·max|g| plus 2^-22 of
each element (the float32 rounding of ``c - eta·g`` in either package),
with g the reference's gradient; t equal.  ``sgd_epoch`` (8 steps): the
loss to rtol 1e-5, coef and intercept to 1e-5·‖coef_ref‖∞, t equal.  The estimators,
at fixed work (``tol=None``) unless a stopping rule is the point:
``coef_`` and ``intercept_`` to ‖Δ‖∞ ≤ 1e-4·‖coef_ref‖∞ with equal
``n_iter_`` and ``t_``; ``predict`` equal off rows whose reference margin
is within 1e-4·(1 + |margin|) of a decision boundary (none on these
seeds); ``predict_proba`` and ``decision_function`` to atol 1e-4;
``score`` to 1e-6.  In the stopping-rule cases (adaptive schedule,
early_stopping) every comparison of the reference's ``EpochStopper`` clears
its threshold by at least 5e-5 of the loss (1.9e-3, 5.1e-5 and 1.7e-3),
far above the float32 rounding that parts the two packages' losses.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu.core.prng import as_key
from dask_ml_tpu.linear_model import SGDClassifier as RefSGDClassifier
from dask_ml_tpu.linear_model import SGDRegressor as RefSGDRegressor
from dask_ml_tpu.linear_model import _sgd as ref_sgd
from dask_ml_tpu_torch import SGDClassifier, SGDRegressor
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.linear_model import _sgd
from dask_ml_tpu_torch.ops import sgd as k4

LOSSES = ("log_loss", "hinge", "squared_hinge", "modified_huber", "squared_error", "huber")
PENALTIES = ("l2", "l1", "elasticnet", None)
SCHEDULES = ("constant", "optimal", "invscaling", "adaptive")
STEP_TOL = 1e-5
FIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    mesh.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    mesh.set_device(None)
    mesh.set_n_shards(1)
    torch.set_num_threads(threads)


def _hyper(eta_scale=0.2):
    values = dict(alpha=1e-3, eta0=0.05, power_t=0.25, t0=37.0, l1_ratio=0.3, epsilon=0.5,
                  eta_scale=eta_scale)
    ref = {k: jnp.float32(v) for k, v in values.items()}
    port = torch.tensor([values[k] for k in k4.HYPER_KEYS], dtype=torch.float32)
    return ref, port


def _block(seed, loss, B=203, d=5):
    """x, targets, a mask with pad rows and fractional weights, and a state."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, d)).astype(np.float32)
    K = 3 if loss in k4.CLASSIFIER_LOSSES else 1
    if K == 1:
        y = (x @ rng.standard_normal(d) + 0.3 * rng.standard_normal(B)).astype(np.float32)[:, None]
    else:
        y = -np.ones((B, K), np.float32)
        y[np.arange(B), rng.randint(0, K, B)] = 1.0
    mask = rng.uniform(0.2, 2.0, B).astype(np.float32)
    mask[rng.uniform(size=B) < 0.1] = 0.0
    mask[-7:] = 0.0
    coef = (0.5 * rng.standard_normal((d, K))).astype(np.float32)
    intercept = (0.1 * rng.standard_normal(K)).astype(np.float32)
    return x, y, mask, coef, intercept


def _states(coef, intercept, t):
    ref = {"coef": jnp.asarray(coef), "intercept": jnp.asarray(intercept),
           "t": jnp.float32(t)}
    port = {"coef": torch.tensor(coef), "intercept": torch.tensor(intercept),
            "t": torch.tensor(t, dtype=torch.float32)}
    return ref, port


def _hold_state(port, ref, old_coef, eta):
    """New coef and intercept to 1e-5·eta·max|g| plus their float32
    rounding, t equal."""
    c_ref = np.asarray(ref["coef"], np.float64)
    b_ref = np.asarray(ref["intercept"], np.float64)
    g = np.abs(np.asarray(old_coef, np.float64) - c_ref).max() / max(eta, 1e-30)
    for got, want in ((port["coef"], c_ref), (port["intercept"], b_ref)):
        got = got.numpy().astype(np.float64)
        tol = STEP_TOL * eta * g + 2.0 ** -22 * np.abs(want) + 1e-12
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    assert float(port["t"]) == float(ref["t"])


def _eta(schedule, t, hyper_ref):
    return float(ref_sgd._learning_rate(schedule, jnp.float32(t), hyper_ref))


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("penalty", PENALTIES)
@pytest.mark.parametrize("loss", LOSSES)
def test_sgd_step_matches_reference(loss, penalty, schedule, fit_intercept):
    x, y, mask, coef, intercept = _block(LOSSES.index(loss), loss)
    h_ref, h_port = _hyper()
    s_ref, s_port = _states(coef, intercept, 3.0)
    new_ref, loss_ref = ref_sgd.sgd_step(
        s_ref, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask), h_ref, loss=loss,
        penalty=penalty, schedule=schedule, fit_intercept=fit_intercept)
    s_port, loss_port = _sgd.sgd_step(
        s_port, torch.tensor(x), torch.tensor(y), torch.tensor(mask), h_port, loss=loss,
        penalty=penalty, schedule=schedule, fit_intercept=fit_intercept)
    np.testing.assert_allclose(float(loss_port), float(loss_ref), rtol=STEP_TOL)
    _hold_state(s_port, new_ref, coef, _eta(schedule, 3.0, h_ref))
    if not fit_intercept:
        np.testing.assert_array_equal(s_port["intercept"].numpy(), intercept)


def test_learning_rate_matches_reference_bit_for_bit_over_a_stream():
    """eta from the same float32 expression, t counted in float32: equal
    over 2000 steps of each schedule at sklearn's default alpha."""
    h_ref, h_port = _hyper(eta_scale=1.0)
    h_ref["alpha"], h_port[0] = jnp.float32(1e-4), 1e-4
    h_ref["t0"], h_port[3] = jnp.float32(1e6), 1e6
    for schedule in SCHEDULES:
        t_ref, t_port = jnp.float32(0.0), torch.tensor(0.0)
        for _ in range(2000):
            a = float(ref_sgd._learning_rate(schedule, t_ref, h_ref))
            b = float(k4.learning_rate(schedule, t_port, h_port))
            assert np.float32(a) == np.float32(b) or schedule == "invscaling"
            np.testing.assert_allclose(b, a, rtol=2e-7)
            t_ref, t_port = t_ref + 1.0, t_port + 1.0
        assert float(t_ref) == float(t_port)


@pytest.mark.parametrize("loss", LOSSES)
def test_row_losses_match_reference_at_the_kinks(loss):
    """``ops/sgd.py :: row_losses`` against the reference's ``_margin_losses``
    and ``_regression_losses``: margins on each kink (z = ±1, |r| = epsilon),
    at 0 and past ±80 take the same branch, ℓ and dℓ within rtol 1e-6 (and
    atol 2^-126: XLA on the CPU flushes a subnormal ℓ such as log1p(e^-100)
    to 0)."""
    eps = np.float32(0.5)
    m = np.array([-100.0, -81.0, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, 81.0, 100.0], np.float32)
    if loss in k4.CLASSIFIER_LOSSES:
        margins = np.stack([m, m]).T.copy()
        y = np.tile(np.array([1.0, -1.0], np.float32), (m.size, 1))
        ref = ref_sgd._margin_losses(loss, jnp.asarray(margins), jnp.asarray(y))
        port = k4.row_losses(loss, torch.tensor(margins), torch.tensor(y), None)
    else:
        margins = np.concatenate([m, [eps, -eps]]).astype(np.float32)[:, None]
        y = np.zeros_like(margins)
        ref = ref_sgd._regression_losses(loss, jnp.asarray(margins), jnp.asarray(y), eps)
        port = k4.row_losses(loss, torch.tensor(margins), torch.tensor(y), torch.tensor(eps))
    for got, want in zip(port, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=2.0 ** -126)


@pytest.mark.parametrize("loss", ["log_loss", "hinge", "squared_error", "huber"])
def test_sgd_epoch_matches_reference(loss):
    x, y, mask, coef, intercept = _block(11, loss, B=256)
    h_ref, h_port = _hyper()
    s_ref, s_port = _states(coef, intercept, 5.0)
    n_mb = 8
    stacks_ref = [jnp.asarray(a).reshape(256 // n_mb, n_mb, *a.shape[1:]) for a in (x, y, mask)]
    stacks_port = [torch.tensor(a).reshape(256 // n_mb, n_mb, *a.shape[1:]) for a in (x, y, mask)]
    kw = dict(loss=loss, penalty="elasticnet", schedule="invscaling")
    new_ref, loss_ref = ref_sgd.sgd_epoch(s_ref, *stacks_ref, h_ref, **kw)
    s_port, loss_port = _sgd.sgd_epoch(s_port, *stacks_port, h_port, **kw)
    np.testing.assert_allclose(float(loss_port), float(loss_ref), rtol=STEP_TOL)
    scale = np.abs(np.asarray(new_ref["coef"])).max()
    np.testing.assert_allclose(s_port["coef"].numpy(), np.asarray(new_ref["coef"]), rtol=0,
                               atol=STEP_TOL * scale)
    np.testing.assert_allclose(s_port["intercept"].numpy(), np.asarray(new_ref["intercept"]),
                               rtol=0, atol=STEP_TOL * scale)
    assert float(s_port["t"]) == float(new_ref["t"]) == 5.0 + n_mb


@pytest.mark.parametrize("loss", LOSSES)
def test_eval_loss_matches_reference(loss):
    x, y, mask, coef, intercept = _block(5, loss)
    h_ref, h_port = _hyper()
    s_ref, s_port = _states(coef, intercept, 0.0)
    want = ref_sgd._eval_loss_fn(s_ref, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
                                 h_ref, loss=loss)
    got = _sgd._eval_loss_fn(s_port, torch.tensor(x), torch.tensor(y), torch.tensor(mask),
                             h_port, loss=loss)
    np.testing.assert_allclose(float(got), float(want), rtol=STEP_TOL)
    assert float(s_port["t"]) == 0.0  # the value-only variant moves nothing


def test_all_zero_mask_counts_one():
    x, y, mask, coef, intercept = _block(2, "log_loss")
    _, h = _hyper()
    state = {"coef": torch.tensor(coef), "intercept": torch.tensor(intercept),
             "t": torch.tensor(0.0)}
    out = k4.sgd_update(torch.tensor(x), torch.tensor(y), torch.zeros(x.shape[0]),
                        state["coef"], state["intercept"], state["t"], h, loss="log_loss",
                        penalty=None, schedule="constant")
    assert float(out[0]) == 0.0 and float(out[1]) == 0.0
    np.testing.assert_array_equal(state["coef"].numpy(), coef)  # a zero gradient, no NaN


@pytest.mark.parametrize("n, bs, sharded", [
    (2003, 256, False), (2003, 256, True), (1000, 100, True), (64, 100, True),
    (50, 7, True), (4096, 4096, False), (300, 1, True)])
def test_minibatch_views_and_row_shard_count(n, bs, sharded):
    rng = np.random.RandomState(n)
    X = rng.standard_normal((n, 3)).astype(np.float32)
    mesh.set_n_shards(8)
    ref_est, port_est = RefSGDClassifier(batch_size=bs), SGDClassifier(batch_size=bs)
    if sharded:
        xr = ref_shard_rows(X)
        xb_ref, xp = xr.data, shard_rows(X)
        xb_port = xp.data
    else:
        xb_ref = jnp.asarray(np.concatenate([X, np.zeros((4096 - n, 3), np.float32)]))
        xp = X
        xb_port = torch.from_numpy(np.asarray(xb_ref))
    assert _sgd._row_shard_count(xp) == ref_sgd._row_shard_count(xb_ref) == (8 if sharded else 1)
    n_pad = xb_ref.shape[0]
    want = ref_sgd._minibatch_views(ref_est, xb_ref, jnp.zeros((n_pad, 2)), jnp.ones(n_pad), n)
    got = _sgd._minibatch_views(port_est, xb_port, torch.zeros(n_pad, 2), torch.ones(n_pad), n,
                                n_shards=_sgd._row_shard_count(xp))
    assert (want is None) == (got is None)
    if want is not None:
        for a, b in zip(got, want):
            assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


@pytest.mark.parametrize("tol, losses, patience", [
    (1e-3, [5.0, 4.0, 3.999, 3.9995, 4.2, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0], 3),
    (0.1, [1.0, 0.95, 0.97, 0.5, 0.45, 0.44, 0.43, 0.9], 2),
    (None, [1.0, 1.0, 1.0, 1.0], 1)])
def test_epoch_stopper_matches_reference(tol, losses, patience):
    a, b = ref_sgd.EpochStopper(tol, patience), _sgd.EpochStopper(tol, patience)
    for i, cur in enumerate(losses):
        assert a.update(cur) == b.update(cur)
        assert (a.best, a.bad) == (b.best, b.bad)
        if i == 4:
            a.reset_patience()
            b.reset_patience()
            assert (a.best, a.bad) == (b.best, b.bad)
    assert a.active == b.active == (tol is not None)


# ---------------------------------------------------------------- estimators

def _cls_data(seed, n=1500, d=6, k=2):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = rng.standard_normal((d, k))
    y = np.argmax(X @ W + 0.5 * rng.standard_normal((n, k)), axis=1)
    if k == 2:
        y = (X @ W[:, 0] + 0.3 * rng.standard_normal(n) > 0.2).astype(np.int64)
    return X, y


def _reg_data(seed, n=1500, d=6):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X @ rng.standard_normal(d) + 0.5 + 0.3 * rng.standard_normal(n)).astype(np.float32)
    return X, y


def _hold_fit(port, ref):
    c_ref = np.asarray(ref.coef_, np.float64)
    scale = FIT_TOL * np.abs(c_ref).max()
    np.testing.assert_allclose(port.coef_, c_ref, rtol=0, atol=scale)
    np.testing.assert_allclose(port.intercept_, np.asarray(ref.intercept_), rtol=0, atol=scale)
    assert port.t_ == ref.t_
    if hasattr(ref, "n_iter_"):
        assert port.n_iter_ == ref.n_iter_


def _hold_predictions(port, ref, X, y):
    m_ref = np.asarray(ref.decision_function(X)) if hasattr(ref, "decision_function") else \
        np.asarray(ref.predict(X))
    if hasattr(ref, "decision_function"):
        m_port = port.decision_function(X).numpy()
        np.testing.assert_allclose(m_port, m_ref, rtol=0, atol=FIT_TOL)
        near = np.abs(m_ref if m_ref.ndim == 1 else
                      np.sort(m_ref, 1)[:, -1] - np.sort(m_ref, 1)[:, -2])
        clear = near > FIT_TOL * (1 + np.abs(m_ref).max())
        np.testing.assert_array_equal(port.predict(X)[clear], np.asarray(ref.predict(X))[clear])
        if ref.loss in ("log_loss", "modified_huber"):
            np.testing.assert_allclose(port.predict_proba(X).numpy(),
                                       np.asarray(ref.predict_proba(X)), rtol=0, atol=FIT_TOL)
        assert abs(port.score(X, y) - ref.score(X, y)) <= 1e-6 + (~clear).mean()
    else:
        np.testing.assert_allclose(port.predict(X).numpy(), m_ref, rtol=0,
                                   atol=FIT_TOL * (1 + np.abs(m_ref).max()))
        np.testing.assert_allclose(port.score(X, y), ref.score(X, y), rtol=0, atol=1e-5)


@pytest.mark.parametrize("k, loss", [(2, "log_loss"), (3, "hinge"), (4, "modified_huber"),
                                     (2, "squared_hinge")])
def test_classifier_partial_fit_stream_matches_reference(k, loss):
    """Blocks of 600 rows (padded to 1024) and a ragged tail of 300 (256 +
    the next rung), through partial_fit in order."""
    X, y = _cls_data(k, n=1500, k=k)
    classes = np.unique(y)
    port = SGDClassifier(loss=loss, random_state=0)
    ref = RefSGDClassifier(loss=loss, random_state=0)
    for lo in range(0, 1500, 600):
        port.partial_fit(X[lo:lo + 600], y[lo:lo + 600], classes=classes)
        ref.partial_fit(X[lo:lo + 600], y[lo:lo + 600], classes=classes)
    _hold_fit(port, ref)
    np.testing.assert_allclose(float(port._loss_), float(ref._loss_), rtol=1e-5)
    _hold_predictions(port, ref, X, y)


@pytest.mark.parametrize("loss", ["squared_error", "huber"])
def test_regressor_partial_fit_stream_matches_reference(loss):
    X, y = _reg_data(3)
    port, ref = SGDRegressor(loss=loss), RefSGDRegressor(loss=loss)
    for lo in range(0, 1500, 700):
        port.partial_fit(X[lo:lo + 700], y[lo:lo + 700])
        ref.partial_fit(X[lo:lo + 700], y[lo:lo + 700])
    _hold_fit(port, ref)
    _hold_predictions(port, ref, X, y)


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("batch_size", [None, 128])
@pytest.mark.parametrize("k", [2, 3])
def test_classifier_fit_matches_reference(k, batch_size, sharded):
    X, y = _cls_data(10 + k, n=1003, k=k)
    kw = dict(max_iter=6, tol=None, batch_size=batch_size, penalty="elasticnet")
    port, ref = SGDClassifier(**kw), RefSGDClassifier(**kw)
    if sharded:
        mesh.set_n_shards(8)
        port.fit(shard_rows(X), y)
        ref.fit(ref_shard_rows(X), y)
    else:
        port.fit(X, y)
        ref.fit(X, y)
    _hold_fit(port, ref)
    assert port.t_ == (6.0 if batch_size is None else ref.t_) and (batch_size is None
                                                                   or port.t_ > 6)
    _hold_predictions(port, ref, X, y)


@pytest.mark.parametrize("batch_size", [None, 200])
@pytest.mark.parametrize("loss", ["squared_error", "huber"])
def test_regressor_fit_matches_reference(loss, batch_size):
    X, y = _reg_data(7, n=1203)
    kw = dict(loss=loss, max_iter=8, tol=None, batch_size=batch_size, penalty="l1")
    port, ref = SGDRegressor(**kw).fit(X, y), RefSGDRegressor(**kw).fit(X, y)
    _hold_fit(port, ref)
    _hold_predictions(port, ref, X, y)


def test_weights_and_warm_start_match_reference():
    X, y = _cls_data(21, n=900, k=3)
    sw = np.random.RandomState(4).uniform(0.1, 3.0, 900).astype(np.float32)
    cw = {0: 2.0, 2: 0.5}
    kw = dict(max_iter=4, tol=None, class_weight=cw, warm_start=True)
    port = SGDClassifier(**kw).fit(X, y, sample_weight=sw)
    ref = RefSGDClassifier(**kw).fit(X, y, sample_weight=sw)
    _hold_fit(port, ref)
    port.fit(X[:500], y[:500])  # warm start: the state and classes are kept
    ref.fit(X[:500], y[:500])
    _hold_fit(port, ref)
    assert port.t_ == 8.0
    # class weights and sample weights through partial_fit
    kw = dict(class_weight={1: 3.0})
    port, ref = SGDClassifier(**kw), RefSGDClassifier(**kw)
    for lo in range(0, 900, 300):
        port.partial_fit(X[lo:lo + 300], y[lo:lo + 300], classes=[0, 1, 2],
                         sample_weight=sw[lo:lo + 300])
        ref.partial_fit(X[lo:lo + 300], y[lo:lo + 300], classes=[0, 1, 2],
                        sample_weight=sw[lo:lo + 300])
    _hold_fit(port, ref)
    # balanced class weight in fit, sample weight on the regressor
    port = SGDClassifier(max_iter=3, tol=None, class_weight="balanced").fit(X, y)
    ref = RefSGDClassifier(max_iter=3, tol=None, class_weight="balanced").fit(X, y)
    _hold_fit(port, ref)
    Xr, yr = _reg_data(5, n=900)
    port = SGDRegressor(max_iter=3, tol=None).fit(Xr, yr, sample_weight=sw)
    ref = RefSGDRegressor(max_iter=3, tol=None).fit(Xr, yr, sample_weight=sw)
    _hold_fit(port, ref)


def test_adaptive_schedule_matches_reference():
    """A plateau under tol: eta divides by 5 and the fit goes on, then stops
    at the same epoch in both packages."""
    X, y = _reg_data(9, n=800)
    kw = dict(learning_rate="adaptive", eta0=0.05, tol=1e-2, n_iter_no_change=2, max_iter=60)
    port, ref = SGDRegressor(**kw).fit(X, y), RefSGDRegressor(**kw).fit(X, y)
    assert ref.n_iter_ < 60
    _hold_fit(port, ref)


@pytest.mark.parametrize("est, tol", [("classifier", 3e-3), ("regressor", 3e-2)])
def test_early_stopping_with_the_reference_split(monkeypatch, est, tol):
    """The held-out rows are the reference's own ``jax.random`` draw, put in
    place of the port's ``_validation_split`` (the one difference by
    design)."""

    def ref_split(n, random_state, device):
        u = jax.random.uniform(as_key(random_state), (n,))
        return torch.from_numpy(np.asarray(u)).to(device)

    monkeypatch.setattr(_sgd, "_validation_split", ref_split)
    kw = dict(early_stopping=True, tol=tol, n_iter_no_change=3, max_iter=80, random_state=3,
              validation_fraction=0.2)
    if est == "classifier":
        X, y = _cls_data(31, n=700, k=2)
        port, ref = SGDClassifier(**kw).fit(X, y), RefSGDClassifier(**kw).fit(X, y)
    else:
        X, y = _reg_data(31, n=700)
        port, ref = SGDRegressor(**kw).fit(X, y), RefSGDRegressor(**kw).fit(X, y)
    assert 1 < ref.n_iter_ < 80
    _hold_fit(port, ref)


def test_validation_split_is_a_seeded_torch_draw():
    a = _sgd._validation_split(500, 3, torch.device("cpu"))
    b = _sgd._validation_split(500, 3, torch.device("cpu"))
    assert torch.equal(a, b) and a.dtype == torch.float32 and 0 <= float(a.min()) < 0.01


def test_device_resident_targets_and_sharded_blocks_match_reference():
    """ShardedRows X and y: labels encoded on the device, one scalar read."""
    mesh.set_n_shards(8)
    X, y = _cls_data(41, n=1001, k=3)
    port, ref = SGDClassifier(), RefSGDClassifier()
    for lo in (0, 500):
        xs, ys = X[lo:lo + 501], y[lo:lo + 501].astype(np.float32)
        port.partial_fit(shard_rows(xs), shard_rows(ys), classes=[0.0, 1.0, 2.0])
        ref.partial_fit(ref_shard_rows(xs), ref_shard_rows(ys), classes=[0.0, 1.0, 2.0])
    _hold_fit(port, ref)
    sX, sy = shard_rows(X), shard_rows(y.astype(np.float32))
    assert abs(port.score(sX, sy) - ref.score(ref_shard_rows(X),
                                              ref_shard_rows(y.astype(np.float32)))) <= 1e-6
    Xr, yr = _reg_data(42, n=501)
    port, ref = SGDRegressor(), RefSGDRegressor()
    port.partial_fit(shard_rows(Xr), shard_rows(yr))
    ref.partial_fit(ref_shard_rows(Xr), ref_shard_rows(yr))
    _hold_fit(port, ref)


def test_error_paths():
    X, y = _cls_data(1, n=64, k=3)
    with pytest.raises(ValueError, match="classes must be passed"):
        SGDClassifier().partial_fit(X, y)
    with pytest.raises(ValueError, match="labels not in"):
        SGDClassifier().partial_fit(X, y, classes=[0, 1])
    with pytest.raises(ValueError, match="labels not in"):
        SGDClassifier().partial_fit(shard_rows(X), shard_rows(y.astype(np.float32)),
                                    classes=[0.0, 1.0])
    with pytest.raises(ValueError, match="balanced"):
        SGDClassifier(class_weight="balanced").partial_fit(X, y, classes=[0, 1, 2])
    with pytest.raises(NotImplementedError, match="bf16 K4"):
        SGDClassifier().fit(shard_rows(X, dtype=torch.bfloat16), y)
    with pytest.raises(NotImplementedError, match=r"\[port-planes\]"):
        SGDClassifier(fit_checkpoint=object()).fit(X, y)
    with pytest.raises(ValueError, match="at least 2 classes"):
        SGDClassifier().fit(X, np.zeros(64))
    with pytest.raises(ValueError, match="alpha must be > 0"):
        SGDClassifier(alpha=0.0).fit(X, y)
    with pytest.raises(ValueError, match="batch_size"):
        SGDClassifier(batch_size=0).fit(X, y)
    with pytest.raises(AttributeError, match="probability"):
        SGDClassifier(loss="hinge", max_iter=1).fit(X, y).predict_proba(X)
    with pytest.raises(ValueError, match="warm_start refit"):
        SGDClassifier(warm_start=True, max_iter=1).fit(X, y % 2).fit(X, y)
    with pytest.raises(ValueError, match="loss must be one of"):
        SGDRegressor(loss="hinge").fit(X, y.astype(np.float32))


def test_wrappers_reject_what_they_cannot_take_on_a_cuda_tensor():
    x = torch.zeros(4, 3)
    h = torch.zeros(7)
    with pytest.raises(NotImplementedError, match="bf16 K4"):
        k4.sgd_loss(x.bfloat16(), torch.zeros(4, 1), torch.ones(4), torch.zeros(3, 1),
                    torch.zeros(1), h, loss="log_loss")
    with pytest.raises(ValueError, match="one target column"):
        k4.sgd_loss(x, torch.zeros(4, 2), torch.ones(4), torch.zeros(3, 2), torch.zeros(2), h,
                    loss="huber")
    with pytest.raises(ValueError, match="state shapes"):
        k4.sgd_loss(x, torch.zeros(4, 1), torch.ones(4), torch.zeros(2, 1), torch.zeros(1), h,
                    loss="log_loss")
    with pytest.raises(ValueError, match="cuda or cpu"):
        k4._launch(x.to("meta"), None, None, None, None, None, None, None, "log_loss", None,
                   None, True, False)
