"""The port's packed cohorts (``dask_ml_tpu_torch/model_selection/
_packing.py`` and K5's plain version, ``ops/cohort.py :: cohort_step_ref``)
against the JAX reference's, on the CPU: the reference on the 8 virtual CPU
devices of the tier-1 conftest, the port on the CPU (at 8 logical shards
where the blocks are ``ShardedRows``), the same seeded numpy inputs.

Tolerances.  One packed step (``cohort_step_ref`` against
``_packed_step_impl``, weighted lanes and an all-zero lane): each lane's
mean loss to rtol 1e-5; its new coef and intercept to 1e-5·eta·max|g| plus
2^-22 of each element (the float32 rounding of ``c - eta·g`` in either
package), with g the reference's gradient; t equal.  A ``Cohort`` over a
few blocks (fresh, or warmed in the reference and carried into the port
by the SGD converters): each member's ``coef_`` and ``intercept_`` to
1e-5·‖coef_ref‖∞ with equal ``t_``, its last loss to rtol 1e-5, the packed
accuracies equal, and
``DISPATCH_STATS`` equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu.linear_model import SGDClassifier as RefSGDClassifier
from dask_ml_tpu.linear_model import SGDRegressor as RefSGDRegressor
from dask_ml_tpu.linear_model import _sgd as ref_sgd
from dask_ml_tpu.model_selection import _packing as ref_packing
from dask_ml_tpu_torch import (
    SGDClassifier, SGDRegressor, sgd_classifier_from_reference, sgd_regressor_from_reference)
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.model_selection import _packing
from dask_ml_tpu_torch.ops import cohort as k5
from dask_ml_tpu_torch.ops import sgd as k4

LOSSES = ("log_loss", "hinge", "squared_hinge", "modified_huber", "squared_error", "huber")
PENALTIES = ("l2", "l1", "elasticnet", None)
SCHEDULES = ("constant", "optimal", "invscaling", "adaptive")
TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    mesh.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _packing.reset_dispatch_stats()
    ref_packing.reset_dispatch_stats()
    yield
    mesh.set_device(None)
    mesh.set_n_shards(1)
    torch.set_num_threads(threads)


def _lanes(seed, loss, M=4, B=203, d=5):
    """x, targets, per-lane weighted masks (pad rows 0, lane 2 all zero),
    a stacked state and hyperparameters that differ by lane."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, d)).astype(np.float32)
    K = 3 if loss in k4.CLASSIFIER_LOSSES else 1
    if K == 1:
        y = (x @ rng.standard_normal(d) + 0.3 * rng.standard_normal(B)).astype(np.float32)[:, None]
    else:
        y = -np.ones((B, K), np.float32)
        y[np.arange(B), rng.randint(0, K, B)] = 1.0
    masks = rng.uniform(0.2, 2.0, (M, B)).astype(np.float32)
    masks[:, -7:] = 0.0
    masks[2] = 0.0
    coef = (0.5 * rng.standard_normal((M, d, K))).astype(np.float32)
    intercept = (0.1 * rng.standard_normal((M, K))).astype(np.float32)
    t = np.array([0.0, 3.0, 7.0, 11.0][:M], np.float32)
    hypers = np.stack([np.logspace(-4, -2, M), np.linspace(0.01, 0.05, M), np.full(M, 0.25),
                       np.linspace(20, 40, M), np.linspace(0.1, 0.5, M),
                       np.linspace(0.2, 0.8, M), np.full(M, 0.2)], 1).astype(np.float32)
    return x, y, masks, coef, intercept, t, hypers


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("penalty", PENALTIES)
@pytest.mark.parametrize("loss", LOSSES)
def test_cohort_step_ref_matches_packed_step(loss, penalty, schedule):
    x, y, masks, coef, intercept, t, hypers = _lanes(LOSSES.index(loss), loss)
    fit_intercept = PENALTIES.index(penalty) % 2 == 0
    kw = dict(loss=loss, penalty=penalty, schedule=schedule, fit_intercept=fit_intercept)
    states = {"coef": jnp.asarray(coef), "intercept": jnp.asarray(intercept),
              "t": jnp.asarray(t)}
    h_ref = {k: jnp.asarray(hypers[:, i]) for i, k in enumerate(k4.HYPER_KEYS)}
    new, losses = ref_packing._packed_step_impl(states, jnp.asarray(x), jnp.asarray(y),
                                                jnp.asarray(masks), h_ref, **kw)
    c, b, tt = torch.tensor(coef), torch.tensor(intercept), torch.tensor(t)
    k5.cohort_step_ref.calls = 0
    out = k5.cohort_step(torch.tensor(x), torch.tensor(y), torch.tensor(masks), c, b, tt,
                         torch.tensor(hypers), **kw)
    assert k5.cohort_step_ref.calls == 1 and k5.cohort_step.launches == 0
    np.testing.assert_allclose(out[:, 0].numpy(), np.asarray(losses), rtol=TOL)
    np.testing.assert_allclose(out[:, 1].numpy(), masks.sum(1, dtype=np.float64), rtol=1e-6)
    assert out[2, 0] == 0.0 and out[2, 1] == 0.0  # the all-zero lane: count 1, loss 0
    for m in range(len(t)):
        h = {k: v[m] for k, v in h_ref.items()}
        eta = float(ref_sgd._learning_rate(schedule, jnp.float32(t[m]), h))
        c_ref = np.asarray(new["coef"][m], np.float64)
        b_ref = np.asarray(new["intercept"][m], np.float64)
        g = np.abs(coef[m].astype(np.float64) - c_ref).max() / eta
        for got, want in ((c[m], c_ref), (b[m], b_ref)):
            tol = TOL * eta * g + 2.0 ** -22 * np.abs(want) + 1e-12
            assert np.all(np.abs(got.numpy() - want) <= tol), (m, np.abs(got.numpy() - want).max())
    np.testing.assert_array_equal(tt.numpy(), np.asarray(new["t"]))
    if not fit_intercept:
        np.testing.assert_array_equal(b.numpy(), intercept)


# (M, K) at the kernel's column-tile edges, M*K in {4, 5, 8, 9, 16, 17}: the
# plain version's lane axis is what the kernel tiles, so hold it there too
EDGE_COHORTS = [(4, 1), (2, 2), (5, 1), (8, 1), (4, 2), (9, 1), (3, 3), (16, 1), (8, 2),
                (17, 1)]


@pytest.mark.parametrize("M,K", EDGE_COHORTS)
def test_cohort_step_ref_matches_packed_step_at_column_tile_edges(M, K):
    """Tolerance as above: each lane's loss rtol 1e-5, coef and intercept
    to 1e-5·eta·max|g| plus 2^-22 of each element, t equal."""
    rng = np.random.RandomState(100 * M + K)
    B, d, loss = 131, 7, "log_loss" if K == 1 else "hinge"
    x = rng.standard_normal((B, d)).astype(np.float32)
    y = -np.ones((B, K), np.float32)
    if K == 1:
        y[x @ rng.standard_normal(d) > 0] = 1.0
    else:
        y[np.arange(B), rng.randint(0, K, B)] = 1.0
    masks = rng.uniform(0.2, 2.0, (M, B)).astype(np.float32)
    masks[M // 2] = 0.0
    coef = (0.5 * rng.standard_normal((M, d, K))).astype(np.float32)
    intercept = (0.1 * rng.standard_normal((M, K))).astype(np.float32)
    t = (3.0 + np.arange(M)).astype(np.float32)
    hypers = np.stack([np.logspace(-4, -2, M), np.linspace(0.01, 0.05, M), np.full(M, 0.25),
                       np.linspace(20, 40, M), np.full(M, 0.15), np.full(M, 0.1),
                       np.full(M, 1.0)], 1).astype(np.float32)
    kw = dict(loss=loss, penalty="l2", schedule="optimal", fit_intercept=True)
    h_ref = {k: jnp.asarray(hypers[:, i]) for i, k in enumerate(k4.HYPER_KEYS)}
    states = {"coef": jnp.asarray(coef), "intercept": jnp.asarray(intercept),
              "t": jnp.asarray(t)}
    new, losses = ref_packing._packed_step_impl(states, jnp.asarray(x), jnp.asarray(y),
                                                jnp.asarray(masks), h_ref, **kw)
    c, b, tt = torch.tensor(coef), torch.tensor(intercept), torch.tensor(t)
    out = k5.cohort_step(torch.tensor(x), torch.tensor(y), torch.tensor(masks), c, b, tt,
                         torch.tensor(hypers), **kw)
    np.testing.assert_allclose(out[:, 0].numpy(), np.asarray(losses), rtol=TOL)
    for m in range(M):
        h = {k: v[m] for k, v in h_ref.items()}
        eta = float(ref_sgd._learning_rate("optimal", jnp.float32(t[m]), h))
        c_ref = np.asarray(new["coef"][m], np.float64)
        b_ref = np.asarray(new["intercept"][m], np.float64)
        g = np.abs(coef[m].astype(np.float64) - c_ref).max() / eta
        for got, want in ((c[m], c_ref), (b[m], b_ref)):
            tol = TOL * eta * g + 2.0 ** -22 * np.abs(want) + 1e-12
            assert np.all(np.abs(got.numpy() - want) <= tol), (m, np.abs(got.numpy() - want).max())
    np.testing.assert_array_equal(tt.numpy(), np.asarray(new["t"]))


def test_cohort_step_takes_a_broadcast_mask_and_rejects_bad_input():
    x, y, masks, coef, intercept, t, hypers = _lanes(1, "log_loss")
    args = [torch.tensor(a) for a in (x, y)]
    shared = torch.tensor(masks[0])[None, :].expand(4, x.shape[0])
    state = [torch.tensor(a) for a in (coef, intercept, t, hypers)]
    kw = dict(loss="log_loss", penalty="l2", schedule="optimal")
    out = k5.cohort_step(*args, shared, *[s.clone() for s in state], **kw)
    full = k5.cohort_step(*args, shared.contiguous(), *[s.clone() for s in state], **kw)
    torch.testing.assert_close(out, full, rtol=0, atol=0)
    with pytest.raises(ValueError, match="takes one target column"):
        k5.cohort_step(*args, shared, *state, loss="huber", penalty="l2", schedule="optimal")
    with pytest.raises(ValueError, match="state shapes"):
        k5.cohort_step(*args, shared[:3], *state, **kw)
    with pytest.raises(TypeError, match="float32"):
        k5.cohort_step(args[0].double(), args[1], shared, *state, **kw)
    with pytest.raises(ValueError, match="penalty"):
        k5.cohort_step(*args, shared, *state, loss="log_loss", penalty="l3", schedule="optimal")
    meta = [a.to("meta") for a in args] + [shared.to("meta")] + [s.to("meta") for s in state]
    with pytest.raises(ValueError, match="K5 runs on cuda or cpu"):
        k5.cohort_step(*meta, **kw)


def _blobs(seed, n=800, d=6, classes=2):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    W = rng.normal(size=(d, classes))
    y = np.argmax(X @ W + 0.3 * rng.logistic(size=(n, classes)), axis=1)
    if classes == 2:
        y = (X @ W[:, 0] + 0.5 * rng.logistic(size=n) > 0).astype(np.int64)
    return X, y


def _pair(make_ref, make_port, configs):
    return [make_ref(**c) for c in configs], [make_port(**c) for c in configs]


def _hold_models(port, ref, tol=TOL):
    for p, r in zip(port, ref):
        c_ref, b_ref = np.asarray(r.coef_, np.float64), np.asarray(r.intercept_, np.float64)
        scale = max(np.abs(c_ref).max(), 1e-30)
        assert np.abs(p.coef_ - c_ref).max() <= tol * scale
        assert np.abs(p.intercept_ - b_ref).max() <= tol * scale
        assert p.t_ == float(r.t_)
        np.testing.assert_allclose(float(p._loss_), float(r._loss_), rtol=tol)


CLS_CONFIGS = [dict(alpha=1e-4, eta0=0.1, learning_rate="constant"),
               dict(alpha=1e-3, eta0=0.3, learning_rate="constant"),
               dict(alpha=1e-2, eta0=0.5, learning_rate="constant", class_weight={0: 2.0}),
               dict(alpha=1e-4, eta0=0.7, learning_rate="constant", class_weight={1: 0.5})]


@pytest.mark.parametrize("classes", [2, 3])
def test_cohort_on_host_blocks_matches_reference(classes):
    X, y = _blobs(classes, classes=classes)
    configs = CLS_CONFIGS if classes == 2 else CLS_CONFIGS[:2]
    ref, port = _pair(RefSGDClassifier, SGDClassifier, configs)
    labels = np.unique(y)
    rc, pc = ref_packing.Cohort(ref, classes=labels), _packing.Cohort(port, classes=labels)
    for lo in range(0, 600, 200):
        rc.step(X[lo:lo + 200], y[lo:lo + 200])
        pc.step(X[lo:lo + 200], y[lo:lo + 200])
    np.testing.assert_array_equal(pc.packed_accuracy(X[600:], y[600:]),
                                  rc.packed_accuracy(X[600:], y[600:]))
    rc.finalize()
    pc.finalize()
    _hold_models(port, ref)
    assert _packing.DISPATCH_STATS == ref_packing.DISPATCH_STATS == {
        "dispatches": 3, "models_stepped": 3 * len(configs), "cohorts": 1,
        "score_dispatches": 1}
    # the members go on alone as if each had taken the cohort's steps
    for m in port:
        m.partial_fit(X[600:], y[600:])
    for m in ref:
        m.partial_fit(X[600:], y[600:])
    _hold_models(port, ref)


def test_cohort_on_device_blocks_matches_reference():
    """ShardedRows blocks (the search's device blocks): the targets are
    encoded on the device; 8 logical shards against the 8-device mesh."""
    mesh.set_n_shards(8)
    X, y = _blobs(5, n=803)
    ref, port = _pair(RefSGDClassifier, SGDClassifier, CLS_CONFIGS[:3])
    rc, pc = ref_packing.Cohort(ref, classes=[0, 1]), _packing.Cohort(port, classes=[0, 1])
    for lo, hi in ((0, 301), (301, 603)):
        rc.step(ref_shard_rows(X[lo:hi]), ref_shard_rows(y[lo:hi].astype(np.float32)))
        pc.step(shard_rows(X[lo:hi]), shard_rows(y[lo:hi].astype(np.float32)))
    Xt, yt = X[603:], y[603:].astype(np.float32)
    np.testing.assert_array_equal(pc.packed_accuracy(shard_rows(Xt), shard_rows(yt)),
                                  rc.packed_accuracy(ref_shard_rows(Xt), ref_shard_rows(yt)))
    rc.finalize()
    pc.finalize()
    _hold_models(port, ref)
    assert _packing.DISPATCH_STATS == ref_packing.DISPATCH_STATS


def _arrays(model):
    return {k: np.asarray(getattr(model, k)) for k in
            ("coef_", "intercept_", "t_", "n_features_in_")
            + (("classes_",) if hasattr(model, "classes_") else ())}


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_cohort_from_converted_warm_state_matches_reference(kind):
    """Each member warmed alone in the reference, carried into the port by
    the SGD converters, then both packages' cohorts step from that state."""
    if kind == "classifier":
        X, y = _blobs(7, n=900, classes=3)
        configs = [dict(alpha=a, learning_rate="invscaling", eta0=e)
                   for a, e in ((1e-4, 0.05), (1e-3, 0.1), (1e-2, 0.2))]
        ref = [RefSGDClassifier(**c) for c in configs]
        for m in ref:
            m.partial_fit(X[:300], y[:300], classes=np.unique(y))
        port = [sgd_classifier_from_reference(_arrays(m), **c) for m, c in zip(ref, configs)]
    else:
        rng = np.random.RandomState(8)
        X = rng.normal(size=(900, 5)).astype(np.float32)
        y = (X @ rng.normal(size=5) + 0.1 * rng.normal(size=900)).astype(np.float32)
        configs = [dict(alpha=a, loss="huber") for a in (1e-4, 1e-2)]
        ref = [RefSGDRegressor(**c) for c in configs]
        for m in ref:
            m.partial_fit(X[:300], y[:300])
        port = [sgd_regressor_from_reference(_arrays(m), **c) for m, c in zip(ref, configs)]
    rc, pc = ref_packing.Cohort(ref), _packing.Cohort(port)
    for lo in (300, 600):
        rc.step(X[lo:lo + 300], y[lo:lo + 300])
        pc.step(X[lo:lo + 300], y[lo:lo + 300])
    rc.finalize()
    pc.finalize()
    _hold_models(port, ref)
    assert all(m.t_ == 3.0 for m in port)


def test_regressor_cohort_matches_reference():
    rng = np.random.RandomState(2)
    X = rng.normal(size=(600, 4)).astype(np.float32)
    y = (X @ rng.normal(size=4) + 0.1 * rng.normal(size=600)).astype(np.float32)
    configs = [dict(alpha=a, loss=loss) for a in (1e-4, 1e-2) for loss in ("huber",)]
    configs += [dict(alpha=1e-3, loss="huber", epsilon=0.5)]
    ref, port = _pair(RefSGDRegressor, SGDRegressor, configs)
    rc, pc = ref_packing.Cohort(ref), _packing.Cohort(port)
    for lo in range(0, 600, 150):
        rc.step(X[lo:lo + 150], y[lo:lo + 150])
        pc.step(X[lo:lo + 150], y[lo:lo + 150])
    with pytest.raises(TypeError, match="classifier"):
        pc.packed_accuracy(X, y)
    rc.finalize()
    pc.finalize()
    _hold_models(port, ref)
    assert _packing.DISPATCH_STATS == ref_packing.DISPATCH_STATS


def test_pack_key_and_cohort_refusals_match_reference():
    pairs = [(dict(alpha=1e-4), dict(alpha=1e-2, eta0=0.5)),
             (dict(loss="hinge"), dict(loss="log_loss")),
             (dict(class_weight="balanced"), dict())]
    for a, b in pairs:
        same_ref = ref_packing.pack_key(RefSGDClassifier(**a)) == \
            ref_packing.pack_key(RefSGDClassifier(**b))
        same_port = _packing.pack_key(SGDClassifier(**a)) == _packing.pack_key(SGDClassifier(**b))
        assert same_ref == same_port
    assert _packing.pack_key(SGDClassifier(class_weight="balanced")) is None
    assert _packing.pack_key(object()) is None
    with pytest.raises(ValueError, match="empty cohort"):
        _packing.Cohort([])
    with pytest.raises(ValueError, match="not packable"):
        _packing.Cohort([SGDClassifier(loss="hinge"), SGDClassifier()])
    with pytest.raises(ValueError, match="alpha must be > 0"):
        _packing.Cohort([SGDClassifier(alpha=0.0), SGDClassifier()])
    X, y = _blobs(0, n=50)
    with pytest.raises(ValueError, match="classes must be provided"):
        _packing.Cohort([SGDClassifier(), SGDClassifier()]).step(X, y)
    c = _packing.Cohort([SGDClassifier(), SGDClassifier()])
    assert c.finalize() == c.models and _packing.DISPATCH_STATS["cohorts"] == 0
