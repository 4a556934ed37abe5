"""The port's blockwise voting ensembles (``dask_ml_tpu_torch/ensemble/``)
and K5′'s plain version (``ops/ensemble.py :: group_step_ref``) against the
JAX reference, on the CPU: the reference on the 8 virtual CPU devices of
the tier-1 conftest, the port on the CPU at 8 logical shards where the
input is a ``ShardedRows``, the same seeded numpy inputs.

Tolerances.  ``group_step_ref`` against ``jax.vmap`` of the reference's
``sgd_step`` (two steps, ragged windows, an all-padding member): coef,
intercept and each member's (mean loss, Σ mask) to rtol 1e-5 with atol
1e-6, t equal.  The ensembles at fixed work (``tol=None``) and with a
``tol``: each member's ``coef_`` and ``intercept_`` to rtol 1e-5 with an
atol of 1e-6·max|coef_ref| (float32 rounding over five steps), equal
``n_iter_``; ``predict`` equal (no row's vote is within reach of the
rounding on these seeds); ``predict_proba`` to atol 1e-6; ``score`` to
1e-6.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu.ensemble import BlockwiseVotingClassifier as RefBVC
from dask_ml_tpu.ensemble import BlockwiseVotingRegressor as RefBVR
from dask_ml_tpu.linear_model import SGDClassifier as RefSGDClassifier
from dask_ml_tpu.linear_model import SGDRegressor as RefSGDRegressor
from dask_ml_tpu.linear_model import _sgd as ref_sgd
from dask_ml_tpu_torch import (
    BlockwiseVotingClassifier, BlockwiseVotingRegressor, SGDClassifier, SGDRegressor,
    blockwise_from_reference)
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.ensemble import _blockwise
from dask_ml_tpu_torch.ops import ensemble as k5p
from dask_ml_tpu_torch.ops import sgd as k4

LOSSES = ("log_loss", "hinge", "squared_hinge", "modified_huber", "squared_error", "huber")
PENALTIES = ("l2", "l1", "elasticnet", None)
SCHEDULES = ("constant", "optimal", "invscaling", "adaptive")
TOL = 1e-5
KW = dict(max_iter=5, tol=None, random_state=0)


@pytest.fixture(autouse=True)
def _cpu():
    mesh.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    mesh.set_device(None)
    mesh.set_n_shards(1)
    torch.set_num_threads(threads)


def _windows(n, M):
    """The reference's spans, window size and starts (pulled left)."""
    bounds = np.linspace(0, n, M + 1, dtype=int)
    spans = [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    size = max(b - a for a, b in spans)
    return spans, size, tuple(min(a, n - size) for a, _ in spans)


def _group_inputs(seed, loss, K, M=4, n=203, d=5):
    """x, targets, per-member masks (fractional, the last member's own rows
    all padding), a state and hyperparameters."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if loss in k4.CLASSIFIER_LOSSES:
        idx = rng.randint(0, max(K, 2), n)
        y = (2.0 * np.eye(max(K, 2))[idx] - 1.0)[:, -K:].astype(np.float32)
    else:
        y = (2 * rng.standard_normal((n, 1))).astype(np.float32)
    mask_full = (2 * rng.rand(n)).astype(np.float32)
    mask_full[rng.rand(n) < 0.1] = 0.0
    spans, size, starts = _windows(n, M)
    mask_full[spans[-1][0]:] = 0.0
    valid = np.zeros((M, size), np.float32)
    for b, ((lo, hi), st) in enumerate(zip(spans, starts)):
        valid[b, lo - st:hi - st] = 1.0
    masks = np.stack([mask_full[s:s + size] for s in starts]) * valid
    coef = (rng.standard_normal((M, d, K)) / d ** 0.5).astype(np.float32)
    intercept = (0.1 * rng.standard_normal((M, K))).astype(np.float32)
    t = (3.0 * np.arange(M)).astype(np.float32)
    hypers = np.tile(np.float32([1e-3, 0.05, 0.25, 2e4, 0.3, 0.5, 0.2]), (M, 1))
    hypers[:, 0] *= np.linspace(0.5, 2.0, M, dtype=np.float32)
    return x, y, starts, size, masks, coef, intercept, t, hypers


def _group_cases():
    cases = []
    for i, (loss, penalty) in enumerate((lo, p) for lo in LOSSES for p in PENALTIES):
        for K in ((1, 3) if loss in k4.CLASSIFIER_LOSSES else (1,)):
            cases.append((loss, penalty, SCHEDULES[i % 4], K, i % 3 != 2))
    return cases


@pytest.mark.parametrize("loss,penalty,schedule,K,fit_intercept", _group_cases())
def test_group_step_ref_matches_the_reference_vmap(loss, penalty, schedule, K, fit_intercept):
    x, y, starts, size, masks, coef, intercept, t, hypers = _group_inputs(
        len(loss) + K, loss, K)
    keys = ref_sgd._HYPER_KEYS
    ref_h = {k: jnp.asarray(hypers[:, i]) for i, k in enumerate(keys)}
    step = partial(ref_sgd.sgd_step, loss=loss, penalty=penalty, schedule=schedule,
                   fit_intercept=fit_intercept)
    xb = jnp.stack([x[s:s + size] for s in starts])
    yb = jnp.stack([y[s:s + size] for s in starts])
    state = {"coef": jnp.asarray(coef), "intercept": jnp.asarray(intercept),
             "t": jnp.asarray(t)}
    port = [torch.tensor(a) for a in (coef, intercept, t)]
    calls = k5p.group_step_ref.calls
    for _ in range(2):
        state, losses = jax.vmap(step)(state, xb, yb, jnp.asarray(masks), ref_h)
        out = k5p.group_step(torch.tensor(x), torch.tensor(y), starts, torch.tensor(masks),
                             *port, torch.tensor(hypers), loss=loss, penalty=penalty,
                             schedule=schedule, fit_intercept=fit_intercept)
        np.testing.assert_allclose(out[:, 0].numpy(), np.asarray(losses), rtol=TOL, atol=1e-6)
        np.testing.assert_allclose(out[:, 1].numpy(), masks.sum(1), rtol=TOL)
    assert k5p.group_step_ref.calls == calls + 2 and k5p.group_step.launches == 0
    np.testing.assert_allclose(port[0].numpy(), np.asarray(state["coef"]), rtol=TOL, atol=1e-6)
    np.testing.assert_allclose(port[1].numpy(), np.asarray(state["intercept"]), rtol=TOL,
                               atol=1e-6)
    np.testing.assert_array_equal(port[2].numpy(), np.asarray(state["t"]))
    assert out[-1, 1] == 0.0  # the all-padding member: count 0, no division by it


@pytest.mark.parametrize("bad", ["starts", "masks", "loss", "K", "device"])
def test_group_step_rejects_what_the_kernel_cannot_take(bad):
    x, y, starts, size, masks, coef, intercept, t, hypers = _group_inputs(0, "log_loss", 3)
    args = [torch.tensor(a) for a in (x, y)] + [starts] + [
        torch.tensor(a) for a in (masks, coef, intercept, t, hypers)]
    kw = dict(loss="log_loss", penalty="l2", schedule="optimal")
    if bad == "starts":
        args[2] = (0, 1, 2, x.shape[0] - size + 1)
    elif bad == "masks":
        args[3] = args[3][:-1]  # one member short of the state
    elif bad == "loss":
        kw["loss"] = "squared_error"
    elif bad == "K":
        args[4] = args[4][:, :, :2].contiguous()
    else:
        args[0] = args[0].to("meta")
    with pytest.raises((ValueError, TypeError)):
        k5p.group_step(*args, **kw)


def _data(seed=0, n=1003, d=6):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d)
    y2 = (X @ w + 0.3 * rng.standard_normal(n) > 0).astype(np.int64)
    y3 = np.argmax(X[:, :3] + 0.3 * rng.standard_normal((n, 3)), 1)
    yr = (X @ w + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return X, y2, y3, yr


def _hold_members(port, ref):
    assert len(port.estimators_) == len(ref.estimators_)
    for a, b in zip(port.estimators_, ref.estimators_):
        cb = np.asarray(b.coef_)
        np.testing.assert_allclose(a.coef_, cb, rtol=TOL, atol=1e-6 * np.abs(cb).max())
        np.testing.assert_allclose(a.intercept_, np.asarray(b.intercept_), rtol=TOL,
                                   atol=1e-6 * np.abs(cb).max())
        assert a.n_iter_ == b.n_iter_
        assert a.t_ == pytest.approx(float(b.t_))


def _inputs(X, y, layout):
    """(port X, port y, reference X, reference y) as numpy or ShardedRows."""
    if layout == "numpy":
        return X, y, X, y
    if layout == "sharded_x":
        return shard_rows(X), y, ref_shard_rows(X), y
    return shard_rows(X), shard_rows(y), ref_shard_rows(X), ref_shard_rows(y)


CLASSIFIER_CASES = [
    ("binary", "hard", "hinge", None), ("binary", "soft", "log_loss", None),
    ("multi", "hard", "squared_hinge", None), ("multi", "soft", "modified_huber", None),
    ("binary", "hard", "log_loss", 1e-3),
]


# each case on host arrays and on ShardedRows; the first also with a host y
# against a padded X
CLASSIFIER_LAYOUTS = [case + (layout,) for i, case in enumerate(CLASSIFIER_CASES)
                      for layout in ("numpy", "sharded") + (("sharded_x",) if i == 0 else ())]


@pytest.mark.parametrize("target,voting,loss,tol,layout", CLASSIFIER_LAYOUTS)
def test_classifier_matches_the_reference(target, voting, loss, tol, layout):
    X, y2, y3, _ = _data()
    y = y2 if target == "binary" else y3
    kw = dict(KW, tol=tol, max_iter=30 if tol else 5)
    with mesh.use_device("cpu", n_shards=8):
        Xp, yp, Xr, yr = _inputs(X, y, layout)
        launches = k5p.group_step_ref.calls
        port = BlockwiseVotingClassifier(SGDClassifier(loss=loss, **kw), voting=voting,
                                         n_blocks=5).fit(Xp, yp)
        ref = RefBVC(RefSGDClassifier(loss=loss, **kw), voting=voting, n_blocks=5).fit(Xr, yr)
        assert k5p.group_step_ref.calls - launches == port.estimators_[0].n_iter_
        _hold_members(port, ref)
        np.testing.assert_array_equal(port.classes_, np.asarray(ref.classes_))
        np.testing.assert_array_equal(port.predict(Xp), np.asarray(ref.predict(Xr)))
        np.testing.assert_array_equal(port.predict(X), np.asarray(ref.predict(X)))
        if voting == "soft":
            np.testing.assert_allclose(port.predict_proba(Xp), np.asarray(ref.predict_proba(Xr)),
                                       rtol=0, atol=1e-6)
        assert port.score(Xp, yp) == pytest.approx(float(ref.score(Xr, yr)), abs=1e-6)


@pytest.mark.parametrize("layout", ["numpy", "sharded_x", "sharded"])
def test_regressor_matches_the_reference(layout):
    X, _, _, yr = _data(1)
    with mesh.use_device("cpu", n_shards=8):
        Xp, yp, Xr, yrr = _inputs(X, yr, layout)
        kw = dict(KW, learning_rate="constant", eta0=0.05)
        port = BlockwiseVotingRegressor(SGDRegressor(**kw), n_blocks=4).fit(Xp, yp)
        ref = RefBVR(RefSGDRegressor(**kw), n_blocks=4).fit(Xr, yrr)
        _hold_members(port, ref)
        np.testing.assert_allclose(np.asarray(port.predict(Xp)), np.asarray(ref.predict(Xr)),
                                   rtol=1e-5, atol=1e-5)
        assert port.score(Xp, yp) == pytest.approx(float(ref.score(Xr, yrr)), abs=1e-5)


def test_packed_fit_classes_come_from_the_labels_not_the_padding():
    """A host y shorter than a padded X: the reference pads y with zeros
    and counts 0 as a class of its members (its ensemble's classes_ then
    lack it); the port's members take the classes of the labels given."""
    X, y2, _, _ = _data(2, n=1001)
    y = y2 + 1  # labels {1, 2}: no 0
    with mesh.use_device("cpu", n_shards=8):
        port = BlockwiseVotingClassifier(SGDClassifier(**KW), voting="soft",
                                         n_blocks=4).fit(shard_rows(X), y)
        ref = RefBVC(RefSGDClassifier(**KW), voting="soft", n_blocks=4).fit(
            ref_shard_rows(X), y)
    assert [m.classes_.tolist() for m in port.estimators_] == [[1, 2]] * 4
    assert np.asarray(ref.estimators_[0].classes_).tolist() == [0, 1, 2]
    with pytest.raises(ValueError, match="outside"):
        ref.predict_proba(X)
    assert port.predict_proba(X).shape == (1001, 2)


@pytest.mark.parametrize("voting", ["hard", "soft"])
def test_blockwise_from_reference_round_trips(voting):
    X, _, y3, _ = _data(3)
    kw = dict(KW, loss="log_loss")
    ref = RefBVC(RefSGDClassifier(**kw), voting=voting, n_blocks=3).fit(X, y3)
    arrays = {"classes_": np.asarray(ref.classes_), "n_features_in_": ref.n_features_in_,
              "estimators_": [{"coef_": np.asarray(m.coef_), "intercept_": np.asarray(
                  m.intercept_), "t_": float(m.t_), "classes_": np.asarray(m.classes_),
                  "n_features_in_": m.n_features_in_, "n_iter_": m.n_iter_}
                  for m in ref.estimators_]}
    port = blockwise_from_reference(arrays, estimator=SGDClassifier(**kw), voting=voting,
                                    n_blocks=3)
    assert [m.n_iter_ for m in port.estimators_] == [5, 5, 5]
    np.testing.assert_array_equal(port.predict(X), np.asarray(ref.predict(X)))
    if voting == "soft":
        np.testing.assert_allclose(port.predict_proba(X), np.asarray(ref.predict_proba(X)),
                                   atol=1e-6)
    _, _, _, yr = _data(4)
    reg = RefBVR(RefSGDRegressor(**KW), n_blocks=2).fit(X, yr)
    arrays = {"n_features_in_": reg.n_features_in_, "estimators_": [
        {"coef_": np.asarray(m.coef_), "intercept_": np.asarray(m.intercept_),
         "t_": float(m.t_), "n_features_in_": m.n_features_in_} for m in reg.estimators_]}
    back = blockwise_from_reference(arrays, estimator=SGDRegressor(**KW), n_blocks=2)
    np.testing.assert_allclose(np.asarray(back.predict(X)), np.asarray(reg.predict(X)),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="missing"):
        blockwise_from_reference({"estimators_": []}, estimator=SGDClassifier())


FALLBACKS = {
    "class_weight": lambda m: m(class_weight={0: 1.0, 1: 3.0}, **KW),
    "adaptive": lambda m: m(learning_rate="adaptive", eta0=0.1, max_iter=20, tol=1e-2,
                            random_state=0),
    "n_blocks_1": lambda m: m(**KW),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_unpackable_members_fit_a_block_at_a_time_like_the_reference(case):
    X, y2, _, _ = _data(5, n=400)
    n_blocks = 1 if case == "n_blocks_1" else 3
    calls = k5p.group_step_ref.calls
    port = BlockwiseVotingClassifier(FALLBACKS[case](SGDClassifier), n_blocks=n_blocks).fit(X, y2)
    ref = RefBVC(FALLBACKS[case](RefSGDClassifier), n_blocks=n_blocks).fit(X, y2)
    assert k5p.group_step_ref.calls == calls
    _hold_members(port, ref)
    np.testing.assert_array_equal(port.predict(X), np.asarray(ref.predict(X)))


def test_early_stopping_members_fit_a_block_at_a_time():
    """The held-out split is drawn from a torch generator (the reference
    draws from jax.random), so the members are held by route and shape."""
    X, y2, _, _ = _data(6, n=600)
    calls = k5p.group_step_ref.calls
    est = SGDClassifier(early_stopping=True, max_iter=10, tol=1e-3, random_state=0)
    port = BlockwiseVotingClassifier(est, n_blocks=3).fit(X, y2)
    assert k5p.group_step_ref.calls == calls
    assert len(port.estimators_) == 3 and all(m.n_iter_ >= 1 for m in port.estimators_)
    assert port.score(X, y2) > 0.8


def test_a_scikit_learn_tree_fits_in_the_thread_pool_like_the_reference():
    from sklearn.tree import DecisionTreeClassifier, DecisionTreeRegressor

    X, y2, _, yr = _data(7, n=500)
    port = BlockwiseVotingClassifier(DecisionTreeClassifier(max_depth=4, random_state=0),
                                     voting="soft", n_blocks=4).fit(shard_rows(X), y2)
    ref = RefBVC(DecisionTreeClassifier(max_depth=4, random_state=0), voting="soft",
                 n_blocks=4).fit(X, y2)
    np.testing.assert_array_equal(port.predict(X), np.asarray(ref.predict(X)))
    np.testing.assert_allclose(port.predict_proba(X), np.asarray(ref.predict_proba(X)))
    assert port.score(X, y2) == pytest.approx(float(ref.score(X, y2)))
    reg = BlockwiseVotingRegressor(DecisionTreeRegressor(max_depth=4, random_state=0),
                                   n_blocks=4).fit(X, yr)
    rref = RefBVR(DecisionTreeRegressor(max_depth=4, random_state=0), n_blocks=4).fit(X, yr)
    np.testing.assert_allclose(reg.predict(X), np.asarray(rref.predict(X)), rtol=1e-6)


def test_error_paths():
    X, y2, y3, _ = _data(8, n=300)
    with pytest.raises(ValueError, match="voting"):
        BlockwiseVotingClassifier(SGDClassifier(**KW), voting="mean").fit(X, y2)
    hard = BlockwiseVotingClassifier(SGDClassifier(**KW), n_blocks=3).fit(X, y2)
    with pytest.raises(AttributeError, match="soft"):
        hard.predict_proba(X)
    with pytest.raises(ValueError, match="n_blocks"):
        BlockwiseVotingClassifier(SGDClassifier(**KW), n_blocks=0).fit(X, y2)
    narrow = BlockwiseVotingClassifier(SGDClassifier(**KW), voting="soft", classes=[0, 1],
                                       n_blocks=3).fit(X, y3)
    with pytest.raises(ValueError, match="outside"):
        narrow.predict_proba(X)


def test_packed_fit_never_reads_a_device_x_to_the_host(monkeypatch):
    """The packed path slices the windows where X lies: it calls no
    ``unshard`` and reads no tensor of X's rows back (the class inventory
    and the label check read unique values and one scalar)."""
    X, y2, _, _ = _data(9)
    read = []
    cpu = torch.Tensor.cpu

    def counted(self, *a, **k):
        read.append(self.numel())
        return cpu(self, *a, **k)

    def forbidden(*a, **k):  # pragma: no cover - must not run
        raise AssertionError("unshard called on the packed fit path")

    with mesh.use_device("cpu", n_shards=8):
        sX, sy = shard_rows(X), shard_rows(y2.astype(np.float32))
        monkeypatch.setattr(_blockwise, "unshard", forbidden)
        monkeypatch.setattr(torch.Tensor, "cpu", counted)
        ens = BlockwiseVotingClassifier(SGDClassifier(max_iter=20, tol=None, random_state=0),
                                        n_blocks=4).fit(sX, sy)
        monkeypatch.undo()
    assert len(ens.estimators_) == 4 and max(read, default=0) < 16
    assert sorted(ens.classes_.tolist()) == [0.0, 1.0]
    assert (ens.predict(X) == y2).mean() > 0.7
