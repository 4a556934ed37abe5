"""The port's adaptive searches (``dask_ml_tpu_torch/model_selection/``:
``SuccessiveHalvingSearchCV``, ``HyperbandSearchCV``,
``IncrementalSearchCV``, ``InverseDecaySearchCV``, ``train_test_split``)
against the JAX reference's on the CPU, the reference run with
``DASK_ML_TPU_SEARCH_CONCURRENCY=off`` (its serialized round loop, the
one the port runs) on the 8 virtual CPU devices of the tier-1 conftest.

Both packages get the same numpy inputs (host blocks, or ``ShardedRows``
at 8 shards), sample the same candidates and split the same rows.
Compared: ``metadata`` and ``metadata_``, ``cv_results_`` params,
``partial_fit_calls`` and ``test_score`` (atol 1e-6: each is a count of
held-out hits over the split's rows, so any flipped row would show),
``best_params_``, ``best_index_``, the best model's ``coef_`` (≤
1e-4·‖coef‖∞) and ``DISPATCH_STATS``.  The seeds were chosen so that no
held-out prediction differs between the packages (the exact scores above
prove it); tied scores then rank alike in both, since both sort stably.
"""

import numpy as np
import pytest
import torch

from dask_ml_tpu import model_selection as ref_ms
from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu.core.sharded import unshard as ref_unshard
from dask_ml_tpu.linear_model import SGDClassifier as RefSGDClassifier
from dask_ml_tpu.linear_model import SGDRegressor as RefSGDRegressor
from dask_ml_tpu.model_selection import _packing as ref_packing
from dask_ml_tpu_torch import model_selection as ms
from dask_ml_tpu_torch import SGDClassifier, SGDRegressor
from dask_ml_tpu_torch.core import mesh, shard_rows, unshard
from dask_ml_tpu_torch.metrics import scorer
from dask_ml_tpu_torch.model_selection import _packing

ALPHAS = {"alpha": np.logspace(-6, 0, 50), "penalty": ["l2"]}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("DASK_ML_TPU_SEARCH_CONCURRENCY", "off")
    mesh.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    _packing.reset_dispatch_stats()
    ref_packing.reset_dispatch_stats()
    yield
    mesh.set_device(None)
    mesh.set_n_shards(1)
    torch.set_num_threads(threads)


def _data(seed=0, n=2000, d=8):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (X @ rng.normal(size=d) + 0.5 * rng.logistic(size=n) > 0).astype(np.int64)
    return X, y


def _hold(port, ref):
    assert port.cv_results_["params"] == ref.cv_results_["params"]
    assert port.cv_results_["partial_fit_calls"] == ref.cv_results_["partial_fit_calls"]
    np.testing.assert_allclose(port.cv_results_["test_score"], ref.cv_results_["test_score"],
                               rtol=0, atol=1e-6)
    assert port.cv_results_["rank_test_score"] == ref.cv_results_["rank_test_score"]
    assert port.best_params_ == ref.best_params_
    assert port.best_index_ == ref.best_index_
    assert abs(port.best_score_ - ref.best_score_) <= 1e-6
    assert port.n_models_ == ref.n_models_
    c_ref = np.asarray(ref.best_estimator_.coef_, np.float64)
    assert np.abs(port.best_estimator_.coef_ - c_ref).max() <= 1e-4 * np.abs(c_ref).max()
    assert _packing.DISPATCH_STATS == ref_packing.DISPATCH_STATS
    # history_ is ordered by wall time: compare its records, not their order
    assert sorted((r["model_id"], r["partial_fit_calls"]) for r in port.history_) == \
        sorted((r["model_id"], r["partial_fit_calls"]) for r in ref.history_)
    assert {k: [r["partial_fit_calls"] for r in v] for k, v in port.model_history_.items()} == \
        {k: [r["partial_fit_calls"] for r in v] for k, v in ref.model_history_.items()}


@pytest.mark.parametrize("max_iter", [9, 27])
def test_hyperband_matches_reference(max_iter):
    X, y = _data()
    kw = dict(max_iter=max_iter, random_state=0, chunk_size=256, test_size=0.2)
    ref = ref_ms.HyperbandSearchCV(RefSGDClassifier(tol=None, random_state=0), ALPHAS, **kw)
    port = ms.HyperbandSearchCV(SGDClassifier(tol=None, random_state=0), ALPHAS, **kw)
    assert port.metadata == ref.metadata
    ref.fit(X, y, classes=[0, 1])
    port.fit(X, y, classes=[0, 1])
    assert port.metadata_ == ref.metadata_ == port.metadata
    _hold(port, ref)
    assert [r["bracket"] for r in port.model_history_[0]] == \
        [r["bracket"] for r in ref.model_history_[0]]
    assert _packing.DISPATCH_STATS["dispatches"] < _packing.DISPATCH_STATS["models_stepped"]
    np.testing.assert_array_equal(port.predict(X[:50]), np.asarray(ref.predict(X[:50])))
    np.testing.assert_allclose(port.predict_proba(X[:50]).numpy(),
                               np.asarray(ref.predict_proba(X[:50])), atol=1e-4)
    assert abs(port.score(X[:400], y[:400]) - float(ref.score(X[:400], y[:400]))) <= 1e-6


@pytest.mark.parametrize("max_iter", [1, 2, 3, 5, 9, 10, 26, 27, 28, 81, 100, 243])
@pytest.mark.parametrize("eta", [2, 3, 4])
def test_hyperband_metadata_matches_reference(max_iter, eta):
    ref = ref_ms.HyperbandSearchCV(None, {}, max_iter=max_iter, aggressiveness=eta)
    port = ms.HyperbandSearchCV(None, {}, max_iter=max_iter, aggressiveness=eta)
    assert port.metadata == ref.metadata


def test_hyperband_on_device_blocks_matches_reference():
    """ShardedRows in: device blocks, the held-out split gathered on the
    device and scored there, 8 shards."""
    mesh.set_n_shards(8)
    X, y = _data(3, n=1603)
    kw = dict(max_iter=4, random_state=1, chunk_size=200, test_size=0.25)
    ref = ref_ms.HyperbandSearchCV(RefSGDClassifier(tol=None, random_state=0), ALPHAS, **kw)
    port = ms.HyperbandSearchCV(SGDClassifier(tol=None, random_state=0), ALPHAS, **kw)
    yf = y.astype(np.float32)
    ref.fit(ref_shard_rows(X), ref_shard_rows(yf), classes=[0.0, 1.0])
    port.fit(shard_rows(X), shard_rows(yf), classes=[0.0, 1.0])
    assert port.metadata_ == ref.metadata_ == port.metadata
    _hold(port, ref)


def test_successive_halving_matches_reference():
    X, y = _data(1)
    params = {"alpha": np.logspace(-6, 0, 20), "loss": ["hinge"],
              "learning_rate": ["constant"], "eta0": [0.05, 0.2]}
    kw = dict(n_initial_parameters=18, n_initial_iter=1, max_iter=9, aggressiveness=3,
              random_state=2, chunk_size=300, test_size=0.2)
    ref = ref_ms.SuccessiveHalvingSearchCV(RefSGDClassifier(tol=None), params, **kw)
    port = ms.SuccessiveHalvingSearchCV(SGDClassifier(tol=None), params, **kw)
    ref.fit(X, y, classes=[0, 1])
    port.fit(X, y, classes=[0, 1])
    _hold(port, ref)


def test_incremental_search_with_patience_matches_reference():
    X, y = _data(2)
    kw = dict(n_initial_parameters=12, max_iter=9, patience=3, tol=1e-3, fits_per_score=2,
              random_state=4, chunk_size=250, test_size=0.2)
    ref = ref_ms.IncrementalSearchCV(RefSGDClassifier(tol=None, random_state=0), ALPHAS, **kw)
    port = ms.IncrementalSearchCV(SGDClassifier(tol=None, random_state=0), ALPHAS, **kw)
    ref.fit(X, y, classes=[0, 1])
    port.fit(X, y, classes=[0, 1])
    _hold(port, ref)


def test_single_model_bursts_stream_through_the_pipeline(monkeypatch):
    """Models of distinct pack keys train alone; with ``fits_per_score=3``
    each burst of calls goes through ``stream_partial_fit`` (depth 2, the
    knob's default), with the bits of the serial loop (depth 0) and the
    reference's records."""
    from dask_ml_tpu_torch.pipeline import DEPTH_ENV, pipeline_report, reset_pipeline_stats

    X, y = _data(3)
    params = {"loss": ["hinge", "log_loss", "modified_huber"],
              "learning_rate": ["constant", "optimal"], "eta0": [0.05]}
    kw = dict(n_initial_parameters=6, max_iter=9, fits_per_score=3, random_state=1,
              chunk_size=250, test_size=0.2)
    ref = ref_ms.IncrementalSearchCV(RefSGDClassifier(tol=None, random_state=0), params, **kw)
    ref.fit(X, y, classes=[0, 1])
    fits = []
    for depth in ("0", "2"):
        monkeypatch.setenv(DEPTH_ENV, depth)
        reset_pipeline_stats()
        fits.append(ms.IncrementalSearchCV(SGDClassifier(tol=None, random_state=0), params,
                                           **kw).fit(X, y, classes=[0, 1]))
        streams = pipeline_report().get("cumulative", {}).get("streams", 0)
        assert (streams > 0) == (depth == "2")
    _hold(fits[1], ref)
    assert fits[0].cv_results_["test_score"] == fits[1].cv_results_["test_score"]
    np.testing.assert_array_equal(fits[0].best_estimator_.coef_, fits[1].best_estimator_.coef_)


def test_inverse_decay_search_matches_reference():
    X, y = _data(4)
    kw = dict(n_initial_parameters=8, max_iter=5, decay_rate=1.0, random_state=5,
              chunk_size=250, test_size=0.2)
    ref = ref_ms.InverseDecaySearchCV(RefSGDClassifier(tol=None, random_state=0), ALPHAS, **kw)
    port = ms.InverseDecaySearchCV(SGDClassifier(tol=None, random_state=0), ALPHAS, **kw)
    ref.fit(X, y, classes=[0, 1])
    port.fit(X, y, classes=[0, 1])
    _hold(port, ref)


def test_regressor_search_and_named_scorer_match_reference():
    """SGDRegressor cohorts score model by model (no packed accuracy);
    ``scoring="r2"`` takes the scorer registry."""
    rng = np.random.RandomState(6)
    X = rng.normal(size=(1500, 6)).astype(np.float32)
    y = (X @ rng.normal(size=6) + 0.3 * rng.normal(size=1500)).astype(np.float32)
    params = {"alpha": np.logspace(-5, 0, 12), "loss": ["huber", "squared_error"]}
    for scoring in (None, "r2"):
        _packing.reset_dispatch_stats()
        ref_packing.reset_dispatch_stats()
        kw = dict(n_initial_parameters=8, max_iter=4, random_state=7, chunk_size=300,
                  test_size=0.2, scoring=scoring)
        ref = ref_ms.IncrementalSearchCV(RefSGDRegressor(tol=None, random_state=0), params, **kw)
        port = ms.IncrementalSearchCV(SGDRegressor(tol=None, random_state=0), params, **kw)
        ref.fit(X, y)
        port.fit(X, y)
        assert port.cv_results_["params"] == ref.cv_results_["params"]
        np.testing.assert_allclose(port.cv_results_["test_score"],
                                   ref.cv_results_["test_score"], rtol=0, atol=1e-5)
        assert port.best_index_ == ref.best_index_
        assert _packing.DISPATCH_STATS == ref_packing.DISPATCH_STATS
        assert _packing.DISPATCH_STATS["score_dispatches"] == 0


def test_accuracy_scorer_scores_model_by_model_as_reference():
    X, y = _data(8, n=1200)
    kw = dict(max_iter=3, random_state=0, chunk_size=200, scoring="accuracy")
    ref = ref_ms.HyperbandSearchCV(RefSGDClassifier(tol=None, random_state=0), ALPHAS, **kw)
    port = ms.HyperbandSearchCV(SGDClassifier(tol=None, random_state=0), ALPHAS, **kw)
    ref.fit(X, y, classes=[0, 1])
    port.fit(X, y, classes=[0, 1])
    _hold(port, ref)
    assert _packing.DISPATCH_STATS["score_dispatches"] == 0


@pytest.mark.parametrize("kind", ["host", "tensor", "sharded"])
@pytest.mark.parametrize("test_size,train_size", [(None, None), (0.3, None), (None, 500),
                                                  (211, 0.5)])
def test_train_test_split_takes_the_reference_rows(kind, test_size, train_size):
    mesh.set_n_shards(8)
    rng = np.random.RandomState(9)
    X = rng.normal(size=(1003, 4)).astype(np.float32)
    y = np.arange(1003).astype(np.float32)
    kw = dict(test_size=test_size, train_size=train_size, random_state=11)
    want = ref_ms.train_test_split(X, y, **kw)
    if kind == "sharded":
        got = ms.train_test_split(shard_rows(X), shard_rows(y), **kw)
        ref_dev = ref_ms.train_test_split(ref_shard_rows(X), ref_shard_rows(y), **kw)
        for g, r in zip(got, ref_dev):
            assert g.n_samples == r.n_samples and g.padded == r.padded
            np.testing.assert_array_equal(g.mask.numpy(), np.asarray(r.mask))
        got = [unshard(g) for g in got]
        want = [ref_unshard(r) for r in ref_dev]
    elif kind == "tensor":
        got = [g.numpy() for g in ms.train_test_split(torch.tensor(X), torch.tensor(y), **kw)]
    else:
        got = ms.train_test_split(X, y, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_train_test_split_refusals():
    X = np.zeros((10, 2))
    with pytest.raises(NotImplementedError, match="stratify"):
        ms.train_test_split(X, np.arange(10), stratify=np.arange(10) % 2)
    with pytest.raises(ValueError, match="same length"):
        ms.train_test_split(X, np.arange(9))
    with pytest.raises(ValueError, match="Degenerate"):
        ms.train_test_split(X, test_size=10)
    with pytest.raises(TypeError, match="Unexpected"):
        ms.train_test_split(X, foo=1)
    a, b = ms.train_test_split(X, shuffle=False, test_size=3)
    assert a.shape == (7, 2) and b.shape == (3, 2)


def test_splitters_match_reference():
    X = np.zeros((23, 2))
    for ours, theirs in ((ms.ShuffleSplit(4, test_size=0.3, random_state=2),
                          ref_ms.ShuffleSplit(4, test_size=0.3, random_state=2)),
                         (ms.KFold(4, shuffle=True, random_state=3),
                          ref_ms.KFold(4, shuffle=True, random_state=3)),
                         (ms.KFold(5), ref_ms.KFold(5))):
        for (a, b), (c, d) in zip(ours.split(X), theirs.split(X)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
        assert ours.get_n_splits() == theirs.get_n_splits()


def test_what_is_not_ported_raises():
    X, y = _data(n=200)
    hb = ms.HyperbandSearchCV(SGDClassifier(), ALPHAS, max_iter=3, checkpoint="ck")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        hb.fit(X, y, classes=[0, 1])
    assert scorer.get_scorer("f1") is scorer.SCORERS["f1"]  # ported with the metrics
    with pytest.raises(ValueError, match="not a valid scoring"):
        scorer.get_scorer("nope")
    with pytest.raises(TypeError, match="no score method"):
        scorer.check_scoring(object())
    with pytest.raises(ValueError, match="y is required"):
        ms.IncrementalSearchCV(SGDClassifier(), ALPHAS).fit(X)
    with pytest.raises(ValueError, match="n_initial_iter"):
        ms.SuccessiveHalvingSearchCV(SGDClassifier(tol=None), ALPHAS, max_iter=3).fit(
            X, y, classes=[0, 1])
