"""The port's streaming pieces against the JAX reference's, on the CPU: the
bucket policy (``programs/bucket.py``), ``_partial.fit`` and
``_partial.predict``, the ``Incremental`` and ``ParallelPostFit`` wrappers
around each package's own SGD, the device-born block stream, and the SGD
converters.

Tolerances: the bucket policy, the pads and the block visit order equal;
fitted estimators as in ``test_torch_sgd.py`` (``coef_`` and
``intercept_`` to ‖Δ‖∞ ≤ 1e-4·‖coef_ref‖∞, ``t_`` equal, predictions equal
off rows within 1e-4 of a decision boundary, none on these seeds);
``stream_classification_blocks`` draws from a ``torch.Generator``, so it
is held by its shapes, masks, determinism and label balance, not against
the reference's ``jax.random`` bits.
"""

import re

import numpy as np
import pytest
import torch

from dask_ml_tpu import _partial as ref_partial
from dask_ml_tpu import programs as ref_programs
from dask_ml_tpu.linear_model import SGDClassifier as RefSGDClassifier
from dask_ml_tpu.linear_model import SGDRegressor as RefSGDRegressor
from dask_ml_tpu.wrappers import Incremental as RefIncremental
from dask_ml_tpu.wrappers import ParallelPostFit as RefParallelPostFit
from dask_ml_tpu_torch import (
    Incremental, ParallelPostFit, SGDClassifier, SGDRegressor, _partial,
    sgd_classifier_from_reference, sgd_regressor_from_reference)
from dask_ml_tpu_torch import programs
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.datasets import stream_classification_blocks
from dask_ml_tpu_torch.metrics import f1_score
from dask_ml_tpu_torch.wrappers import NotFittedError

TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    mesh.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    mesh.set_device(None)
    torch.set_num_threads(threads)


def _data(seed, n=2100, d=5, k=2):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = rng.standard_normal((d, k))
    y = np.argmax(X @ W + 0.5 * rng.standard_normal((n, k)), axis=1)
    return X, y


def _hold(port, ref):
    c_ref = np.asarray(ref.coef_, np.float64)
    scale = TOL * np.abs(c_ref).max()
    np.testing.assert_allclose(port.coef_, c_ref, rtol=0, atol=scale)
    np.testing.assert_allclose(port.intercept_, np.asarray(ref.intercept_), rtol=0, atol=scale)
    assert port.t_ == ref.t_


@pytest.mark.parametrize("knob", [None, "off", "pow2", "auto", "300, 5000,70000"])
def test_bucket_policy_matches_reference(monkeypatch, knob):
    for name in (programs.BUCKET_ENV, ref_programs.BUCKET_ENV):
        if knob is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, knob)
    port, ref = programs.resolve_policy(), ref_programs.resolve_policy()
    assert (port.kind, port.sizes) == (ref.kind, ref.sizes)
    for n in (0, 1, 37, 256, 257, 4095, 16384, 65536, 65537, 200_001):
        assert programs.bucket_rows(n) == ref_programs.bucket_rows(n)
    for m in (1, 300, 70_000, 140_001):
        assert port.rungs(m) == ref.rungs(m)
    rng = np.random.RandomState(0)
    for n in (37, 256, 1000):
        X = rng.standard_normal((n, 3)).astype(np.float32)
        t = rng.standard_normal((n, 2)).astype(np.float32)
        before = programs.counters_snapshot()
        got, want = programs.pad_block(X, t), ref_programs.pad_block(X, t)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        after = programs.counters_snapshot()
        padded = got[0].shape[0] != n
        assert after["blocks"] == before["blocks"] + 1
        assert after["padded_blocks"] == before["padded_blocks"] + padded
        assert after["pad_rows"] - before["pad_rows"] == got[0].shape[0] - n
        if not padded:
            assert got[0] is X  # the no-op fast path makes no copy


def test_bucket_policy_rejects_a_typo(monkeypatch):
    monkeypatch.setenv(programs.BUCKET_ENV, "pow3")
    with pytest.raises(ValueError, match="DASK_ML_TPU_TORCH_BUCKET"):
        programs.resolve_policy()
    with pytest.raises(ValueError):
        programs.resolve_policy("512,256")


class _Recorder:
    """Records the first row of every block it is given."""

    def __init__(self):
        self.firsts = []

    def partial_fit(self, X, y=None, **kwargs):
        self.firsts.append(float(np.asarray(X)[0, 0]))
        return self


@pytest.mark.parametrize("chunk_size, shuffle", [(None, False), (300, True), ((250, 5), True)])
def test_partial_fit_visits_blocks_in_the_reference_order(chunk_size, shuffle):
    X, y = _data(1)
    port, ref = _Recorder(), _Recorder()
    _partial.fit(port, X, y, chunk_size=chunk_size, shuffle_blocks=shuffle, random_state=5)
    ref_partial.fit(ref, X, y, chunk_size=chunk_size, shuffle_blocks=shuffle, random_state=5,
                    prefetch_depth=0)
    rows = 16384 if chunk_size is None else 300 if chunk_size == 300 else 250
    assert port.firsts == ref.firsts and len(port.firsts) == -(-X.shape[0] // rows)


def test_partial_fit_streams_sgd_like_the_reference():
    X, y = _data(2, k=3)
    port, ref = SGDClassifier(), RefSGDClassifier()
    kw = dict(chunk_size=500, shuffle_blocks=True, random_state=1, classes=[0, 1, 2])
    _partial.fit(port, X, y, **kw)
    ref_partial.fit(ref, X, y, prefetch_depth=0, **kw)
    _hold(port, ref)
    np.testing.assert_array_equal(_partial.predict(port, X, chunk_size=700),
                                  np.asarray(ref_partial.predict(ref, X, chunk_size=700)))
    blocks = iter([(X[:900], y[:900]), (X[900:], y[900:])])
    port2 = _partial.fit(SGDClassifier(), blocks, classes=[0, 1, 2])
    ref2 = ref_partial.fit(RefSGDClassifier(), iter([(X[:900], y[:900]), (X[900:], y[900:])]),
                           classes=[0, 1, 2], prefetch_depth=0)
    _hold(port2, ref2)


@pytest.mark.parametrize("est", ["classifier", "regressor"])
def test_incremental_matches_the_reference(est):
    X, y = _data(3)
    if est == "classifier":
        make_port, make_ref, fit_kw = SGDClassifier, RefSGDClassifier, {"classes": [0, 1]}
    else:
        y = (X @ np.arange(5.0) + 0.25).astype(np.float32)
        make_port, make_ref, fit_kw = SGDRegressor, RefSGDRegressor, {}
    kw = dict(chunk_size=512, random_state=2)
    port = Incremental(make_port(), **kw).fit(X, y, **fit_kw)
    ref = RefIncremental(make_ref(), prefetch_depth=0, **kw).fit(X, y, **fit_kw)
    _hold(port.estimator_, ref.estimator_)
    assert port.n_features_in_ == ref.n_features_in_ == 5
    port.partial_fit(X[:1000], y[:1000], **fit_kw)
    ref.partial_fit(X[:1000], y[:1000], **fit_kw)
    _hold(port.estimator_, ref.estimator_)
    np.testing.assert_allclose(port.score(X, y), ref.score(X, y), rtol=0, atol=1e-5)
    got, want = port.predict(X), np.asarray(ref.predict(X))
    if est == "classifier":
        np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(port.predict_proba(X), np.asarray(ref.predict_proba(X)),
                                   rtol=0, atol=TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def test_parallel_post_fit_predicts_like_the_reference():
    X, y = _data(4, k=3)
    kw = dict(max_iter=5, tol=None)
    port = ParallelPostFit(SGDClassifier(**kw)).fit(X, y)
    ref = RefParallelPostFit(RefSGDClassifier(**kw)).fit(X, y)
    _hold(port.estimator_, ref.estimator_)
    np.testing.assert_array_equal(port.predict(X), np.asarray(ref.predict(X)))
    got = list(port.predict_blocks(X, chunk_size=800))
    want = list(ref.predict_blocks(X, chunk_size=800))
    assert [len(g) for g in got] == [len(w) for w in want] == [800, 800, 500]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # a ShardedRows X: one call on the device, and chunked device views
    sX = shard_rows(X)
    np.testing.assert_array_equal(port.predict(sX), np.asarray(ref.predict(X)))
    blocks = list(port.predict_blocks(sX, method="predict_proba", chunk_size=1000))
    np.testing.assert_allclose(np.concatenate(blocks), np.asarray(ref.predict_proba(X)),
                               rtol=0, atol=TOL)
    assert port.score(X, y) == pytest.approx(ref.score(X, y), abs=1e-6)
    scorer = lambda est, X_, y_: -1.0  # noqa: E731
    assert ParallelPostFit(SGDClassifier(), scoring=scorer).fit(X, y).score(X, y) == -1.0
    # a string scoring goes through check_scoring
    acc = ParallelPostFit(SGDClassifier(**kw), scoring="accuracy").fit(X, y).score(X, y)
    assert acc == pytest.approx(port.score(X, y), abs=1e-12)
    f1 = ParallelPostFit(SGDClassifier(**kw), scoring="f1_macro").fit(X, y).score(X, y)
    assert f1 == pytest.approx(f1_score(y, port.predict(X), average="macro"), abs=1e-12)
    with pytest.raises(ValueError, match="not a valid scoring value"):
        ParallelPostFit(SGDClassifier(), scoring="nonsense").fit(X, y).score(X, y)


@pytest.mark.parametrize("scoring", ["accuracy", "r2", "f1", "roc_auc"])
def test_parallel_post_fit_scores_a_string_scoring_like_the_reference(scoring):
    X, y = _data(8)
    kw = dict(max_iter=5, tol=None)
    if scoring == "r2":
        y = (X @ np.arange(1.0, 6.0) + 0.1).astype(np.float32)
        make, make_ref = SGDRegressor, RefSGDRegressor
    else:
        make, make_ref = SGDClassifier, RefSGDClassifier
    port = ParallelPostFit(make(**kw), scoring=scoring).fit(X, y)
    ref = RefParallelPostFit(make_ref(**kw), scoring=scoring).fit(X, y)
    _hold(port.estimator_, ref.estimator_)
    assert port.score(X, y) == pytest.approx(float(ref.score(X, y)), abs=1e-5)


def test_parallel_post_fit_takes_a_prefitted_estimator_and_rejects_an_unfitted_one():
    X, y = _data(5)
    with pytest.raises(NotFittedError, match="not fitted"):
        ParallelPostFit(SGDClassifier()).predict(X)
    est = SGDClassifier(max_iter=2, tol=None).fit(X, y)
    np.testing.assert_array_equal(ParallelPostFit(est).predict(X), est.predict(X))


def _unported_retry_budget(tmp_path):
    from dask_ml_tpu_torch import io

    path = tmp_path / "x.f32"
    np.zeros((4, 2), np.float32).tofile(path)
    io.stream_binary_blocks(str(path), 2, 2, retry_budget=object())


def _unported_cohort_staging(tmp_path):
    from dask_ml_tpu_torch.model_selection._packing import Cohort

    X, y = _data(6)
    Cohort([SGDClassifier(alpha=a) for a in (1e-4, 1e-3)], classes=[0, 1])._pf_stage(X, y)


def _unported_fit_checkpoint(tmp_path):
    X, y = _data(6)
    SGDClassifier(fit_checkpoint=object()).fit(X, y)


@pytest.mark.parametrize("case, item", [(_unported_retry_budget, "[port-planes]"),
                                        (_unported_cohort_staging, "[port-search] item 3"),
                                        (_unported_fit_checkpoint, "[port-planes]")])
def test_the_remaining_unported_options_raise_naming_their_item(tmp_path, case, item):
    with pytest.raises(NotImplementedError, match=re.escape(item)):
        case(tmp_path)


@pytest.mark.parametrize("est", ["classifier", "regressor"])
def test_incremental_with_prefetch_matches_the_reference(est):
    """``prefetch_depth=2``: the port's staged stream against the reference's
    (the reference at its own depth 2)."""
    X, y = _data(9)
    if est == "classifier":
        make_port, make_ref, fit_kw = SGDClassifier, RefSGDClassifier, {"classes": [0, 1]}
    else:
        y = (X @ np.arange(5.0) - 0.5).astype(np.float32)
        make_port, make_ref, fit_kw = SGDRegressor, RefSGDRegressor, {}
    kw = dict(chunk_size=300, random_state=4, prefetch_depth=2)
    port = Incremental(make_port(random_state=0), **kw).fit(X, y, **fit_kw)
    ref = RefIncremental(make_ref(random_state=0), **kw).fit(X, y, **fit_kw)
    _hold(port.estimator_, ref.estimator_)
    serial = Incremental(make_port(random_state=0), **dict(kw, prefetch_depth=0)).fit(
        X, y, **fit_kw)
    np.testing.assert_array_equal(port.estimator_.coef_, serial.estimator_.coef_)
    assert port.estimator_.t_ == serial.estimator_.t_ == 7


def test_a_binary_file_streams_like_the_reference(tmp_path):
    from dask_ml_tpu import io as ref_io
    from dask_ml_tpu_torch import io

    X, _ = _data(10, n=2300, d=6)
    path = tmp_path / "x.f32"
    X.tofile(path)

    def blocks(mod):
        return ((xb, (xb[:, 0] > 0.1).astype(np.int64))
                for xb in mod.stream_binary_blocks(str(path), 512, 6))

    port = _partial.fit(SGDClassifier(random_state=0), blocks(io), prefetch_depth=2,
                        classes=[0, 1])
    ref = ref_partial.fit(RefSGDClassifier(random_state=0), blocks(ref_io), prefetch_depth=2,
                          classes=[0, 1])
    _hold(port, ref)
    assert port.t_ == 5


def test_a_sharded_dataset_feeds_fit_and_predict_blocks_like_the_reference(tmp_path):
    from dask_ml_tpu import data as ref_data
    from dask_ml_tpu_torch import data

    X, y = _data(11, n=3000)
    data.write_dataset(str(tmp_path / "ds"), X, y, shards=3, block_rows=256)
    kw = dict(key=5, epochs=2)
    port = _partial.fit(SGDClassifier(random_state=0),
                        data.ShardedDataset(str(tmp_path / "ds"), readers=4, **kw),
                        classes=[0, 1])
    ref = ref_partial.fit(RefSGDClassifier(random_state=0),
                          ref_data.ShardedDataset(str(tmp_path / "ds"), readers=2, **kw),
                          classes=[0, 1])
    _hold(port, ref)
    assert port.t_ == 2 * 12  # 12 blocks an epoch
    inc = Incremental(SGDClassifier(random_state=0)).fit(
        data.ShardedDataset(str(tmp_path / "ds"), readers=2, **kw), classes=[0, 1])
    np.testing.assert_array_equal(inc.estimator_.coef_, port.coef_)
    with pytest.raises(ValueError, match="ride the dataset"):
        _partial.fit(SGDClassifier(), data.ShardedDataset(str(tmp_path / "ds")), y)
    ppf = ParallelPostFit(port)
    ref_ppf = RefParallelPostFit(ref)
    got = list(ppf.predict_blocks(data.ShardedDataset(str(tmp_path / "ds"), shuffle=False)))
    want = list(ref_ppf.predict_blocks(ref_data.ShardedDataset(str(tmp_path / "ds"),
                                                               shuffle=False)))
    assert [len(g) for g in got] == [len(w) for w in want] and sum(map(len, got)) == 3000
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        _partial.predict(port, data.ShardedDataset(str(tmp_path / "ds"), shuffle=False)),
        np.concatenate(got))


def test_stream_classification_blocks_shapes_masks_and_determinism():
    a = list(stream_classification_blocks(3, 256, 7, seed=4))
    b = list(stream_classification_blocks(3, 256, 7, seed=4))
    c = list(stream_classification_blocks(3, 256, 7, seed=5))
    assert len(a) == 3
    for (X, y), (X2, y2), (X3, _) in zip(a, b, c):
        assert tuple(X.data.shape) == (256, 7) and X.data.dtype == torch.float32
        assert tuple(y.data.shape) == (256,) and X.n_samples == y.n_samples == 256
        assert torch.equal(X.mask, torch.ones(256)) and torch.equal(y.mask, torch.ones(256))
        assert set(torch.unique(y.data).tolist()) <= {0.0, 1.0}
        assert torch.equal(X.data, X2.data) and torch.equal(y.data, y2.data)
        assert not torch.equal(X.data, X3.data)
    assert not torch.equal(a[0][0].data, a[1][0].data)  # a fresh draw every block
    # labels follow the given coef: a model at w separates them well
    w = np.array([2.0, -1.0, 0.5, 0.0, 1.0, 0.0, -2.0], np.float32)
    (X, y), = stream_classification_blocks(1, 4096, 7, seed=0, coef=w)
    acc = float(((X.data @ torch.from_numpy(w) > 0).float() == y.data).float().mean())
    assert acc > 0.75


def test_the_stream_trains_the_port_classifier():
    w = np.array([1.5, -1.0, 0.5, 2.0], np.float32)
    clf = SGDClassifier(random_state=0)
    losses = []
    for Xb, yb in stream_classification_blocks(12, 1024, 4, seed=1, coef=w):
        clf.partial_fit(Xb, yb, classes=[0.0, 1.0])
        losses.append(float(clf._loss_))
    coef = clf.coef_[0]
    assert clf.t_ == 12.0 and losses[-1] < losses[0]
    assert coef @ w / np.linalg.norm(coef) / np.linalg.norm(w) > 0.95


@pytest.mark.parametrize("est", ["classifier", "regressor"])
def test_converters_continue_the_reference_trajectory(est):
    """A reference-fitted SGD carried over goes on under the port's
    partial_fit to the reference's own next step."""
    X, y = _data(8, k=3)
    if est == "classifier":
        ref = RefSGDClassifier(penalty="l1")
        ref.partial_fit(X[:700], y[:700], classes=[0, 1, 2])
        ref.partial_fit(X[700:1400], y[700:1400])
        arrays = {k: np.asarray(getattr(ref, k)) for k in
                  ("coef_", "intercept_", "classes_", "n_features_in_")}
        arrays["t_"] = ref.t_
        port = sgd_classifier_from_reference(arrays, penalty="l1")
        np.testing.assert_array_equal(port.predict(X), np.asarray(ref.predict(X)))
    else:
        y = (X @ np.arange(5.0)).astype(np.float32)
        ref = RefSGDRegressor(learning_rate="optimal")
        ref.partial_fit(X[:700], y[:700])
        ref.partial_fit(X[700:1400], y[700:1400])
        arrays = {k: np.asarray(getattr(ref, k)) for k in
                  ("coef_", "intercept_", "n_features_in_")}
        arrays["t_"] = ref.t_
        port = sgd_regressor_from_reference(arrays, learning_rate="optimal")
    assert port.t_ == ref.t_ == 2.0
    port.partial_fit(X[1400:], y[1400:])
    ref.partial_fit(X[1400:], y[1400:])
    _hold(port, ref)
    with pytest.raises(ValueError, match="missing"):
        sgd_regressor_from_reference({"coef_": arrays["coef_"]})
