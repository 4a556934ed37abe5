"""The port's decomposition estimators (``dask_ml_tpu_torch/decomposition/``)
against the JAX reference on the CPU: the reference on the 8 virtual CPU
devices of the tier-1 conftest, the port at 8 logical shards, the same
seeded numpy inputs (at most 2003×12).

Tolerances, each array to rtol 1e-5 with an atol of 1e-5 of its largest
|value| (entries near zero are held to that absolute floor):
- ``PCA(svd_solver="full")``: every fitted attribute, ``transform``,
  ``fit_transform``, ``inverse_transform``, ``get_covariance``,
  ``get_precision`` (its matrix-inversion-lemma branch and its
  plain-inverse branch, k = d), ``score_samples`` and ``score``, with int
  and float ``n_components`` and with ``whiten``.
- ``get_precision``'s jitter branch, on a singular model covariance set
  by hand: the same rtol.
- The randomized solvers at estimator level (``PCA(svd_solver=
  "randomized")``, ``TruncatedSVD(algorithm="randomized")``), which draw
  their sketch from ``torch.Generator`` and not from ``jax.random``: held
  by quality on a spectrum with a clear gap (top four singular values
  10–5, the rest ≤ 0.1) — singular values within rtol 1e-5 of the float64
  SVD's and of the reference's, each component's |cos| to the float64
  one ≥ 1 − 1e-6.
- ``TruncatedSVD(algorithm="tsqr")``: every fitted attribute and the
  transforms, also on rows whose padding is nonzero; ``transform`` of
  scipy-sparse input equal to the dense one to 1e-6; ``fit_streamed``
  against the reference's to rtol 1e-6 (both are float64 host numpy).
- ``IncrementalPCA``: three ``partial_fit`` batches, then ``fit`` with a
  dropped tail; a model carried over by ``incremental_pca_from_reference``
  after two batches against the reference after a third; all to the
  rtol above, ``n_samples_seen_`` equal.  Over a chain of 33 updates the
  two packages' float32 roundings part by more (1.3e-5 of the largest
  component entry): there each is held to the same rtol against the
  chain run in float64 by the port.
"""

import numpy as np
import pytest
import scipy.sparse
import torch

import jax.numpy as jnp

import dask_ml_tpu.decomposition as ref_dd
from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu.core.sharded import ShardedRows as RefShardedRows
from dask_ml_tpu_torch import (
    PCA, IncrementalPCA, TruncatedSVD, incremental_pca_from_reference, pca_from_reference,
    truncated_svd_from_reference)
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.core.sharded import ShardedRows
from dask_ml_tpu_torch.linalg import HOST_READS

RTOL = 1e-5


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


def _np(a):
    if isinstance(a, (ShardedRows, RefShardedRows)):
        a = a.data[: a.n_samples]
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def _data(seed, n=2003, d=12, offset=5.0):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(n, d)) * np.linspace(3.0, 0.1, d) + offset).astype(np.float32)


def _gap(seed, n=2003, d=12, offset=5.0):
    """Z·diag(s)·Uᵀ + offset with s = (10, 8, 6, 5, then ≤ 0.1)."""
    rng = np.random.RandomState(seed)
    s = np.concatenate([[10.0, 8.0, 6.0, 5.0], np.linspace(0.1, 0.02, d - 4)])
    u, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return ((rng.normal(size=(n, d)) * s) @ u.T + offset).astype(np.float32)


PCA_ATTRS = ("components_", "explained_variance_", "explained_variance_ratio_",
             "singular_values_", "mean_", "noise_variance_")


@pytest.mark.parametrize("n_components,whiten", [(4, False), (4, True), (0.9, False),
                                                 (None, False), (None, True)])
def test_pca_full_matches_reference(n_components, whiten):
    X = _data(0)
    kw = dict(n_components=n_components, whiten=whiten, svd_solver="full")
    ref = ref_dd.PCA(**kw).fit(ref_shard_rows(X))
    port = PCA(**kw).fit(shard_rows(X))
    assert port.n_components_ == ref.n_components_
    assert (port.n_samples_, port.n_features_in_) == (ref.n_samples_, ref.n_features_in_)
    for name in PCA_ATTRS:
        _close(getattr(port, name), getattr(ref, name))
    _close(port.transform(X), ref.transform(X))
    _close(port.fit_transform(X), ref_dd.PCA(**kw).fit_transform(X))
    Z = np.asarray(ref.transform(X))
    _close(port.inverse_transform(Z), ref.inverse_transform(Z))
    _close(port.get_covariance(), ref.get_covariance())
    _close(port.get_precision(), ref.get_precision())
    _close(port.score_samples(X), ref.score_samples(X))
    assert port.score(X) == pytest.approx(ref.score(X), rel=RTOL)


def test_pca_sharded_in_sharded_out():
    X = _data(1, n=203)
    out = PCA(n_components=3, svd_solver="tsqr").fit_transform(shard_rows(X))
    ref = ref_dd.PCA(n_components=3, svd_solver="tsqr").fit_transform(ref_shard_rows(X))
    assert isinstance(out, ShardedRows) and out.data.shape == (208, 3)
    _close(out, ref)
    est = PCA(n_components=3).fit(X)
    assert isinstance(est.transform(shard_rows(X)), ShardedRows)
    assert isinstance(est.transform(X), torch.Tensor)


@pytest.mark.parametrize("n,d,k,solver", [(100, 60, 10, "auto"), (100, 60, 50, "auto"),
                                          (100, 40, 10, "auto"), (100, 60, 0.5, "auto"),
                                          (100, 60, None, "auto"), (100, 60, 10, "tsqr"),
                                          (100, 60, 10, "randomized")])
def test_pca_solver_policy_matches_reference(n, d, k, solver):
    kw = dict(n_components=k, svd_solver=solver)
    assert PCA(**kw)._resolve(n, d) == ref_dd.PCA(**kw)._resolve(n, d)


def test_pca_auto_resolves_to_randomized_past_50_features():
    X = _gap(2, n=400, d=60)
    est = PCA(n_components=4).fit(X)
    assert est._resolve(400, 60) == (4, "randomized")
    s_true = np.linalg.svd(X - X.astype(np.float64).mean(0), compute_uv=False)[:4]
    _close(est.singular_values_, s_true.astype(np.float32))


def _quality(est, ref, X, centred):
    x64 = X.astype(np.float64)
    if centred:
        x64 = x64 - x64.mean(0)
    _, s, vt = np.linalg.svd(x64, full_matrices=False)
    k = len(_np(est.singular_values_))
    _close(est.singular_values_, s[:k])
    _close(est.singular_values_, ref.singular_values_)
    cos = np.abs(np.sum(_np(est.components_).astype(np.float64) * vt[:k], axis=1))
    assert (cos >= 1 - 1e-6).all(), cos


@pytest.mark.parametrize("seed", [0, 1])
def test_randomized_pca_is_held_by_quality(seed):
    X = _gap(seed)
    kw = dict(n_components=4, svd_solver="randomized", random_state=seed)
    est = PCA(**kw).fit(X)
    _quality(est, ref_dd.PCA(**kw).fit(X), X, centred=True)


@pytest.mark.parametrize("seed", [0, 1])
def test_randomized_truncated_svd_is_held_by_quality(seed):
    X = _gap(seed, offset=0.0)
    kw = dict(n_components=4, algorithm="randomized", random_state=seed)
    est = TruncatedSVD(**kw).fit(X)
    _quality(est, ref_dd.TruncatedSVD(**kw).fit(X), X, centred=False)


TSVD_ATTRS = ("components_", "explained_variance_", "explained_variance_ratio_",
              "singular_values_")


def test_truncated_svd_tsqr_matches_reference():
    X = _data(3, offset=1.0)
    ref = ref_dd.TruncatedSVD(n_components=4)
    port = TruncatedSVD(n_components=4)
    out_ref, out = ref.fit_transform(X), port.fit_transform(X)
    assert isinstance(out, torch.Tensor) and out.shape == (2003, 4)  # plain in, plain out
    _close(out, out_ref)
    for name in TSVD_ATTRS:
        _close(getattr(port, name), getattr(ref, name))
    _close(port.transform(X), ref.transform(X))
    Z = np.asarray(out_ref)
    _close(port.inverse_transform(Z), ref.inverse_transform(Z))
    sparse = scipy.sparse.csr_matrix(np.where(X > 1.5, X, 0.0).astype(np.float32))
    got = port.transform(sparse)
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, _np(port.transform(sparse.toarray())), rtol=1e-6,
                               atol=1e-6 * np.abs(got).max())


def test_truncated_svd_zeroes_nonzero_pad_rows():
    # 83 rows pad to 88; the pad rows carry what an upstream transform left
    rng = np.random.RandomState(4)
    X = rng.normal(loc=5.0, size=(83, 6)).astype(np.float32)
    padded = np.concatenate([X, np.full((5, 6), -3.0, np.float32)])
    mask = (np.arange(88) < 83).astype(np.float32)
    ref_in = RefShardedRows(data=ref_shard_rows(padded).data, mask=jnp.asarray(mask),
                            n_samples=83)
    port_in = ShardedRows(data=torch.from_numpy(padded), mask=torch.from_numpy(mask),
                          n_samples=83)
    ref = ref_dd.TruncatedSVD(n_components=3)
    port = TruncatedSVD(n_components=3)
    out_ref, out = ref.fit_transform(ref_in), port.fit_transform(port_in)
    assert isinstance(out, ShardedRows)
    _close(out, out_ref)
    for name in TSVD_ATTRS:
        _close(getattr(port, name), getattr(ref, name))
    _close(port.singular_values_, np.linalg.svd(X.astype(np.float64), compute_uv=False)[:3])


def _sparse_blocks(seed, n=600, d=50, block=100):
    rng = np.random.RandomState(seed)
    A = scipy.sparse.random(n, d, density=0.1, format="csr", random_state=rng,
                            dtype=np.float32)
    return lambda: (A[i:i + block] for i in range(0, n, block))


@pytest.mark.parametrize("n_features", [None, 50])
def test_truncated_svd_fit_streamed_matches_reference(n_features):
    blocks = _sparse_blocks(5)
    ref = ref_dd.TruncatedSVD(n_components=5, n_iter=3, random_state=0)
    port = TruncatedSVD(n_components=5, n_iter=3, random_state=0)
    ref.fit_streamed(blocks, n_features=n_features)
    port.fit_streamed(blocks, n_features=n_features)
    for name in TSVD_ATTRS:
        _close(getattr(port, name), getattr(ref, name), rtol=1e-6)
    assert port.n_features_in_ == ref.n_features_in_ == 50
    with pytest.raises(ValueError, match="empty"):
        TruncatedSVD(n_components=2).fit_streamed(lambda: iter(()))


IPCA_ATTRS = ("components_", "singular_values_", "mean_", "var_", "explained_variance_",
              "explained_variance_ratio_", "noise_variance_")


def _hold_ipca(port, ref, X):
    assert port.n_samples_seen_ == ref.n_samples_seen_
    assert port.n_components_ == ref.n_components_
    for name in IPCA_ATTRS:
        _close(getattr(port, name), getattr(ref, name))
    _close(port.transform(X), ref.transform(X))
    Z = np.asarray(ref.transform(X))
    _close(port.inverse_transform(Z), ref.inverse_transform(Z))
    _close(port.get_covariance(), ref.get_covariance())
    _close(port.get_precision(), ref.get_precision())


@pytest.mark.parametrize("whiten", [False, True])
def test_incremental_pca_partial_fit_matches_reference(whiten):
    X = _data(6, offset=1e3)
    ref = ref_dd.IncrementalPCA(n_components=4, whiten=whiten)
    port = IncrementalPCA(n_components=4, whiten=whiten)
    reads = HOST_READS["reads"]
    for s, e in ((0, 700), (700, 1350), (1350, 2003)):
        ref.partial_fit(X[s:e])
        port.partial_fit(X[s:e])
    assert HOST_READS["reads"] == reads  # no host read a batch
    _hold_ipca(port, ref, X)


@pytest.mark.parametrize("n,d,batch,k,seen", [(105, 10, 50, None, 100),  # tail 5 < k=10
                                              (2003, 12, 300, 5, 2003),  # tail 203 kept
                                              (183, 12, None, 5, 180)])  # 5·d spans, tail 3
def test_incremental_pca_fit_drops_a_short_tail(n, d, batch, k, seen):
    X = _data(7, n=n, d=d)
    ref = ref_dd.IncrementalPCA(n_components=k, batch_size=batch).fit(X)
    port = IncrementalPCA(n_components=k, batch_size=batch).fit(X)
    assert port.n_samples_seen_ == ref.n_samples_seen_ == seen
    _hold_ipca(port, ref, X)


def test_incremental_pca_long_update_chain_tracks_float64():
    # 33 updates of 5·d = 60 rows: the two packages' float32 roundings part
    # by 1.3e-5 here (different LAPACK SVDs), each within 1e-5 of the same
    # chain run in float64 (the reference 8.9e-6, the port 4.6e-6)
    X = _data(7, n=1983, d=12)
    ref = ref_dd.IncrementalPCA(n_components=5).fit(X)
    port = IncrementalPCA(n_components=5).fit(X)
    exact = IncrementalPCA(n_components=5).fit(torch.from_numpy(X.astype(np.float64)))
    assert port.n_samples_seen_ == ref.n_samples_seen_ == exact.n_samples_seen_ == 1980
    for name in ("components_", "singular_values_", "explained_variance_"):
        want = _np(getattr(exact, name)).astype(np.float32)
        _close(getattr(port, name), want)
        _close(getattr(ref, name), want)


def test_incremental_pca_carried_over_continues_like_the_reference():
    X = _data(8, offset=50.0)
    ref = ref_dd.IncrementalPCA(n_components=3)
    ref.partial_fit(X[:600]).partial_fit(X[600:1300])
    names = IPCA_ATTRS + ("_mean_sh_", "_anchor_", "n_samples_seen_", "n_components_",
                          "n_features_in_")
    port = incremental_pca_from_reference({k: np.asarray(getattr(ref, k)) for k in names})
    assert port.n_samples_seen_ == 1300
    ref.partial_fit(X[1300:])
    port.partial_fit(X[1300:])
    _hold_ipca(port, ref, X)
    with pytest.raises(ValueError, match="missing"):
        incremental_pca_from_reference({"components_": np.ones((2, 3))})


def test_incremental_pca_small_batch_and_checkpoint_raise():
    X = _data(9, n=40, d=6)
    with pytest.raises(ValueError, match="n_components"):
        IncrementalPCA(n_components=5).partial_fit(X[:3])
    with pytest.raises(NotImplementedError, match=r"\[port-planes\]"):
        IncrementalPCA(fit_checkpoint=object()).fit(X)


def test_pca_and_truncated_svd_from_reference():
    X = _data(10)
    ref = ref_dd.PCA(n_components=3, svd_solver="full", whiten=True).fit(X)
    names = PCA_ATTRS + ("n_components_", "n_samples_", "n_features_in_")
    port = pca_from_reference({k: np.asarray(getattr(ref, k)) for k in names}, whiten=True)
    _close(port.transform(X), ref.transform(X))
    _close(port.score_samples(X), ref.score_samples(X))
    tref = ref_dd.TruncatedSVD(n_components=3).fit(X)
    tport = truncated_svd_from_reference(
        {k: np.asarray(getattr(tref, k)) for k in TSVD_ATTRS + ("n_features_in_",)})
    assert tport.n_components == 3
    _close(tport.transform(X), tref.transform(X))
    with pytest.raises(ValueError, match="n_features_in_"):
        pca_from_reference({**{k: np.asarray(getattr(ref, k)) for k in names},
                            "n_features_in_": 5})


def test_get_precision_jitter_branch_matches_reference():
    # k = d and a zero eigenvalue: the model covariance diag(2, 1, 0) is
    # singular, so both packages invert it after a 1e-12·tr/d jitter
    attrs = dict(components_=np.eye(3, dtype=np.float32),
                 explained_variance_=np.array([2.0, 1.0, 0.0], np.float32),
                 noise_variance_=np.float32(0.0))
    ref, port = ref_dd.PCA(n_components=3), PCA(n_components=3)
    for est, conv in ((ref, jnp.asarray), (port, torch.tensor)):
        for k, v in attrs.items():
            setattr(est, k, conv(v))
        est.n_components_ = 3
    got = port.get_precision()
    assert torch.isfinite(got).all()
    _close(got, ref.get_precision())


def test_feature_names_out_are_class_prefixed():
    X = _data(11, n=64, d=5)
    for cls, ref_cls in ((PCA, ref_dd.PCA), (TruncatedSVD, ref_dd.TruncatedSVD),
                         (IncrementalPCA, ref_dd.IncrementalPCA)):
        est = cls(n_components=2).fit(X)
        want = ref_cls(n_components=2).fit(X).get_feature_names_out()
        got = est.get_feature_names_out()
        assert got.dtype == want.dtype and list(got) == list(want)
    with pytest.raises(ValueError, match="input_features"):
        PCA(n_components=2).fit(X).get_feature_names_out(["a", "b"])


def test_fits_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    mesh.set_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = _data(12, n=64, d=5)
    for est in (PCA(n_components=2), TruncatedSVD(n_components=2),
                IncrementalPCA(n_components=2)):
        with pytest.raises(RuntimeError, match="set_device"):
            est.fit(X)
