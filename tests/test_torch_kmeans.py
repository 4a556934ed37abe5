"""The port's KMeans against the JAX reference's, on the CPU at 8 logical
shards (the reference runs on 8 virtual devices here).

Tolerances: float32 on both sides with a different summation order, so
centers and inertia agree to rtol 1e-5; labels agree except on rows whose
two smallest d² are within 1e-5·(‖x‖²+‖c‖²).  Draws from ``jax.random``
and ``torch.Generator`` differ, so the random inits are held to the
reference's inertia (within 1%) and not to its bits.
"""

import numpy as np
import pytest
import torch

from sklearn.cluster import KMeans as SKKMeans

from dask_ml_tpu.cluster import KMeans as RefKMeans
from dask_ml_tpu_torch import KMeans, kmeans_from_reference
from dask_ml_tpu_torch.base import clone
from dask_ml_tpu_torch.cluster import k_means as km
from dask_ml_tpu_torch.core import mesh

RTOL = 1e-5
TIE = 1e-5


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


def _blobs(seed, n=1501, d=5, k=4, spread=10.0, std=1.0):
    rng = np.random.RandomState(seed)
    truth = rng.uniform(-spread, spread, (k, d))
    x = truth[rng.randint(0, k, n)] + std * rng.standard_normal((n, d))
    return x.astype(np.float32), truth


def _near_tie(x, centers):
    x64, c64 = x.astype(np.float64), np.asarray(centers, np.float64)
    d2 = ((x64[:, None, :] - c64[None]) ** 2).sum(-1)
    two = np.sort(d2, axis=1)[:, :2]
    scale = (x64 ** 2).sum(1) + (c64 ** 2).sum(1)[np.argmin(d2, 1)]
    return (two[:, 1] - two[:, 0]) < TIE * scale


def _assert_labels(port, ref, x, centers):
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    diff = port != np.asarray(ref)
    assert not (diff & ~_near_tie(x, centers)).any(), np.flatnonzero(diff)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("seed,n,weighted", [
    (0, 1501, False), (1, 1501, True), (2, 999, False), (3, 2003, True)])
def test_explicit_init_fit_matches_reference(seed, n, weighted):
    # overlapping blobs, so the fit takes several rounds
    x, truth = _blobs(seed, n=n, spread=3.0, std=1.5)
    rng = np.random.RandomState(100 + seed)
    init = x[rng.choice(n, 4, replace=False)].copy()
    sw = rng.uniform(0.1, 3.0, n).astype(np.float32) if weighted else None
    ref = RefKMeans(n_clusters=4, init=init).fit(x, sample_weight=sw)
    port = KMeans(n_clusters=4, init=init).fit(x, sample_weight=sw)
    assert port.n_iter_ == ref.n_iter_
    assert port.n_iter_ > 1
    np.testing.assert_allclose(_np(port.cluster_centers_), _np(ref.cluster_centers_),
                               rtol=RTOL, atol=RTOL * np.abs(x).max())
    np.testing.assert_allclose(port.inertia_, ref.inertia_, rtol=RTOL)
    assert port.labels_.shape == (n,) and port.labels_.dtype == torch.int64
    _assert_labels(port.labels_, ref.labels_, x, _np(ref.cluster_centers_))
    assert port.n_features_in_ == ref.n_features_in_


def test_weights_carried_across_reproduce_predict_transform_score():
    x, _ = _blobs(4, n=1203)
    ref = RefKMeans(n_clusters=4, random_state=0).fit(x)
    arrays = {k: np.asarray(getattr(ref, k)) for k in
              ("cluster_centers_", "n_iter_", "inertia_", "n_features_in_")}
    port = kmeans_from_reference(arrays)
    assert port.n_iter_ == ref.n_iter_ and port.inertia_ == pytest.approx(ref.inertia_)
    centers = _np(ref.cluster_centers_)
    x_new, _ = _blobs(5, n=777)
    _assert_labels(port.predict(x_new), ref.predict(x_new), x_new, centers)
    np.testing.assert_allclose(_np(port.transform(x_new)), _np(ref.transform(x_new)),
                               rtol=RTOL, atol=1e-3)
    sw = np.random.RandomState(6).uniform(0.1, 2, 777).astype(np.float32)
    np.testing.assert_allclose(port.score(x_new), ref.score(x_new), rtol=RTOL)
    np.testing.assert_allclose(port.score(x_new, sample_weight=sw),
                               ref.score(x_new, sample_weight=sw), rtol=RTOL)
    names = port.get_feature_names_out()
    assert list(names) == list(ref.get_feature_names_out())


@pytest.mark.parametrize("init", ["k-means||", "random", "k-means++"])
def test_random_inits_reach_the_reference_inertia(init):
    x, _ = _blobs(7, n=2001, d=4, k=5, spread=20.0)
    ref = RefKMeans(n_clusters=5, init=init, random_state=0).fit(x)
    port = KMeans(n_clusters=5, init=init, random_state=0).fit(x)
    assert port.inertia_ <= 1.01 * ref.inertia_, (port.inertia_, ref.inertia_)
    assert np.isfinite(port.inertia_)


def test_kmeans_parallel_init_with_sample_weight():
    x, _ = _blobs(8, n=1001, d=3, k=3, spread=20.0)
    sw = np.random.RandomState(8).uniform(0.5, 2.0, 1001).astype(np.float32)
    ref = RefKMeans(n_clusters=3, random_state=1).fit(x, sample_weight=sw)
    port = KMeans(n_clusters=3, random_state=1).fit(x, sample_weight=sw)
    assert port.inertia_ <= 1.01 * ref.inertia_


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_weighted_kmeanspp_is_as_good_as_sklearn(seed):
    rng = np.random.RandomState(seed)
    truth = rng.uniform(-10, 10, (6, 4))
    cand = truth[rng.randint(0, 6, 300)] + rng.standard_normal((300, 4))
    w = rng.uniform(1, 500, 300)
    ours = km._weighted_kmeans_np(cand, 6, w, np.random.RandomState(seed))
    sk = SKKMeans(n_clusters=6, init="k-means++", n_init=1, max_iter=10,
                  random_state=0).fit(cand, sample_weight=w)

    def inertia(c):
        return float((((cand[:, None] - c[None]) ** 2).sum(-1).min(1)) @ w)

    assert inertia(ours) <= 1.05 * inertia(sk.cluster_centers_)


def test_draws_follow_the_weights():
    gen = torch.Generator().manual_seed(0)
    w = torch.tensor([0.0, 1.0, 0.0, 3.0])
    hits = torch.stack([km._draw_one(w, gen) for _ in range(400)]).flatten()
    assert set(hits.tolist()) <= {1, 3}
    assert 0.6 < float((hits == 3).float().mean()) < 0.9
    picks = km._draw_without_replacement(torch.tensor([1.0, 0.0, 2.0, 5.0]), 3, gen)
    assert sorted(picks.tolist()) == [0, 2, 3]


def test_candidate_weights_count_past_float32_integers():
    # one candidate closest to more than 2^24 unit-weight rows: a float32
    # count would stop at 16777216
    n = 2**24 + 3
    closest = torch.zeros(n, dtype=torch.int64)
    closest[:2] = 1
    weights = km._candidate_weights(torch.ones(n), closest, 3)
    assert weights.dtype == torch.float64
    assert weights.tolist() == [2**24 + 1, 2, 0]


def test_fit_checkpoint_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        KMeans(n_clusters=2, fit_checkpoint=object()).fit(np.ones((8, 2), np.float32))


def test_fast_mode_raises(monkeypatch):
    monkeypatch.setenv(km._PRECISION_ENV, "fast")
    with pytest.raises(NotImplementedError, match="split gemm"):
        KMeans(n_clusters=2).fit(np.ones((8, 2), np.float32))


def test_params_round_trip():
    est = KMeans(n_clusters=3, tol=1e-3, random_state=4)
    params = est.get_params()
    assert params["n_clusters"] == 3 and params["init"] == "k-means||"
    est.set_params(max_iter=7)
    twin = clone(est)
    assert twin is not est and twin.get_params() == est.get_params()
    assert "max_iter=7" in repr(twin) and "init" not in repr(twin)
    with pytest.raises(ValueError):
        est.set_params(bogus=1)


def test_fit_transform_and_fit_predict():
    x, _ = _blobs(9, n=300)
    est = KMeans(n_clusters=4, random_state=0)
    dist = est.fit_transform(x)
    assert dist.shape == (300, 4)
    torch.testing.assert_close(est.fit_predict(x), est.labels_)
    with pytest.raises(ValueError):
        KMeans(n_clusters=400).fit(x)


def test_fit_takes_float64_and_strided_tensors():
    x, _ = _blobs(10, n=400)
    init = x[:4].copy()
    ref = KMeans(n_clusters=4, init=init).fit(x)
    wide = torch.from_numpy(np.ascontiguousarray(x.T).astype(np.float64)).T
    assert not wide.is_contiguous()
    est = KMeans(n_clusters=4, init=init).fit(wide)
    assert est.cluster_centers_.dtype == torch.float32
    torch.testing.assert_close(est.cluster_centers_, ref.cluster_centers_)
