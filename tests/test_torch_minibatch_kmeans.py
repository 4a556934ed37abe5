"""The port's MiniBatchKMeans (``cluster/minibatch_kmeans.py``) against the
JAX reference's, on the CPU: the reference on its 8 virtual devices, the
port at 8 logical shards, the same numpy inputs (made from a seed).

Tolerances (float32 on both sides, other summation orders):
- one step on the same centres, pair, batch and weighted mask: centres
  within rtol 1e-5, hi + lo within rtol 1e-6, inertia within rtol 1e-5;
- one epoch with the same ``start``: centres within 1e-5·max|c|, the mean
  step inertia within rtol 1e-5;
- a ``partial_fit`` stream of 8 blocks, one weighted: centres within
  1e-4·max|c| (the steps' rounding adds up over the stream);
- draws differ between ``jax.random`` and ``torch.Generator``, so a fit
  with a k-means++ init is held, on each of 8 seeds, to the reference's
  inertia within 1% and to finding every blob (each true centre within
  1.0 of a fitted one); a ``random`` init, which misses blobs on many
  seeds in both packages, is held over 16 seeds to finding them at least
  as often as the reference, and to its inertia within 1% where both do;
  ``_reassign_starved`` is held by its properties;
- every prefetch depth gives the same bits.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dask_ml_tpu.cluster import MiniBatchKMeans as RefMBK
from dask_ml_tpu.cluster import minibatch_kmeans as ref
from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu_torch import Incremental, _partial
from dask_ml_tpu_torch.cluster import MiniBatchKMeans
from dask_ml_tpu_torch.cluster import minibatch_kmeans as port
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.ops import minibatch as k7

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


def _blobs(seed, n=2000, d=5, k=4, spread=10.0, std=1.0):
    rng = np.random.RandomState(seed)
    truth = rng.uniform(-spread, spread, (k, d))
    x = truth[rng.randint(0, k, n)] + std * rng.standard_normal((n, d))
    return x.astype(np.float32), truth.astype(np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _state(seed, k, d, mass=50.0):
    rng = np.random.RandomState(seed)
    centers = rng.normal(size=(k, d)).astype(np.float32) * 3
    counts = np.stack([rng.uniform(0, mass, k), np.zeros(k)]).astype(np.float32)
    counts[0, 0] = 0.0  # a centre no batch has reached yet
    return centers, counts


@pytest.mark.parametrize("seed,n,k,d", [(0, 300, 5, 6), (1, 1024, 8, 12), (2, 77, 3, 1)])
def test_step_matches_reference(seed, n, k, d):
    centers, counts = _state(seed, k, d)
    rng = np.random.RandomState(seed + 10)
    xb = (rng.normal(size=(n, d)) * 3).astype(np.float32)
    mask = rng.uniform(0, 2, n).astype(np.float32)
    mask[rng.uniform(size=n) < 0.1] = 0.0
    rc, rn, ri = ref._mbk_step_fn(jnp.asarray(centers), jnp.asarray(counts), jnp.asarray(xb),
                                  jnp.asarray(mask))
    pc, pn, pi = port._mbk_step_fn(torch.from_numpy(centers), torch.from_numpy(counts),
                                   torch.from_numpy(xb), torch.from_numpy(mask))
    np.testing.assert_allclose(_np(pc), np.asarray(rc), rtol=RTOL, atol=RTOL * np.abs(rc).max())
    mass = lambda c: np.asarray(c, np.float64)[0] + np.asarray(c, np.float64)[1]  # noqa: E731
    np.testing.assert_allclose(mass(_np(pn)), mass(rn), rtol=1e-6)
    np.testing.assert_allclose(float(pi), float(ri), rtol=RTOL)


def test_fused_step_cpu_dispatch_matches_reference():
    """``ops.minibatch.mbk_step`` (K1a with K7a's update in its last launch)
    on CPU tensors runs the plain versions, and launches nothing: held to
    the reference's ``_mbk_step_fn`` at a ragged row count, with a centre
    no row reaches and masses past 2^24."""
    k, d, n = 7, 9, 1001
    centers, counts = _state(21, k, d)
    centers[3] += 1e3  # no row's nearest centre: its batch mass is 0
    counts[0, 1:] += 2.0 ** 24
    rng = np.random.RandomState(22)
    xb = (rng.normal(size=(n, d)) * 3).astype(np.float32)
    mask = rng.uniform(0, 2, n).astype(np.float32)
    mask[rng.uniform(size=n) < 0.1] = 0.0
    rc, rn, ri = ref._mbk_step_fn(jnp.asarray(centers), jnp.asarray(counts), jnp.asarray(xb),
                                  jnp.asarray(mask))
    before = (k7.mbk_step.launches, k7.mbk_epoch.launches)
    pc, pn, pi = k7.mbk_step(torch.from_numpy(centers), torch.from_numpy(counts),
                             torch.from_numpy(xb), torch.from_numpy(mask))
    assert (k7.mbk_step.launches, k7.mbk_epoch.launches) == before
    np.testing.assert_allclose(_np(pc), np.asarray(rc), rtol=RTOL, atol=RTOL * np.abs(rc).max())
    np.testing.assert_array_equal(_np(pc)[3], centers[3])
    mass = lambda c: np.asarray(c, np.float64)[0] + np.asarray(c, np.float64)[1]  # noqa: E731
    np.testing.assert_allclose(mass(_np(pn)), mass(rn), rtol=1e-6)
    np.testing.assert_allclose(float(pi), float(ri), rtol=RTOL)


def test_mass_past_2_24_keeps_growing():
    """A float32 mass stops at 2^24 (2^24 + 1 rounds back); the Kahan pair
    carries the unit steps in its low word in both packages."""
    k, d = 3, 4
    centers = np.eye(k, d, dtype=np.float32) * 10
    counts = np.stack([np.full(k, 2.0 ** 24), np.zeros(k)]).astype(np.float32)
    xb = np.repeat(centers, 2, axis=0)  # two rows a centre, weight 1 each
    mask = np.ones(2 * k, np.float32)
    got = {"ref": (jnp.asarray(centers), jnp.asarray(counts)),
           "port": (torch.from_numpy(centers), torch.from_numpy(counts))}
    for _ in range(5):
        c, n = got["ref"]
        got["ref"] = ref._mbk_step_fn(c, n, jnp.asarray(xb), jnp.asarray(mask))[:2]
        c, n = got["port"]
        got["port"] = port._mbk_step_fn(c, n, torch.from_numpy(xb), torch.from_numpy(mask))[:2]
    for _, pair in got.values():
        pair = np.asarray(pair, np.float64)
        np.testing.assert_array_equal(pair[0] + pair[1], np.full(k, 2.0 ** 24 + 10))


@pytest.mark.parametrize("start,bs", [(190, 16), (0, 50), (77, 203)])
def test_epoch_matches_reference_over_padded_shards(start, bs):
    """203 rows pad to 208 at 8 shards; the windows at ``start`` run over
    the pad rows (mask 0) at the end."""
    x, _ = _blobs(3, n=203, d=6)
    rng = np.random.RandomState(4)
    w = rng.uniform(0.5, 2.0, 203).astype(np.float32)
    centers, counts = _state(5, 4, 6)
    rX = ref_shard_rows(x)
    pX = shard_rows(x)
    rmask = rX.mask * jnp.asarray(np.concatenate([w, np.zeros(5, np.float32)]))
    pmask = pX.mask * torch.from_numpy(np.concatenate([w, np.zeros(5, np.float32)]))
    n_batches = max(208 // bs, 1)
    rc, rn, ri = ref._mbk_epoch_fn(jnp.asarray(centers), jnp.asarray(counts), rX.data, rmask,
                                   jnp.int32(start), batch_size=bs, n_batches=n_batches)
    pc, pn, pi = port._mbk_epoch_fn(torch.from_numpy(centers), torch.from_numpy(counts),
                                    pX.data, pmask, start, batch_size=bs, n_batches=n_batches)
    assert pX.data.shape[0] == 208
    np.testing.assert_allclose(_np(pc), np.asarray(rc), rtol=0, atol=RTOL * np.abs(rc).max())
    np.testing.assert_allclose(float(pi), float(ri), rtol=RTOL)
    np.testing.assert_allclose(_np(pn).sum(0), np.asarray(rn).sum(0), rtol=1e-6)


def test_partial_fit_stream_matches_reference():
    x, truth = _blobs(6, n=8 * 301, d=5, k=4)
    init = truth + 1.5
    rng = np.random.RandomState(7)
    sw = rng.uniform(0.2, 3.0, 301).astype(np.float32)
    r = RefMBK(n_clusters=4, init=init, random_state=0)
    p = MiniBatchKMeans(n_clusters=4, init=init, random_state=0)
    for i in range(8):
        blk = x[i * 301:(i + 1) * 301]
        kw = {"sample_weight": sw} if i == 3 else {}
        r.partial_fit(blk, **kw)
        p.partial_fit(blk, **kw)
    rc = np.asarray(r.cluster_centers_)
    np.testing.assert_allclose(_np(p.cluster_centers_), rc, rtol=0, atol=1e-4 * np.abs(rc).max())
    assert p.n_steps_ == r.n_steps_ == 8
    # the same centres give the same answers
    xs = x[:500]
    np.testing.assert_array_equal(_np(p.predict(xs)), np.asarray(RefMBK.predict(r, xs)))
    np.testing.assert_allclose(_np(p.transform(xs)), np.asarray(r.transform(xs)), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(p.score(xs), r.score(xs), rtol=1e-4)


def test_stream_depths_are_bit_equal_and_incremental_runs():
    x, truth = _blobs(8, n=10 * 256, d=5)
    fits = {}
    for depth in (0, 2):
        m = MiniBatchKMeans(n_clusters=4, init=truth, random_state=0)
        fits[depth] = _partial.fit(m, x, chunk_size=256, prefetch_depth=depth)
        assert fits[depth].n_steps_ == 10
    assert torch.equal(fits[0].cluster_centers_, fits[2].cluster_centers_)
    assert torch.equal(fits[0]._counts, fits[2]._counts)
    inc = Incremental(MiniBatchKMeans(n_clusters=4, init=truth, random_state=0))
    inc.fit(x)
    plain = _partial.fit(MiniBatchKMeans(n_clusters=4, init=truth, random_state=0), x,
                         prefetch_depth=0)
    assert torch.equal(inc.estimator_.cluster_centers_, plain.cluster_centers_)
    assert _np(inc.predict(x[:100])).shape == (100,)


def test_reassign_starved_properties():
    x, _ = _blobs(9, n=400, d=4)
    X = shard_rows(x)
    mask = X.mask.clone()
    mask[:50] = 0.0  # rows a reseed must never pick
    centers = torch.from_numpy(_state(10, 5, 4)[0])
    counts = torch.tensor([[100.0, 80.0, 0.5, 90.0, 0.2], [0.0, 1e-6, 0.0, 0.0, 0.0]])
    gen = torch.Generator().manual_seed(0)
    calls = port._reassign_starved.calls
    same = port._reassign_starved(centers, counts, X.data, mask, gen, 0.001)
    assert same[0] is centers and same[1] is counts  # nothing starves: the inputs back
    assert port._reassign_starved.calls == calls
    new_c, new_n = port._reassign_starved(centers, counts, X.data, mask, gen, 0.01)
    assert port._reassign_starved.calls == calls + 1
    starving = torch.tensor([False, False, True, False, True])
    assert torch.equal(new_c[~starving], centers[~starving])
    assert torch.equal(new_n[:, ~starving], counts[:, ~starving])
    assert (new_n[:, starving] == 0).all()
    rows = X.data[mask > 0]
    for c in new_c[starving]:
        assert bool((rows == c).all(dim=1).any())  # a row of positive weight


def _found_every_blob(centers, truth):
    """Each true centre within 1.0 of a fitted one (unit-variance blobs)."""
    gaps = np.linalg.norm(truth[:, None] - np.asarray(centers)[None], axis=2)
    return bool((gaps.min(axis=1) < 1.0).all())


def _fit_both(init, seed):
    x, truth = _blobs(seed, n=3000, d=5, k=4, spread=20.0)
    kw = dict(n_clusters=4, init=init, random_state=seed, batch_size=256, max_iter=20)
    return x, truth, RefMBK(**kw).fit(x), MiniBatchKMeans(**kw).fit(x)


@pytest.mark.parametrize("seed", range(8))
def test_fit_inertia_within_one_percent(seed):
    """k-means++ (the default init) on every seed of a range: the port's
    inertia within 1% of the reference's, and every blob found."""
    x, truth, r, p = _fit_both("k-means++", seed)
    assert _found_every_blob(_np(p.cluster_centers_), truth)
    assert p.inertia_ <= 1.01 * r.inertia_
    assert p.labels_.shape == (3000,) and p.labels_.dtype == torch.int64
    assert p.n_steps_ == p.n_iter_ * (3000 // 256)
    np.testing.assert_array_equal(_np(p.fit_predict(x)), _np(p.labels_))


def test_random_init_finds_the_blobs_as_often_as_the_reference():
    """A random init puts two centres in one blob on many seeds, in both
    packages, and minibatch steps do not move them apart; over the same 16
    seeds the port finds every blob at least as often as the reference,
    and where both do, its inertia is within 1% of the reference's."""
    found = {"ref": 0, "port": 0}
    for seed in range(16):
        _, truth, r, p = _fit_both("random", seed)
        r_ok = _found_every_blob(r.cluster_centers_, truth)
        p_ok = _found_every_blob(_np(p.cluster_centers_), truth)
        found["ref"] += r_ok
        found["port"] += p_ok
        if r_ok and p_ok:
            assert p.inertia_ <= 1.01 * r.inertia_, seed
    assert found["ref"] >= 1 and found["port"] >= found["ref"], found


def test_fit_with_sample_weight_counts_the_weight_mass():
    x, truth = _blobs(13, n=1000, d=3)
    sw = np.full(1000, 2.0, np.float32)
    p = MiniBatchKMeans(n_clusters=4, init=truth, batch_size=100, max_iter=3,
                        max_no_improvement=None, reassignment_ratio=0.0).fit(x, sample_weight=sw)
    mass = _np(p._counts).astype(np.float64).sum()
    np.testing.assert_allclose(mass, 2.0 * 1000 * 3, rtol=1e-6)  # 3 epochs of every row
    assert p.n_iter_ == 3


def test_errors_match_reference():
    x, truth = _blobs(14, n=5, d=3)
    for cls in (RefMBK, MiniBatchKMeans):
        with pytest.raises(ValueError, match="n_samples=5 < n_clusters=6"):
            cls(n_clusters=6).fit(x)
        with pytest.raises(ValueError, match="init array must be"):
            cls(n_clusters=4, init=truth[:, :2]).partial_fit(x)
        with pytest.raises(ValueError, match="Unknown init"):
            cls(n_clusters=2, init="nope").fit(x)
    with pytest.raises(NotImplementedError, match=r"\[port-planes\]"):
        MiniBatchKMeans(n_clusters=2, fit_checkpoint=object()).fit(x)


def test_cpu_path_launches_no_kernel():
    before = (k7.mbk_step.launches, k7.mbk_epoch.launches)
    x, truth = _blobs(15, n=600, d=4)
    MiniBatchKMeans(n_clusters=4, init=truth, batch_size=64, max_iter=2).fit(x)
    MiniBatchKMeans(n_clusters=4, init=truth).partial_fit(x)
    assert (k7.mbk_step.launches, k7.mbk_epoch.launches) == before
