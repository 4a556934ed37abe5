"""The Lloyd kernels' plain versions and the bucket sum, against the JAX
reference on the CPU; the kernels themselves against their plain versions
on a card.

Tolerances: float32 on both sides with a different summation order, so
sums, centers and inertia agree to rtol 1e-5 of their magnitude (for the
sums, each cluster's Σ|mask·x|).  A label may differ only on a row whose
two smallest d² are closer than 1e-5·(‖x‖²+‖c‖²), where the expansion's
rounding can pick either center.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dask_ml_tpu.cluster import k_means as ref_km
from dask_ml_tpu.ops import scatter as ref_scatter
from dask_ml_tpu_torch.cluster import k_means as km
from dask_ml_tpu_torch.core import mesh
from dask_ml_tpu_torch.core.sharded import shard_rows
from dask_ml_tpu_torch.ops import lloyd, scatter

RTOL = 1e-5
TIE = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    mesh.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    mesh.set_device(None)
    torch.set_num_threads(threads)


def _case(seed, n=2001, d=6, k=5, fractional=True, empty=False):
    """Blobs, padded to 8 shards, with fractional weights and (optionally)
    one center placed where no row is closest to it."""
    rng = np.random.RandomState(seed)
    truth = rng.uniform(-10, 10, (k, d))
    x = (truth[rng.randint(0, k, n)] + rng.standard_normal((n, d))).astype(np.float32)
    centers = (truth + rng.standard_normal((k, d))).astype(np.float32)
    if empty:
        centers[-1] = 1e3
    X = shard_rows(x, n_shards=8)
    mask = X.mask.numpy().copy()
    if fractional:
        mask[:n] *= rng.uniform(0.05, 2.0, n).astype(np.float32)
        mask[:n][rng.rand(n) < 0.1] = 0.0
    return X.data.numpy(), mask, centers, n


def _near_tie(x, centers, cvalid=None):
    """Rows whose two smallest d² are within the rounding of the expansion."""
    x64, c64 = x.astype(np.float64), centers.astype(np.float64)
    d2 = ((x64[:, None, :] - c64[None]) ** 2).sum(-1)
    if cvalid is not None:
        d2[:, np.asarray(cvalid) <= 0] = np.inf
    two = np.sort(d2, axis=1)[:, :2]
    scale = (x64 ** 2).sum(1) + (c64 ** 2).sum(1)[np.argmin(d2, 1)]
    return (two[:, 1] - two[:, 0]) < TIE * scale


def _assert_labels(port, ref, x, centers, cvalid=None):
    port, ref = np.asarray(port), np.asarray(ref)
    diff = port != ref
    assert not (diff & ~_near_tie(x, centers, cvalid)).any(), np.flatnonzero(diff)


def _cluster_mag(x, mask, labels, k):
    return np.stack([(np.abs(x) * mask[:, None])[labels == c].sum(0)
                     for c in range(k)])


@pytest.mark.parametrize("seed,fractional,empty", [
    (0, False, False), (1, True, False), (2, True, True), (3, False, True)])
def test_lloyd_round_matches_reference(seed, fractional, empty):
    x, mask, centers, _ = _case(seed, fractional=fractional, empty=empty)
    k = centers.shape[0]
    ref_new, ref_inertia, ref_shift = ref_km._lloyd_step_fn(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(centers))
    ref_labels = np.asarray(jnp.argmin(
        ref_km._sq_dists(jnp.asarray(x), jnp.asarray(centers)), axis=1))

    tx, tm, tc = map(torch.from_numpy, (x, mask, centers))
    sums, counts, inertia = lloyd.lloyd_assign_reduce_ref(tx, tm, tc)
    labels, _, _ = lloyd.lloyd_assign_ref(tx, tm, tc)
    _assert_labels(labels.numpy(), ref_labels, x, centers)

    ref_sums = np.asarray(ref_scatter.bucket_sum(
        jnp.asarray(x * mask[:, None]), jnp.asarray(ref_labels), k,
        precision=jax.lax.Precision.HIGHEST, strategy="segsum"))
    ref_counts = np.asarray(ref_scatter.bucket_sum(
        jnp.asarray(mask), jnp.asarray(ref_labels), k, strategy="segsum"))
    mag = _cluster_mag(x, mask, ref_labels, k)
    assert (np.abs(sums.numpy() - ref_sums) <= RTOL * mag + 1e-30).all()
    np.testing.assert_allclose(counts.numpy(), ref_counts, rtol=RTOL)
    if empty:
        assert counts[-1] == 0

    new, inertia2, shift = km._lloyd_step_fn(tx, tm, tc)
    np.testing.assert_allclose(float(inertia2), float(inertia), rtol=0)
    np.testing.assert_allclose(float(inertia), float(ref_inertia), rtol=RTOL)
    np.testing.assert_allclose(new.numpy(), np.asarray(ref_new), rtol=RTOL,
                               atol=RTOL * np.abs(centers).max())
    if empty:  # an empty cluster keeps its center
        np.testing.assert_array_equal(new[-1].numpy(), centers[-1])
    # the shift is Σ(new−old)²: its error is the centers' error times 2‖Δ‖
    delta = np.sqrt(float(ref_shift))
    err = RTOL * np.abs(centers).max() * np.sqrt(centers.size)
    assert abs(float(shift) - float(ref_shift)) <= 2 * delta * err + err ** 2


# The plain round (what ``lloyd_assign_reduce`` runs on the CPU) against
# the JAX ``_lloyd_step_fn`` at sizes the other cases do not take: a few
# rows, odd widths, more clusters, and nothing weighted.  The kernel's own
# edges are the ``cuda`` cases of tests/test_torch_kernels.py.
@pytest.mark.parametrize("n,d,k,zero_mask", [
    (100, 50, 8, False),    # few rows
    (300, 3, 17, False),    # an odd width, many clusters for the rows
    (2001, 130, 9, False),  # a wide row
    (2001, 6, 5, True),     # nothing weighted: every center stays
])
def test_lloyd_round_edges_match_reference(n, d, k, zero_mask):
    x, mask, centers, _ = _case(10 + d, n=n, d=d, k=k)
    if zero_mask:
        mask[:] = 0.0
    ref_new, ref_inertia, _ = ref_km._lloyd_step_fn(*map(jnp.asarray, (x, mask, centers)))
    new, inertia, _ = km._lloyd_step_fn(*map(torch.from_numpy, (x, mask, centers)))
    np.testing.assert_allclose(new.numpy(), np.asarray(ref_new), rtol=RTOL,
                               atol=RTOL * np.abs(x).max())
    np.testing.assert_allclose(float(inertia), float(ref_inertia), rtol=RTOL)
    if zero_mask:
        np.testing.assert_array_equal(new.numpy(), centers)
        assert float(inertia) == 0.0


@pytest.mark.parametrize("seed,fractional", [(4, False), (5, True)])
def test_assign_matches_reference(seed, fractional):
    x, mask, centers, n = _case(seed, fractional=fractional)
    ref_labels, ref_inertia = ref_km._assign_fn(
        jnp.asarray(x), jnp.asarray(mask), jnp.asarray(centers))
    labels, min_d2, inertia = lloyd.lloyd_assign_ref(*map(torch.from_numpy, (x, mask, centers)))
    assert labels.dtype == torch.int64
    _assert_labels(labels.numpy(), ref_labels, x, centers)
    np.testing.assert_allclose(float(inertia), float(ref_inertia), rtol=RTOL)
    # every pad row computes a distance and carries zero weight
    assert np.isfinite(min_d2.numpy()).all()
    assert (mask[n:] == 0).all()


@pytest.mark.parametrize("seed", [6, 7])
def test_phi_and_mind2_with_invalid_slots_match_reference(seed):
    x, mask, centers, _ = _case(seed, k=7)
    rng = np.random.RandomState(seed)
    cvalid = (rng.rand(7) < 0.5).astype(np.float32)
    cvalid[0] = 1.0
    # a hole must not win even when it is the nearest center
    centers[np.flatnonzero(cvalid == 0)] = x[: (cvalid == 0).sum()]
    ref_phi, ref_md = ref_km._phi_and_mind2(*map(jnp.asarray, (x, mask, centers, cvalid)))
    phi, md = km._phi_and_mind2(*map(torch.from_numpy, (x, mask, centers, cvalid)))
    np.testing.assert_allclose(float(phi), float(ref_phi), rtol=RTOL)
    scale = (x.astype(np.float64) ** 2).sum(1) + (centers.astype(np.float64) ** 2).sum(1).max()
    assert (np.abs(md.numpy() - np.asarray(ref_md)) <= TIE * scale * mask + 1e-30).all()
    labels, _, _ = lloyd.lloyd_assign_ref(*map(torch.from_numpy, (x, mask, centers, cvalid)))
    assert (cvalid[labels.numpy()] > 0).all()


@pytest.mark.parametrize("strategy", ["segsum", "onehot"])
@pytest.mark.parametrize("shape", [(97,), (97, 4)])
def test_bucket_sum_matches_reference(strategy, shape):
    rng = np.random.RandomState(8)
    values = rng.standard_normal(shape).astype(np.float32)
    ids = rng.randint(0, 6, shape[0]).astype(np.int32)
    ref = ref_scatter.bucket_sum(jnp.asarray(values), jnp.asarray(ids), 6,
                                 precision=jax.lax.Precision.HIGHEST,
                                 strategy=strategy)
    out = scatter.bucket_sum(torch.from_numpy(values), torch.from_numpy(ids), 6,
                             strategy=strategy)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-6)


def test_bucket_sum_guard_and_validation():
    assert scatter.scatter_strategy(4096, "onehot") == "segsum"
    assert scatter.scatter_strategy(8) == "segsum"
    assert scatter.scatter_strategy(8, "onehot") == "onehot"
    with pytest.raises(ValueError):
        scatter.bucket_sum(torch.ones(3), torch.zeros(4, dtype=torch.int64), 2)
    with pytest.raises(ValueError):
        scatter.bucket_sum(torch.ones(3), torch.zeros(3, dtype=torch.int64), 2,
                           strategy="scatter")


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    x, mask, centers, _ = _case(9, n=100)
    tx, tm, tc = map(torch.from_numpy, (x, mask, centers))
    before = (lloyd.lloyd_assign.launches, lloyd.lloyd_assign_reduce.launches)
    for got, want in zip(lloyd.lloyd_assign_reduce(tx, tm, tc),
                         lloyd.lloyd_assign_reduce_ref(tx, tm, tc)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for got, want in zip(lloyd.lloyd_assign(tx, tm, tc),
                         lloyd.lloyd_assign_ref(tx, tm, tc)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the plain version is not a launch
    assert (lloyd.lloyd_assign.launches, lloyd.lloyd_assign_reduce.launches) == before


def test_wrapper_validates_what_the_kernel_takes():
    x = torch.zeros(10, 3)
    with pytest.raises(TypeError):
        lloyd._validate(x.double(), torch.ones(10), torch.zeros(2, 3))
    with pytest.raises(ValueError):
        lloyd._validate(x, torch.ones(9), torch.zeros(2, 3))
    with pytest.raises(ValueError):
        lloyd._validate(x.t(), torch.ones(3), torch.zeros(2, 10))
    with pytest.raises(ValueError):
        lloyd._validate(x, torch.ones(10), torch.zeros(2, 3), torch.ones(3))
