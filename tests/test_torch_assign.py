"""``lloyd_assign`` with candidate holes, through the wrapper that drops the
invalid slots before the pass, against the JAX reference's
``_phi_and_mind2`` and the argmin of ``_valid_d2`` on the CPU.

Inputs are made with numpy from a seed and padded to 8 shards.
Tolerances: φ and the masked min d² to rtol 1e-5 (float32 on both sides,
another summation order); a label may differ only on a row whose two
smallest valid d² are closer than 1e-5·(‖x‖²+‖c‖²).  Exact ties (a
candidate repeated in a later slot) must go to the first valid slot.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dask_ml_tpu.cluster import k_means as ref_km
from dask_ml_tpu_torch.cluster import k_means as km
from dask_ml_tpu_torch.core import mesh
from dask_ml_tpu_torch.core.sharded import shard_rows
from dask_ml_tpu_torch.ops import lloyd

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


def _case(seed, valid, dup=(), n=1501, d=5, k=24):
    """Blob rows padded to 8 shards with fractional weights, and a k-slot
    candidate list of real rows (as k-means‖ builds it).  ``valid``: the
    number of valid slots, slot 0 among them, or the one valid slot's index
    when given as a 1-tuple.  ``dup``: (earlier, later) slot pairs whose
    rows are made equal."""
    rng = np.random.RandomState(seed)
    truth = rng.uniform(-6, 6, (4, d))
    x = (truth[rng.randint(0, 4, n)] + rng.standard_normal((n, d))).astype(np.float32)
    X = shard_rows(x, n_shards=8)
    xp = X.data.numpy()
    mask = X.mask.numpy().copy()
    mask[:n] *= rng.uniform(0.05, 2.0, n).astype(np.float32)
    mask[:n][rng.rand(n) < 0.1] = 0.0
    centers = x[rng.choice(n, k, replace=False)].copy()
    cvalid = np.zeros(k, np.float32)
    if isinstance(valid, tuple):
        cvalid[valid[0]] = 1.0
    else:
        cvalid[0] = 1.0
        cvalid[1 + rng.choice(k - 1, valid - 1, replace=False)] = 1.0
    for lo, hi in dup:
        centers[hi] = centers[lo]
    return xp, mask, centers, cvalid


def _near_tie(x, centers, cvalid):
    x64, c64 = x.astype(np.float64), centers.astype(np.float64)
    d2 = ((x64[:, None, :] - c64[None]) ** 2).sum(-1)
    d2[:, cvalid <= 0] = np.inf
    two = np.sort(d2, axis=1)[:, :2]
    scale = (x64 ** 2).sum(1) + (c64 ** 2).sum(1)[np.argmin(d2, 1)]
    return (two[:, 1] - two[:, 0]) < TIE * scale


def _hold(x, mask, centers, cvalid):
    """The compacting lloyd_assign against the reference; returns labels."""
    labels, min_d2, inertia = lloyd.lloyd_assign(*map(torch.from_numpy, (x, mask, centers, cvalid)))
    ref_phi, ref_md = ref_km._phi_and_mind2(*map(jnp.asarray, (x, mask, centers, cvalid)))
    ref_labels = np.asarray(jnp.argmin(ref_km._valid_d2(
        *map(jnp.asarray, (x, centers, cvalid))), axis=1))
    assert labels.dtype == torch.int64 and labels.shape == (x.shape[0],)
    np.testing.assert_allclose(float(inertia), float(ref_phi), rtol=RTOL)
    np.testing.assert_allclose(min_d2.numpy() * mask, np.asarray(ref_md), rtol=RTOL,
                               atol=RTOL * float(np.abs(np.asarray(ref_md)).max()))
    labels = labels.numpy()
    assert (cvalid[labels] > 0).all()
    diff = labels != ref_labels
    assert not (diff & ~_near_tie(x, centers, cvalid)).any(), np.flatnonzero(diff)
    return labels, ref_labels


@pytest.mark.parametrize("seed,valid", [(0, 9), (1, 17), (2, 24), (3, 2)])
def test_holes_match_reference(seed, valid):
    _hold(*_case(seed, valid))


@pytest.mark.parametrize("seed,pairs", [
    (4, ((0, 5), (2, 11))),  # both copies valid: the earlier slot wins
    (5, ((1, 3), (6, 20))),  # may put a hole first: then the later copy is the first valid one
])
def test_exact_ties_go_to_the_first_valid_slot(seed, pairs):
    x, mask, centers, cvalid = _case(seed, 12, dup=pairs)
    for lo, hi in pairs:
        cvalid[hi] = 1.0
    # rows sitting on a repeated candidate tie exactly between its slots
    x[: 2 * len(pairs)] = np.repeat(centers[[lo for lo, _ in pairs]], 2, axis=0)
    labels, ref_labels = _hold(x, mask, centers, cvalid)
    for lo, hi in pairs:
        first = lo if cvalid[lo] > 0 else hi
        tied = np.flatnonzero((ref_labels == first) | (labels == first) | (labels == hi))
        assert tied.size > 0
        assert (labels[tied] == first).all()
        np.testing.assert_array_equal(labels[tied], ref_labels[tied])


@pytest.mark.parametrize("seed,slot", [(6, 0), (7, 23), (8, 10)])
def test_a_single_valid_slot(seed, slot):
    x, mask, centers, cvalid = _case(seed, (slot,))
    labels, _ = _hold(x, mask, centers, cvalid)
    assert (labels == slot).all()


def test_phi_and_mind2_and_candidate_weights_go_through_the_compaction():
    x, mask, centers, cvalid = _case(9, 7)
    tx, tm, tc, tv = map(torch.from_numpy, (x, mask, centers, cvalid))
    phi, md = km._phi_and_mind2(tx, tm, tc, tv)
    ref_phi, ref_md = ref_km._phi_and_mind2(*map(jnp.asarray, (x, mask, centers, cvalid)))
    np.testing.assert_allclose(float(phi), float(ref_phi), rtol=RTOL)
    # the plain version over all slots, holes selected out, gives the same labels
    labels, _, _ = lloyd.lloyd_assign(tx, tm, tc, tv)
    full, _, _ = lloyd.lloyd_assign_ref(tx, tm, tc, tv)
    torch.testing.assert_close(labels, full, rtol=0, atol=0)
    weights = km._candidate_weights(tm, labels, tc.shape[0])
    assert float(weights[tv == 0].abs().sum()) == 0.0


def test_no_valid_slot_raises():
    x, mask, centers, cvalid = _case(10, 3)
    with pytest.raises(ValueError, match="no candidate slot valid"):
        lloyd.lloyd_assign(*map(torch.from_numpy, (x, mask, centers, np.zeros_like(cvalid))))


def test_cvalid_of_the_wrong_length_raises():
    x, mask, centers, cvalid = _case(11, 3)
    with pytest.raises(ValueError, match="cvalid must be"):
        lloyd.lloyd_assign(*map(torch.from_numpy, (x, mask, centers, cvalid[:-1])))


def test_kmeans_ingest_starts_rows_on_a_16_byte_boundary():
    base = torch.from_numpy(np.random.RandomState(12).standard_normal((20, 5)).astype(np.float32))
    assert base.data_ptr() % 16 == 0
    view = base[1:17]  # 16 rows (no padding at 8 shards), 20 bytes past the start
    X = km._ingest_float(km.KMeans(n_clusters=2), view)
    assert X.data.data_ptr() % 16 == 0
    torch.testing.assert_close(X.data, view, rtol=0, atol=0)
    aligned = base[4:]  # 16 rows, 80 bytes in: taken as it is
    assert km._ingest_float(km.KMeans(n_clusters=2), aligned).data.data_ptr() == aligned.data_ptr()
