"""The port's SpectralClustering (``cluster/spectral.py``, the Nyström path)
against the JAX reference's, on the CPU: the port at 8 logical shards, the
same numpy inputs for both.  The reference runs on a one-device mesh here:
its Nyström fit's eager operations on rows sharded over the 8 virtual
devices each rendezvous all 8 device threads for an all-reduce, and now and
then one never arrives (seen in about 1 process of 8 on an 8-core host,
with or without torch loaded: "Termination timeout for all reduce ... only
7 of them arrived"), which aborts the whole test process; on one device
there is no rendezvous (96 fits, none stuck).

The sample indices are drawn by ``jax.random`` in the reference and by a
``torch.Generator`` in the port; the parity cases pin the port's sample to
the reference's (``_sample_indices``).  Tolerances:
- E and A within 1e-5 of their largest entry (float32 affinities: K10's
  rbf epilogue, or a product);
- ``eigenvalues_`` within rtol 1e-4 and each embedding column equal up to
  its sign within 1e-4 (float32 ``pinv``/``eigh`` of m×m matrices in both
  packages; the cases keep A well conditioned, m = 24 and γ = 0.3, so
  their rounding stays far below these);
- a full fit on well-separated blobs: labels equal to the reference's up
  to a permutation on at least 99% of the rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dask_ml_tpu.cluster import SpectralClustering as RefSC
from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu.core.mesh import device_mesh, use_mesh
from dask_ml_tpu.core.prng import as_key
from dask_ml_tpu_torch.cluster import SpectralClustering
from dask_ml_tpu_torch.core import mesh, shard_rows

TOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    mesh.set_device("cpu")
    mesh.set_n_shards(8)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with use_mesh(device_mesh(1)):  # the reference's mesh (module docstring)
        yield
    mesh.set_device(None)
    mesh.set_n_shards(1)
    torch.set_num_threads(threads)


def _blobs(seed, n=400, d=4, k=3, spread=3.0, sizes=(5, 3, 2)):
    rng = np.random.RandomState(seed)
    truth = rng.uniform(-spread, spread, (k, d))
    lab = rng.choice(k, n, p=np.asarray(sizes) / np.sum(sizes))
    return (truth[lab] + rng.standard_normal((n, d))).astype(np.float32), lab


def _ref_indices(n, m, random_state=0):
    return np.array(jax.random.choice(as_key(random_state), n, (m,), replace=False))


def _pin(est, idx):
    est._sample_indices = lambda n, m, device: torch.as_tensor(idx, device=device)
    return est


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("affinity", ["rbf", "polynomial", "callable", "precomputed"])
def test_sample_affinities_match_reference(affinity):
    x, _ = _blobs(1, n=203)
    kw = {"gamma": 0.3, "degree": 2, "coef0": 1.0}
    if affinity == "callable":
        kw = {}
        port_aff = lambda a, b: torch.exp(-0.5 * torch.cdist(a, b) ** 2)  # noqa: E731
        ref_aff = lambda a, b: jnp.exp(  # noqa: E731
            -0.5 * jnp.sum((a[:, None, :] - b[None]) ** 2, axis=-1))
    else:
        port_aff = ref_aff = affinity
    if affinity == "precomputed":
        x = np.exp(-0.3 * ((x[:, None, :] - x[None]) ** 2).sum(-1)).astype(np.float32)
    idx = _ref_indices(203, 24)
    port = SpectralClustering(n_clusters=3, affinity=port_aff, n_components=24, **kw)
    ref = RefSC(n_clusters=3, affinity=ref_aff, n_components=24, **kw)
    E, A = port._sample_affinities(shard_rows(x), torch.as_tensor(idx))
    rE, rA = ref._sample_affinities(ref_shard_rows(x), jnp.asarray(idx))
    assert tuple(E.shape) == (208, 24) and tuple(A.shape) == (24, 24)
    assert (E[203:] == 0).all()  # pad rows masked out
    for got, want in ((E[:203], rE), (A, rA)):
        want = np.asarray(want)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_pinned_sample_eigenpairs_match_reference(seed):
    x, _ = _blobs(seed)
    idx = _ref_indices(400, 24)
    kw = dict(n_clusters=3, random_state=0, n_components=24, gamma=0.3, persist_embedding=True)
    ref = RefSC(**kw).fit(x)
    port = _pin(SpectralClustering(**kw), idx).fit(x)
    np.testing.assert_allclose(_np(port.eigenvalues_), np.asarray(ref.eigenvalues_), rtol=1e-4)
    got, want = _np(port.embedding_.data), np.asarray(ref.embedding_.data)
    assert got.shape == want.shape == (400, 3)
    sign = np.sign((got * want).sum(0))
    np.testing.assert_allclose(got * sign, want, rtol=0, atol=1e-4)
    assert port.labels_.shape == (400,) and port.labels_.dtype == torch.int64


def _agreement(a, b, k):
    """Share of rows on which labelings a and b agree under the best
    one-to-one matching of their labels (greedy on the contingency table,
    exact for well-separated clusters)."""
    table = np.zeros((k, k), np.int64)
    np.add.at(table, (a, b), 1)
    hits = 0
    for _ in range(k):
        i, j = np.unravel_index(np.argmax(table), table.shape)
        hits += table[i, j]
        table[i, :] = -1
        table[:, j] = -1
    return hits / a.shape[0]


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_labels_match_reference_up_to_permutation(seed):
    x, lab = _blobs(seed, n=600, d=5, spread=20.0, sizes=(1, 1, 1))
    ref = RefSC(n_clusters=3, random_state=0).fit(x)
    port = SpectralClustering(n_clusters=3, random_state=0).fit(x)
    got, want = _np(port.labels_), np.asarray(ref.labels_)
    assert _agreement(got, want, 3) >= 0.99
    assert _agreement(got, lab, 3) >= 0.99
    np.testing.assert_array_equal(_np(port.fit_predict(x)), got)
    assert port.eigenvalues_.shape == (3,)


def test_exact_path_raises_naming_its_roadmap_item():
    x, _ = _blobs(2, n=64)
    with pytest.raises(NotImplementedError, match=r"\[port-rest\] K13"):
        SpectralClustering(n_clusters=2, n_components=None).fit(x)
    with pytest.raises(NotImplementedError, match=r"\[port-rest\] K13"):
        SpectralClustering(n_clusters=2, affinity="nearest_neighbors").fit(x)


def test_errors_match_reference():
    x, _ = _blobs(2, n=64)
    for cls in (RefSC, SpectralClustering):
        with pytest.raises(ValueError, match="precomputed"):
            cls(n_clusters=2, affinity="precomputed").fit(x)
        with pytest.raises(ValueError, match="Unsupported affinity"):
            cls(n_clusters=2, affinity="laplacian").fit(x)
