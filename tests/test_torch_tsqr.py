"""The port's TSQR and randomized SVD (``dask_ml_tpu_torch/linalg/``)
against the JAX reference on the CPU: the reference on the 8 virtual CPU
devices of the tier-1 conftest, the port at 8 logical shards (its lanes),
the same seeded numpy inputs.

Tolerances:
- ``tsqr`` by ``cholqr2``: R within 1e-5·max|R| and Q within 1e-5, at
  203×10 (ragged padding), 40×10 (m < d on every lane) and 2003×6; and
  with the Gram summed over 64-row blocks (the path of more than 4096
  rows).
- ``tsqr`` by ``householder``: the same, after each package's R rows
  (and Q columns) are normalised to diag(R) ≥ 0 (Householder QR fixes
  those signs only by convention).
- The guard's fallback: 2003×10, X = Z·diag(10^(−6j/9))·Uᵀ (Z standard
  normal, U a seeded orthogonal matrix, cond ≈ 1e6).  A plain column
  scaling leaves the Gram's Cholesky accurate and cholqr2 accepts it, so
  the scales are rotated.  Both packages refuse cholqr2 and take the
  Householder route (some diag R < 0); R agrees after sign normalisation
  to 1e-4·max|R|.  Q's last columns are ill-posed there (their error
  grows as eps·cond), so each package's Q is held by its own
  reconstruction ‖QR − X‖_max ≤ 1e-5·max|X| and orthogonality
  ‖QᵀQ − I‖_max ≤ 1e-5.
- ``_randomized_svd_from_sketch`` fed the reference's own sketch
  (``jax.random.normal(as_key(seed), (d, k))``) against
  ``randomized_svd``: U, S and Vt within 1e-5 (of max|S| for S), after
  both are put in ``svd_flip``'s sign convention (the two libraries'
  small SVDs may sign a vector differently).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu.core.prng import as_key
from dask_ml_tpu.linalg import randomized_svd as ref_randomized_svd
from dask_ml_tpu.linalg import tsqr as ref_tsqr
from dask_ml_tpu.linalg import tsqr_svd as ref_tsqr_svd
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.linalg import HOST_READS, randomized_svd, tsqr, tsqr_strategy, tsqr_svd
from dask_ml_tpu_torch.linalg.randomized import _randomized_svd_from_sketch
from dask_ml_tpu_torch.utils import svd_flip


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


def _gaussian(seed, n, d):
    return np.random.RandomState(seed).normal(size=(n, d)).astype(np.float32)


def _ill(seed, n=2003, d=10):
    rng = np.random.RandomState(seed)
    z = rng.normal(size=(n, d))
    u, _ = np.linalg.qr(rng.normal(size=(d, d)))
    return ((z * 10.0 ** (-6.0 * np.arange(d) / (d - 1))) @ u.T).astype(np.float32)


def _both(X, strategy):
    q_ref, r_ref = ref_tsqr(ref_shard_rows(X), strategy=strategy)
    q, r = tsqr(shard_rows(X), strategy=strategy)
    return np.asarray(q_ref), np.asarray(r_ref), q.numpy(), r.numpy()


def _flip(u, s, vt):
    """(U, S, Vt) as numpy in ``svd_flip``'s convention (signs by Vt)."""
    u, vt = svd_flip(torch.tensor(np.asarray(u)), torch.tensor(np.asarray(vt)), False)
    return u.numpy(), np.asarray(s), vt.numpy()


def _positive_diag(q, r):
    s = np.where(np.diag(r) < 0, -1.0, 1.0).astype(r.dtype)
    return q * s, r * s[:, None]


SHAPES = [(203, 10), (40, 10), (2003, 6)]


@pytest.mark.parametrize("n,d", SHAPES)
def test_cholqr2_matches_reference(n, d):
    q_ref, r_ref, q, r = _both(_gaussian(n + d, n, d), "cholqr2")
    assert q.shape == q_ref.shape and r.shape == r_ref.shape == (d, d)
    assert (np.diag(r) > 0).all()  # the guard accepted
    np.testing.assert_allclose(r, r_ref, rtol=0, atol=1e-5 * np.abs(r_ref).max())
    np.testing.assert_allclose(q, q_ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,d", [(203, 10), (2003, 6)])
def test_cholqr2_blocked_gram_matches_reference(n, d, monkeypatch):
    # 64-row blocks: the path a Gram of more than 4096 rows takes, with a
    # tail of rows past the last whole block
    tsqr_module = importlib.import_module("dask_ml_tpu_torch.linalg.tsqr")
    monkeypatch.setattr(tsqr_module, "_GRAM_ROWS", 64)
    q_ref, r_ref, q, r = _both(_gaussian(n + d, n, d), "cholqr2")
    np.testing.assert_allclose(r, r_ref, rtol=0, atol=1e-5 * np.abs(r_ref).max())
    np.testing.assert_allclose(q, q_ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,d", SHAPES)
def test_householder_matches_reference_after_sign_normalisation(n, d):
    q_ref, r_ref, q, r = _both(_gaussian(n + d, n, d), "householder")
    q_ref, r_ref = _positive_diag(q_ref, r_ref)
    q, r = _positive_diag(q, r)
    np.testing.assert_allclose(r, r_ref, rtol=0, atol=1e-5 * np.abs(r_ref).max())
    np.testing.assert_allclose(q, q_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.triu(r), r, rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_ill_conditioned_input_takes_the_householder_route_in_both(seed):
    X = _ill(seed)
    reads = HOST_READS["reads"]
    q_ref, r_ref, q, r = _both(X, "cholqr2")
    assert HOST_READS["reads"] == reads + 1  # one guard read a factorization
    assert (np.diag(r_ref) < 0).any() and (np.diag(r) < 0).any()
    _, r_ref = _positive_diag(q_ref, r_ref)
    q, r = _positive_diag(q, r)
    np.testing.assert_allclose(r, r_ref, rtol=0, atol=1e-4 * np.abs(r_ref).max())
    xp = np.zeros_like(q)
    xp[: X.shape[0]] = X
    assert np.abs(q @ r - xp).max() <= 1e-5 * np.abs(X).max()
    assert np.abs(q.T @ q - np.eye(X.shape[1])).max() <= 1e-5


def test_plain_tensor_rows_are_padded_to_lanes_and_sliced_back():
    X = _gaussian(3, 203, 7)
    q, r = tsqr(torch.from_numpy(X))
    assert q.shape == (203, 7)
    q_s, r_s = tsqr(shard_rows(X))
    np.testing.assert_array_equal(r.numpy(), r_s.numpy())
    np.testing.assert_array_equal(q.numpy(), q_s.numpy()[:203])


def test_tsqr_svd_matches_reference():
    X = _gaussian(4, 203, 10)
    u_ref, s_ref, vt_ref = _flip(*ref_tsqr_svd(ref_shard_rows(X)))
    u, s, vt = _flip(*tsqr_svd(shard_rows(X)))
    np.testing.assert_allclose(s, s_ref, rtol=1e-5)
    np.testing.assert_allclose(vt, vt_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(u, u_ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(8, 10), (9, 10)])
def test_wide_matrix_raises_on_its_true_shape(shape):
    # 9 rows pad to 16 at 8 shards: the true shape must still be refused
    with pytest.raises(ValueError, match="tall-skinny"):
        tsqr(shard_rows(np.ones(shape, np.float32)))


def test_unknown_strategy_raises():
    with pytest.raises(ValueError, match="strategy"):
        tsqr(shard_rows(_gaussian(0, 40, 4)), strategy="qr")


def test_strategy_knob_is_honoured(monkeypatch):
    X = shard_rows(_gaussian(5, 203, 10))
    monkeypatch.delenv("DASK_ML_TPU_TORCH_TSQR", raising=False)
    assert tsqr_strategy() == "cholqr2"
    monkeypatch.setenv("DASK_ML_TPU_TORCH_TSQR", "householder")
    assert tsqr_strategy() == "householder"
    reads = HOST_READS["reads"]
    q, r = tsqr(X)
    assert HOST_READS["reads"] == reads  # no guard to read
    q_h, r_h = tsqr(X, strategy="householder")
    np.testing.assert_array_equal(r.numpy(), r_h.numpy())
    monkeypatch.setenv("DASK_ML_TPU_TORCH_TSQR", "cholqr2")
    np.testing.assert_array_equal(tsqr(X)[1].numpy(), tsqr(X, strategy="cholqr2")[1].numpy())
    monkeypatch.setenv("DASK_ML_TPU_TORCH_TSQR", "fast")
    with pytest.raises(ValueError, match="DASK_ML_TPU_TORCH_TSQR"):
        tsqr(X)


@pytest.mark.parametrize("n,d,k,n_iter,seed", [(2003, 12, 3, 4, 0), (203, 10, 4, 2, 7),
                                               (2003, 6, 5, 0, 3)])
def test_randomized_svd_from_the_reference_sketch(n, d, k, n_iter, seed):
    X = _gaussian(seed, n, d) * np.linspace(3.0, 0.2, d, dtype=np.float32)
    u_ref, s_ref, vt_ref = _flip(*ref_randomized_svd(ref_shard_rows(X), k, n_iter=n_iter,
                                                     random_state=seed))
    width = min(k + 10, d, n)
    g = np.asarray(jax.random.normal(as_key(seed), (d, width), jnp.float32))
    Xs = shard_rows(X)
    u, s, vt = _flip(*_randomized_svd_from_sketch(Xs.data, torch.tensor(g), k, n_iter))
    np.testing.assert_allclose(s, s_ref, rtol=0, atol=1e-5 * s_ref.max())
    np.testing.assert_allclose(vt, vt_ref, rtol=0, atol=1e-5)
    np.testing.assert_allclose(u, u_ref, rtol=0, atol=1e-5)


def test_randomized_svd_draws_its_own_sketch():
    X = _gaussian(2, 203, 10)
    u, s, vt = randomized_svd(shard_rows(X), 3, random_state=1)
    assert u.shape == (208, 3) and s.shape == (3,) and vt.shape == (3, 10)
    again = randomized_svd(shard_rows(X), 3, random_state=1)
    np.testing.assert_array_equal(s.numpy(), again[1].numpy())
    np.testing.assert_allclose(s.numpy(), np.linalg.svd(X, compute_uv=False)[:3], rtol=1e-3)
    with pytest.raises(ValueError, match="n_components"):
        randomized_svd(shard_rows(X), 11)
