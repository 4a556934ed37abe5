"""SpectralClustering by the Nyström approximation: the port of the
default path of ``dask_ml_tpu/cluster/spectral.py`` (reference:
``dask_ml/cluster/spectral.py``).

Sample m = ``n_components`` rows S; E = k(X, S) (n×m) and A = k(S, S)
(m×m).  The normalised affinity D^{-1/2} E A⁻¹ Eᵀ D^{-1/2} has its top
eigenvectors from the m×m matrix M = GᵀG, G = D^{-1/2} E A^{-1/2}; the
rows of G·(top eigenvectors / √λ), normalised, are clustered by the
port's KMeans (K1a, K1b).  The ``rbf`` affinities go through K10's
``rbf`` epilogue (``ops/pairwise.py``); the products and the small m×m
algebra (``pinv``, ``eigh``) are ``torch.matmul`` in float32 and
``torch.linalg``, as the reference leaves them to XLA.

By design the sample indices come from a ``torch.Generator`` where the
reference draws from ``jax.random`` (``_sample_indices``).  The exact path
(``n_components=None``, ``affinity="nearest_neighbors"``) and its K13
programs are not ported yet and raise.
"""

from __future__ import annotations

import logging

import torch

from ..base import TorchEstimator
from ..core.prng import as_generator
from ..core.sharded import ShardedRows
from ..metrics.pairwise import PAIRWISE_KERNEL_FUNCTIONS, fp32_matmul
from ..preprocessing.data import _ingest_float
from ..utils import _timer
from .k_means import KMeans

logger = logging.getLogger(__name__)

__all__ = ["SpectralClustering"]

_EXACT = "the exact spectral path and its K13 programs (ROADMAP: [port-rest] K13)"


def _inv_sqrt_psd(a, eps=1e-8):
    w, v = torch.linalg.eigh(a)
    w = torch.clamp_min(w, eps)
    with fp32_matmul():
        return (v * (1.0 / torch.sqrt(w))) @ v.T


class SpectralClustering(TorchEstimator):
    def __init__(self, n_clusters=8, eigen_solver=None, random_state=None, n_init=10,
                 gamma=None, affinity="rbf", n_neighbors=10, eigen_tol=0.0,
                 assign_labels="kmeans", degree=3, coef0=1, kernel_params=None, n_jobs=1,
                 n_components=100, persist_embedding=False, kmeans_params=None):
        self.n_clusters = n_clusters
        self.eigen_solver = eigen_solver
        self.random_state = random_state
        self.n_init = n_init
        self.gamma = gamma
        self.affinity = affinity
        self.n_neighbors = n_neighbors
        self.eigen_tol = eigen_tol
        self.assign_labels = assign_labels
        self.degree = degree
        self.coef0 = coef0
        self.kernel_params = kernel_params
        self.n_jobs = n_jobs
        self.n_components = n_components
        self.persist_embedding = persist_embedding
        self.kmeans_params = kmeans_params

    def _kernel(self, X, S):
        if callable(self.affinity):
            return self.affinity(X, S)
        params = dict(self.kernel_params or {})
        if self.affinity == "rbf":
            params.setdefault("gamma", self.gamma)
            return PAIRWISE_KERNEL_FUNCTIONS["rbf"](X, S, **params)
        if self.affinity == "polynomial":
            params.setdefault("gamma", self.gamma)
            params.setdefault("degree", self.degree)
            params.setdefault("coef0", self.coef0)
            return PAIRWISE_KERNEL_FUNCTIONS["polynomial"](X, S, **params)
        raise ValueError(
            f"Unsupported affinity: {self.affinity!r} "
            "(rbf, polynomial, nearest_neighbors, precomputed, or callable)")

    def _sample_indices(self, n, m, device):
        """m distinct real row indices, uniform, from a ``torch.Generator``."""
        gen = as_generator(self.random_state, device)
        return torch.randperm(n, generator=gen, device=device)[:m]

    def _sample_affinities(self, X, idx):
        """(E, A): the cross affinity (padded n, m), pad rows zeroed, and the
        sample's own (m, m), per the configured affinity."""
        if self.affinity == "precomputed":
            E = X.data[:, idx]
            return E * X.mask[:, None], E[idx]
        sample = X.data[idx]
        E = self._kernel(X.data, sample)
        return E * X.mask[:, None], self._kernel(sample, sample)

    def fit(self, X, y=None):
        X = _ingest_float(self, X)
        n = X.n_samples
        if self.affinity == "precomputed" and X.data.shape[1] != n:
            raise ValueError(
                "affinity='precomputed' expects the (n_samples, n_samples) affinity matrix "
                f"itself; got shape ({n}, {X.data.shape[1]})")
        if self.n_components is None:
            raise NotImplementedError(f"n_components=None needs {_EXACT}")
        if self.affinity == "nearest_neighbors":
            raise NotImplementedError(f"affinity='nearest_neighbors' needs {_EXACT}")
        m = min(int(self.n_components), n)
        with _timer("affinities", logger, logging.DEBUG):
            idx = self._sample_indices(n, m, X.data.device)
            E, A = self._sample_affinities(X, idx)
        with _timer("m x m solves", logger, logging.DEBUG):
            A_inv = torch.linalg.pinv(A, hermitian=True)
            A_is = _inv_sqrt_psd(A)
        with _timer("embedding", logger, logging.DEBUG), fp32_matmul():
            col_sums = torch.sum(E, dim=0)
            # approximate degrees d = E A⁻¹ (Eᵀ 1)
            d = E @ (A_inv @ col_sums)
            d = torch.where((d > 1e-12) & (X.mask > 0), d, torch.ones_like(d))
            C = E / torch.sqrt(d)[:, None]  # D^{-1/2} E
            G = C @ A_is
            M = G.T @ G
            w, u = torch.linalg.eigh(M)  # ascending
            k = self.n_clusters
            top = torch.flip(u[:, -k:], dims=[1])
            lam = torch.clamp_min(torch.flip(w[-k:], dims=[0]), 1e-12)
            V = G @ (top / torch.sqrt(lam)[None, :])
            norms = torch.linalg.vector_norm(V, dim=1, keepdim=True)
            V = V / torch.where(norms > 1e-12, norms, torch.ones_like(norms))
        return self._finalize(V, lam, X)

    def _finalize(self, emb_data, lam, X):
        """Cluster the row-normalised embedding and set the fitted
        attributes."""
        emb = ShardedRows(data=emb_data, mask=X.mask, n_samples=X.n_samples)
        km_params = {"n_clusters": self.n_clusters, "random_state": self.random_state}
        km_params.update(self.kmeans_params or {})
        km = KMeans(**km_params)
        with _timer("KMeans", logger, logging.DEBUG):
            km.fit(emb)
        self.assign_labels_ = km
        self.labels_ = km.labels_
        self.eigenvalues_ = lam
        self.n_features_in_ = X.data.shape[1]
        if self.persist_embedding:
            self.embedding_ = emb
        return self

    def fit_predict(self, X, y=None):
        return self.fit(X).labels_
