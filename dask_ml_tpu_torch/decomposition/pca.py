"""PCA of a tall-skinny matrix: the port of ``dask_ml_tpu/decomposition/pca.py``.

Masked centering zeroes the padded rows, then TSQR (exact, ``full`` or
``tsqr``) or Halko (``randomized``) factors the centred rows; the fitted
statistics are computed on the device.  Every product runs in float32
with TF32 off (``fp32_matmul``).  Fitted attributes are tensors on the
rows' device (``n_components_``, ``n_samples_`` and ``n_features_in_``
are ints).
"""

from __future__ import annotations

import math

import torch

from ..base import ComponentsOutMixin, TorchEstimator, TransformerMixin
from ..core.sharded import ShardedRows, masked_mean, masked_var
from ..linalg import randomized_svd, tsqr_svd
from ..linalg.tsqr import host_read
from ..metrics.pairwise import fp32_matmul
from ..preprocessing.data import _ingest_float, _like_input, _masked_or_plain
from ..utils import svd_flip


def model_covariance(est):
    """The probabilistic-PCA model covariance of a fitted PCA or
    IncrementalPCA (scikit-learn's formula, whiten=True included: the
    components rescaled by √λ before the (λ−σ²) weighting)."""
    c = est.components_
    ev = est.explained_variance_
    if est.whiten:
        c = c * torch.sqrt(ev)[:, None]
    diff = torch.clamp_min(ev - est.noise_variance_, 0.0)
    with fp32_matmul():
        cov = (c.T * diff) @ c
    d = c.shape[1]
    return cov + est.noise_variance_ * torch.eye(d, dtype=cov.dtype, device=cov.device)


def model_precision(est):
    """The inverse of :func:`model_covariance` by the matrix-inversion
    lemma, O(d·k²) where k < d and σ² > 0; otherwise the plain inverse, or
    (singular covariance only) the inverse after a trace-scaled jitter of
    1e-12·tr/d, finite where scikit-learn raises."""
    d = est.components_.shape[1]
    ev = est.explained_variance_
    nv = est.noise_variance_
    if host_read(nv) == 0.0 or est.n_components_ >= d:
        cov = model_covariance(est)
        # inv_ex: a singular covariance gives a nonzero info, where
        # torch.linalg.inv would raise and jnp.linalg.inv returns non-finites
        prec, info = torch.linalg.inv_ex(cov)
        if host_read((info == 0) & torch.isfinite(prec).all()):
            return prec
        jitter = 1e-12 * torch.trace(cov) / d
        return torch.linalg.inv(cov + jitter * torch.eye(d, dtype=cov.dtype, device=cov.device))
    c = est.components_
    if est.whiten:
        c = c * torch.sqrt(ev)[:, None]
    diff = torch.clamp_min(ev - nv, 0.0)
    # a component of pure noise (diff == 0) adds nothing to the covariance,
    # so its row is zeroed rather than letting 1/diff blow up
    c = c * (diff > 0)[:, None]
    with fp32_matmul():
        inner = torch.diag(1.0 / torch.where(diff > 0, diff, torch.ones_like(diff))) + (c @ c.T) / nv
        middle = torch.linalg.inv(inner)
        eye = torch.eye(d, dtype=c.dtype, device=c.device)
        return (eye - (c.T @ middle @ c) / nv) / nv


class PCA(ComponentsOutMixin, TransformerMixin, TorchEstimator):
    """Principal component analysis of a tall-skinny matrix,
    ``svd_solver`` in ``auto`` | ``full`` | ``tsqr`` | ``randomized``."""

    def __init__(self, n_components=None, copy=True, whiten=False,
                 svd_solver="auto", tol=0.0, iterated_power=4, random_state=None):
        self.n_components = n_components
        self.copy = copy
        self.whiten = whiten
        self.svd_solver = svd_solver
        self.tol = tol
        self.iterated_power = iterated_power
        self.random_state = random_state

    def _resolve(self, n_samples, n_features):
        """(n_components, solver) by the reference's ``auto`` policy:
        randomized for an int below 0.8·min(n, d) when d > 50, else full;
        ``tsqr`` is ``full``."""
        n_components = self.n_components
        if n_components is None:
            n_components = min(n_samples, n_features)
        solver = self.svd_solver
        if solver == "auto":
            if isinstance(n_components, float):
                solver = "full"
            elif n_components < 0.8 * min(n_samples, n_features) and n_features > 50:
                solver = "randomized"
            else:
                solver = "full"
        if solver == "tsqr":
            solver = "full"
        return n_components, solver

    @staticmethod
    def _center(X: ShardedRows):
        mean = masked_mean(X.data, X.mask)
        return (X.data - mean) * X.mask[:, None], mean

    def fit(self, X, y=None):
        self._fit(X)
        return self

    def _fit(self, X):
        X = _ingest_float(self, X)
        n, d = X.n_samples, X.data.shape[1]
        if n < d:
            raise ValueError(f"n_samples ({n}) must be >= n_features ({d}) for tall-skinny PCA")
        n_components, solver = self._resolve(n, d)
        if isinstance(n_components, float):
            if not 0 < n_components <= 1.0:
                raise ValueError(f"Invalid n_components: {n_components}")
            k_request = d
        else:
            if n_components > d:
                raise ValueError(f"n_components={n_components} must be <= n_features={d}")
            k_request = n_components

        centered, mean = self._center(X)
        if solver == "randomized":
            u, s, vt = randomized_svd(centered, k_request, n_iter=self.iterated_power,
                                      random_state=self.random_state)
        else:
            u, s, vt = tsqr_svd(centered)
        del centered
        # scikit-learn >= 1.5 flips on V, whatever the row order or padding
        u, vt = svd_flip(u, vt, u_based_decision=False)

        explained = s ** 2 / (n - 1)
        if solver == "randomized":
            total_var = torch.sum(masked_var(X.data, X.mask, ddof=1))
        else:
            total_var = torch.sum(explained)
        ratio = explained / total_var

        if isinstance(n_components, float):
            cum = torch.cumsum(ratio, dim=0)
            target = torch.tensor([n_components], dtype=cum.dtype, device=cum.device)
            k = min(int(host_read(torch.searchsorted(cum, target, side="left")[0])) + 1, len(s))
        else:
            k = n_components

        self.n_components_ = k
        self.components_ = vt[:k]
        self.explained_variance_ = explained[:k]
        self.explained_variance_ratio_ = ratio[:k]
        self.singular_values_ = s[:k]
        self.mean_ = mean
        self.n_samples_ = n
        self.n_features_in_ = d
        if k < min(n, d):
            self.noise_variance_ = (total_var - torch.sum(explained[:k])) / (min(n, d) - k)
        else:
            self.noise_variance_ = torch.zeros((), dtype=s.dtype, device=s.device)
        return u, s, vt

    def transform(self, X):
        x, _ = _masked_or_plain(X)
        with fp32_matmul():
            out = (x - self.mean_) @ self.components_.T
        if self.whiten:
            out = out / torch.sqrt(self.explained_variance_)
        return _like_input(X, out)

    def fit_transform(self, X, y=None):
        u, s, _ = self._fit(X)
        k = self.n_components_
        out = u[:, :k] * s[:k]
        if self.whiten:
            out = out * math.sqrt(self.n_samples_ - 1) / s[:k]
        if isinstance(X, ShardedRows):
            return ShardedRows(data=out, mask=X.mask, n_samples=X.n_samples)
        return out[: self.n_samples_]

    def inverse_transform(self, X):
        x, _ = _masked_or_plain(X)
        if self.whiten:
            x = x * torch.sqrt(self.explained_variance_)
        with fp32_matmul():
            return _like_input(X, x @ self.components_ + self.mean_)

    def get_covariance(self):
        """Model covariance (probabilistic PCA), scikit-learn's formula."""
        return model_covariance(self)

    def get_precision(self):
        """Inverse of :meth:`get_covariance` by the matrix-inversion lemma."""
        return model_precision(self)

    def score_samples(self, X):
        """Each sample's log-likelihood under the probabilistic PCA model
        (Tipping & Bishop 1999), with a 1e-12·tr/d jitter on the covariance
        so that its Cholesky stays well-posed when σ² is 0."""
        x, _ = _masked_or_plain(X)
        xc = x - self.mean_
        cov = self.get_covariance()
        d = cov.shape[0]
        jitter = 1e-12 * torch.trace(cov) / d
        cov = cov + jitter * torch.eye(d, dtype=cov.dtype, device=cov.device)
        chol = torch.linalg.cholesky(cov)
        with fp32_matmul():
            sol = torch.cholesky_solve(xc.T, chol)  # (d, n)
        mahal = torch.sum(xc.T * sol, dim=0)
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
        ll = -0.5 * (d * math.log(2.0 * math.pi) + logdet + mahal)
        if isinstance(X, ShardedRows):
            return ll[: X.n_samples]
        return ll

    def score(self, X, y=None):
        """Mean of :meth:`score_samples` over the real rows."""
        return float(torch.mean(self.score_samples(X)))
