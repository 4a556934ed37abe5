"""TruncatedSVD, PCA without centering: the port of
``dask_ml_tpu/decomposition/truncated_svd.py``.

``algorithm`` is ``tsqr`` (exact; ``full`` is the same) or
``randomized``.  Padded rows are zeroed before the factorization: there
is no centering to do it, and rows from an upstream transform can carry
nonzero padding.  ``fit_streamed`` is host numpy, as in the reference.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..base import ComponentsOutMixin, TorchEstimator, TransformerMixin
from ..core.mesh import get_device
from ..core.sharded import ShardedRows, masked_var
from ..linalg import randomized_svd, tsqr_svd
from ..metrics.pairwise import fp32_matmul
from ..preprocessing.data import _ingest_float, _like_input, _masked_or_plain
from ..utils import check_random_state, svd_flip


class TruncatedSVD(ComponentsOutMixin, TransformerMixin, TorchEstimator):
    """Truncated SVD of a tall-skinny matrix, without centering."""

    def __init__(self, n_components=2, algorithm="tsqr", n_iter=5,
                 random_state=None, tol=0.0, compute=True):
        self.n_components = n_components
        self.algorithm = algorithm
        self.n_iter = n_iter
        self.random_state = random_state
        self.tol = tol
        self.compute = compute

    def fit(self, X, y=None):
        self.fit_transform(X)
        return self

    def fit_transform(self, X, y=None):
        X_in = X
        X = _ingest_float(self, X)
        d = X.data.shape[1]
        k = self.n_components
        if not 0 < k < d:
            raise ValueError(f"n_components must be in (0, n_features={d}); got {k}")
        data = X.data * X.mask[:, None]
        if self.algorithm in ("tsqr", "full"):
            u, s, vt = tsqr_svd(data)
            u, s, vt = u[:, :k], s[:k], vt[:k]
        elif self.algorithm == "randomized":
            u, s, vt = randomized_svd(data, k, n_iter=self.n_iter,
                                      random_state=self.random_state)
        else:
            raise ValueError(f"Unknown algorithm: {self.algorithm!r}")
        del data
        u, vt = svd_flip(u, vt, u_based_decision=False)

        transformed = u * s
        n = X.n_samples
        self.components_ = vt
        exp_var = masked_var(transformed, X.mask)
        full_var = torch.sum(masked_var(X.data, X.mask))
        self.explained_variance_ = exp_var
        self.explained_variance_ratio_ = exp_var / full_var
        self.singular_values_ = s
        self.n_features_in_ = d
        if isinstance(X_in, ShardedRows):
            return ShardedRows(data=transformed, mask=X.mask, n_samples=n)
        return transformed[:n]

    def transform(self, X):
        import scipy.sparse

        if scipy.sparse.issparse(X):
            # a sparse projection on the host: only the n×k result is dense
            return np.asarray(X @ self.components_.detach().cpu().numpy().T)
        x, _ = _masked_or_plain(X)
        with fp32_matmul():
            return _like_input(X, x @ self.components_.T)

    def inverse_transform(self, X):
        x, _ = _masked_or_plain(X)
        with fp32_matmul():
            return _like_input(X, x @ self.components_)

    def fit_streamed(self, blocks, n_features=None):
        """Fit from a re-iterable stream of sparse or dense row blocks
        without building the dense corpus.

        ``blocks`` is a zero-argument callable returning a fresh iterator
        of ``(b, n_features)`` blocks (scipy.sparse or ndarray).  The
        randomized range finder runs ``n_iter`` passes of AᵀA over the
        stream, each block adding Bᵀ(BQ) on the host in float64; a last
        pass sums the small (AQ)ᵀAQ Gram, whose eigendecomposition gives
        the components, singular values and explained variance.  The
        fitted attributes land on the active device as float32.
        """
        import scipy.sparse

        k = self.n_components
        oversample = 10
        first_iter = None
        if n_features is None:
            # peek one block for the width; pass 0 reuses the iterator
            it = iter(blocks())
            first = next(it, None)
            if first is None:
                raise ValueError("empty block stream")
            n_features = first.shape[1]
            first_iter = itertools.chain([first], it)
        d = int(n_features)
        if not 0 < k < d:
            raise ValueError(f"n_components must be in (0, n_features={d}); got {k}")
        ell = min(k + oversample, d)
        rng = check_random_state(self.random_state)
        Q = rng.normal(size=(d, ell)).astype(np.float32)

        def _mm(B, C):
            return np.asarray(B @ C, dtype=np.float64)

        n_rows = 0
        col_sum = np.zeros(d, np.float64)
        col_sumsq = np.zeros(d, np.float64)
        for p in range(max(int(self.n_iter), 1)):
            H = np.zeros((d, ell), np.float64)
            src = first_iter if (p == 0 and first_iter is not None) else blocks()
            first_iter = None
            for B in src:
                H += np.asarray(B.T @ _mm(B, Q), dtype=np.float64)
                if p == 0:
                    n_rows += B.shape[0]
                    if scipy.sparse.issparse(B):
                        col_sum += np.asarray(B.sum(axis=0), dtype=np.float64).ravel()
                        col_sumsq += np.asarray(B.multiply(B).sum(axis=0),
                                                dtype=np.float64).ravel()
                    else:
                        Bd = np.asarray(B, dtype=np.float64)
                        col_sum += Bd.sum(axis=0)
                        col_sumsq += (Bd * Bd).sum(axis=0)
            # re-orthonormalize between passes
            Q, _ = np.linalg.qr(H)
            Q = Q.astype(np.float32)
        if n_rows < 1:
            raise ValueError("empty block stream")

        M = np.zeros((ell, ell), np.float64)
        w_sum = np.zeros(ell, np.float64)
        for B in blocks():
            W = _mm(B, Q)
            M += W.T @ W
            w_sum += W.sum(axis=0)
        evals, G = np.linalg.eigh(M)  # ascending
        order = np.argsort(evals)[::-1][:k]
        s = np.sqrt(np.maximum(evals[order], 0.0))
        V = (Q @ G[:, order]).T  # (k, d)
        # the dense path's signs: each row's largest-|.| entry positive
        max_abs = np.argmax(np.abs(V), axis=1)
        signs = np.sign(V[np.arange(V.shape[0]), max_abs])
        signs[signs == 0] = 1.0
        V = V * signs[:, None]

        mean_t = (G[:, order].T @ (w_sum / n_rows)) * signs
        exp_var = np.maximum(s ** 2 / n_rows - mean_t ** 2, 0.0)
        full_var = float(np.sum(col_sumsq / n_rows - (col_sum / n_rows) ** 2))
        device = get_device()

        def _put(a):
            return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)

        self.components_ = _put(V)
        self.singular_values_ = _put(s)
        self.explained_variance_ = _put(exp_var)
        self.explained_variance_ratio_ = _put(exp_var / max(full_var, 1e-30))
        self.n_features_in_ = d
        return self
