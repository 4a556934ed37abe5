"""IncrementalPCA, PCA over row batches: the port of
``dask_ml_tpu/decomposition/incremental_pca.py``.

The model state (components, singular values, running mean and variance,
the running sample count) stays on the device; each batch is one
rank-update (:func:`_update_fn`) with no host read.  The reference's
prefetch pipeline (``stream_partial_fit``) is a plain loop over the
batches here until ``pipeline/`` is ported (ROADMAP [port-stream]), and
``fit_checkpoint`` raises until [port-planes].
"""

from __future__ import annotations

import torch

from ..base import ComponentsOutMixin, TorchEstimator, TransformerMixin
from ..core.mesh import get_device
from ..core.sharded import ShardedRows, host_to_device
from ..linalg.tsqr import blocked_gram, host_read
from ..metrics.pairwise import fp32_matmul
from ..preprocessing.data import _like_input, _masked_or_plain
from ..utils import check_array, svd_flip
from .pca import model_covariance, model_precision


def _update_fn(components, singular_values, mean, var, n_seen, batch, *, k):
    """One incremental rank-update (Ross et al. 2008, as in scikit-learn):
    the Chan merge of mean and variance, the SVD of
    [σ·V; centred batch; correction row] (S and Vt, through its float64
    Gram), ``svd_flip``, and the derived attributes, all on the device.  ``n_seen`` is an int64 device scalar;
    the weights are computed in the batch's dtype, as in the reference.

    Returns (components, singular values, mean, var, n_seen, explained
    variance, its ratio, noise variance)."""
    n_batch, d = batch.shape
    n_total = n_seen + n_batch
    ns = n_seen.to(batch.dtype)
    nb = torch.tensor(float(n_batch), dtype=batch.dtype, device=batch.device)
    nt = ns + nb
    batch_mean = torch.mean(batch, dim=0)
    batch_var = torch.var(batch, dim=0, correction=0)

    new_mean = (ns * mean + nb * batch_mean) / nt
    new_var = (ns * var + nb * batch_var + (ns * nb / nt) * (mean - batch_mean) ** 2) / nt

    correction = torch.sqrt((ns * nb) / nt) * (mean - batch_mean)
    stacked = torch.cat([singular_values[:, None] * components, batch - batch_mean,
                         correction[None, :]])
    # S and Vt of the tall stacked matrix from its Gram, formed and
    # diagonalised in float64, where the float32 products are exact: on an
    # H100 (torch 2.11, CUDA 12.8) cuSOLVER's SVD of the (262155, 64)
    # stacked matrix failed to converge, and its QR of it returned a
    # non-finite R on some calls (chip_smoke.py phase 9).  The reference's
    # own streamed TruncatedSVD takes the same Gram-and-eigh route.
    w, v = torch.linalg.eigh(blocked_gram(stacked.double()))  # ascending
    s = torch.sqrt(torch.clamp_min(w.flip(0), 0.0)).to(batch.dtype)
    vt = v.flip(1).T.to(batch.dtype)
    _, vt = svd_flip(vt.T, vt, u_based_decision=False)  # signs from Vt alone
    sv = s[:k]
    explained = sv ** 2 / (nt - 1.0)
    total_var = torch.sum(new_var) * nt / (nt - 1.0)
    ratio = explained / total_var
    # the mean of the discarded eigenvalues; 0 when every component is kept
    min_nd = torch.minimum(nt, torch.tensor(float(d), dtype=nt.dtype, device=nt.device))
    noise = torch.where(k < min_nd,
                        (total_var - torch.sum(explained)) / torch.clamp_min(min_nd - k, 1.0),
                        torch.zeros_like(total_var))
    return vt[:k], sv, new_mean, new_var, n_total, explained, ratio, noise


class IncrementalPCA(ComponentsOutMixin, TransformerMixin, TorchEstimator):
    """PCA fitted batch by batch (``partial_fit``, or ``fit`` over row spans
    of ``batch_size``, default 5·d)."""

    def __init__(self, n_components=None, whiten=False, copy=True,
                 batch_size=None, fit_checkpoint=None):
        self.n_components = n_components
        self.whiten = whiten
        self.copy = copy
        self.batch_size = batch_size
        self.fit_checkpoint = fit_checkpoint

    def _init_state(self, d, k, dtype, device):
        self.components_ = torch.zeros((k, d), dtype=dtype, device=device)
        self.singular_values_ = torch.zeros((k,), dtype=dtype, device=device)
        self._mean_sh_ = torch.zeros((d,), dtype=dtype, device=device)
        self.var_ = torch.zeros((d,), dtype=dtype, device=device)
        self._n_seen_ = torch.zeros((), dtype=torch.int64, device=device)

    # The running count lives on the device (``_n_seen_``): the update
    # reads and writes it without a host read a batch.  ``n_samples_seen_``
    # reads it when someone asks.
    @property
    def n_samples_seen_(self):
        ns = getattr(self, "_n_seen_", None)
        return 0 if ns is None else int(host_read(ns))

    @n_samples_seen_.setter
    def n_samples_seen_(self, value):
        device = value.device if isinstance(value, torch.Tensor) else get_device()
        self._n_seen_ = torch.as_tensor(value, dtype=torch.int64, device=device).clone()

    @staticmethod
    def _batch(X, check_input):
        if check_input:
            X = check_array(X)
        if isinstance(X, ShardedRows):
            x = X.unpad()
        elif isinstance(X, torch.Tensor):
            x = X
        else:
            x = host_to_device(X)
        return x if x.is_floating_point() else x.to(torch.float32)

    def partial_fit(self, X, y=None, check_input=True):
        """One rank-update on the batch ``X``."""
        x = self._batch(X, check_input)
        d = x.shape[1]
        k = self.n_components or min(x.shape[0], d)
        if not hasattr(self, "components_"):
            self._init_state(d, k, x.dtype, x.device)
            self.n_components_ = k
            # the anchor shift: all moments and the SVD work on x − anchor,
            # at the data's spread scale and not its offset scale; the
            # first row is a valid data value for every feature
            self._anchor_ = x[0].clone()
        if x.shape[0] < self.n_components_:
            raise ValueError(f"batch of {x.shape[0]} rows < n_components={self.n_components_}")
        if getattr(self, "_anchor_", None) is None:
            # state carried over without an anchor: continue at raw scale
            self._anchor_ = torch.zeros((d,), dtype=x.dtype, device=x.device)
            self._mean_sh_ = self.mean_.clone()
        with fp32_matmul():
            (self.components_, self.singular_values_, self._mean_sh_, self.var_,
             self._n_seen_, self.explained_variance_, self.explained_variance_ratio_,
             self.noise_variance_) = _update_fn(
                self.components_, self.singular_values_, self._mean_sh_, self.var_,
                self._n_seen_, x - self._anchor_, k=self.n_components_)
        # the reported attribute is the true mean
        self.mean_ = self._anchor_ + self._mean_sh_
        self.n_features_in_ = d
        return self

    def fit(self, X, y=None):
        """Stream X through ``partial_fit`` in row spans of ``batch_size``
        (default 5·d); a last span shorter than the rank is dropped, as
        scikit-learn's ``gen_batches`` walk does."""
        if self.fit_checkpoint is not None:
            raise NotImplementedError(
                "IncrementalPCA(fit_checkpoint=...) is not ported yet "
                "(ROADMAP: [port-planes])")
        if hasattr(self, "components_"):
            del self.components_  # refit from scratch
        x = self._batch(X, check_input=True)
        n, d = x.shape
        batch = self.batch_size or 5 * d
        k = self.n_components or min(batch, n, d)
        for start in range(0, n, batch):
            stop = min(start + batch, n)
            if stop - start < k:
                break
            self.partial_fit(x[start:stop], check_input=False)
        return self

    def transform(self, X):
        x, _ = _masked_or_plain(X)
        with fp32_matmul():
            if getattr(self, "_anchor_", None) is not None:
                # (x − anchor) is exact in the offset regime; the spread-scale
                # mean then subtracts without cancellation
                out = ((x - self._anchor_) - self._mean_sh_) @ self.components_.T
            else:
                out = (x - self.mean_) @ self.components_.T
        if self.whiten:
            out = out / torch.sqrt(self.explained_variance_)
        return _like_input(X, out)

    def inverse_transform(self, X):
        x, _ = _masked_or_plain(X)
        if self.whiten:
            x = x * torch.sqrt(self.explained_variance_)
        with fp32_matmul():
            if getattr(self, "_anchor_", None) is not None:
                return _like_input(X, (x @ self.components_ + self._mean_sh_) + self._anchor_)
            return _like_input(X, x @ self.components_ + self.mean_)

    def get_covariance(self):
        """Model covariance, :meth:`PCA.get_covariance`'s formula.  Like the
        reference, ``noise_variance_`` is the running residual (total
        variance minus the kept, over the discarded dimensions), not
        scikit-learn's last-update estimate."""
        return model_covariance(self)

    def get_precision(self):
        """Inverse model covariance, :meth:`PCA.get_precision`'s lemma."""
        return model_precision(self)
