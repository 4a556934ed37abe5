"""Randomized (Halko) SVD: the port of ``dask_ml_tpu/linalg/randomized.py``.

The range finder is a pair of products a power iteration with a TSQR
re-orthonormalization, then B = QᵀX and a small SVD.  The random sketch
``g`` is drawn from a ``torch.Generator`` (``core.prng.as_generator``),
which gives other numbers than ``jax.random`` from the same seed; so the
computation from a given sketch, ``_randomized_svd_from_sketch``, is held
to the reference's on the reference's own sketch, and the public function
by the quality of what it returns.

Every product runs in float32 with TF32 off (``fp32_matmul``).  The
reference writes ``x @ g``, ``x.T @ q`` and ``q.T @ x`` at default
precision, which on a TPU runs as bf16 passes; the port does not copy
that.
"""

from __future__ import annotations

import torch

from ..core.prng import as_generator
from ..core.sharded import ShardedRows
from ..metrics.pairwise import fp32_matmul
from .tsqr import tsqr


def _randomized_svd_from_sketch(x, g, n_components: int, n_iter: int):
    """The Halko SVD of the 2-D tensor ``x`` from the sketch ``g`` (d, k):
    (U, S, Vt) of rank ``n_components``."""
    with fp32_matmul():
        q, _ = tsqr(x @ g)
        for _ in range(n_iter):
            z = x.T @ q  # (d, k)
            q, _ = tsqr(x @ z)
        b = q.T @ x  # (k, d)
        u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
        u = q @ u_b
    return u[:, :n_components], s[:n_components], vt[:n_components]


def randomized_svd(x, n_components: int, *, n_oversamples: int = 10, n_iter: int = 4,
                   random_state=None):
    """Approximate truncated SVD of a ShardedRows or 2-D tensor: (U, S, Vt)
    of rank ``n_components``, U with ``x``'s padded rows.  ``n_iter`` power
    iterations sharpen a slowly decaying spectrum (the reference's
    ``power_iteration_normalizer='QR'``)."""
    true_n = x.shape[0]
    if isinstance(x, ShardedRows):
        x = x.data
    d = x.shape[1]
    if n_components > min(true_n, d):
        raise ValueError(f"n_components={n_components} must be <= min{(true_n, d)}")
    # the sketch's width is clamped so that TSQR's rows >= columns holds
    k = min(n_components + n_oversamples, d, true_n)
    gen = as_generator(random_state, device=x.device)
    g = torch.randn((d, k), generator=gen, dtype=x.dtype, device=x.device)
    return _randomized_svd_from_sketch(x, g, n_components, n_iter)
