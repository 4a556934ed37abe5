"""Tall-skinny QR (TSQR) and SVD: the port of ``dask_ml_tpu/linalg/tsqr.py``.

The reference runs one ``shard_map`` program over its mesh's row shards.
The port runs on one device and takes the P row shards as the lanes of
one ``(P, m, d)`` view of the padded rows, split contiguously as
``shard_map`` splits them.  Two local factorizations sit behind one
policy, as in the reference:

- ``householder``: a batched reduced QR of every lane, a second QR of the
  stacked ``(P·k, d)`` R factors (k = min(m, d)), each lane's Q corrected
  by its slice of the second Q.  Backward stable at any conditioning.
- ``cholqr2``: CholeskyQR2 (Yamamoto et al. 2015).  The Gram XᵀX summed
  over the rows (in blocks of ``_GRAM_ROWS``, whatever the lanes), a
  Cholesky, Q₁ = X·R₁⁻¹, then a repair Gram and
  Cholesky.  A guard (both factors finite, ‖G₂−I‖_F < 1/8) accepts the
  result or falls back to ``householder``.  ``torch.linalg.cholesky``
  raises where ``jnp.linalg.cholesky`` returns NaNs, so the port uses
  ``cholesky_ex`` and counts a nonzero ``info`` as a non-finite factor.
  The guard is read on the host, once a factorization (``HOST_READS``):
  the reference's ``lax.cond`` takes the same branch on the device.  Both
  branches run on the active device.

Every product runs in float32 with TF32 off (``fp32_matmul``), the
reference's ``Precision.HIGHEST``.  The strategy is
``DASK_ML_TPU_TORCH_TSQR`` = ``householder`` | ``cholqr2`` | ``auto``
(default; ``auto`` is ``cholqr2``, the reference's measured choice).

Zero rows add nothing to R or to the Gram and give zero rows of Q, so
padded rows compose as long as they are zero.
"""

from __future__ import annotations

import os

import torch

from ..core.mesh import get_n_shards
from ..core.sharded import ShardedRows, host_to_device
from ..metrics.pairwise import fp32_matmul

# CholeskyQR2 acceptance: with ‖G₂−I‖ below this, one repair pass restores
# orthogonality to O(eps) (the reference's ``_CHOLQR2_DEV_MAX``).
_CHOLQR2_DEV_MAX = 0.125
_TSQR_ENV = "DASK_ML_TPU_TORCH_TSQR"

# Rows a block of the Gram XᵀX.  cuBLAS sums a product's long side in one
# float32 chain: an unblocked Gram of a 500k-row lane came out 1.8e-4 off
# (relative) and ran on a few thread blocks (chip_smoke.py phase 9 on an
# H100).  Blocks keep each chain short and the card busy; their Grams are
# then summed, as the reference's psum sums the shards'.
_GRAM_ROWS = 4096

#: reads of a device value by the host: one a ``cholqr2`` factorization
#: (its guard), and the decomposition estimators' own (``decomposition``).
HOST_READS = {"reads": 0}


def host_read(x):
    """``x.item()``, counted in ``HOST_READS``."""
    HOST_READS["reads"] += 1
    return x.item()


def tsqr_strategy() -> str:
    """The local factorization, ``DASK_ML_TPU_TORCH_TSQR`` =
    ``householder`` | ``cholqr2`` | ``auto`` (``auto`` is ``cholqr2``;
    reference: ``tsqr.py :: tsqr_strategy``)."""
    v = os.environ.get(_TSQR_ENV, "auto").strip().lower()
    if v not in ("auto", "householder", "cholqr2"):
        raise ValueError(f"{_TSQR_ENV} must be auto|householder|cholqr2, got {v!r}")
    return "cholqr2" if v == "auto" else v


def _local_hh(xs):
    """Householder TSQR over the lanes of ``xs`` (P, m, d): returns the
    lanes' Q (P, m, d) and R (d, d).  A short lane (m < d) gives k = m rows
    of R; only the stacked R must be tall."""
    P, _, d = xs.shape
    q1, r1 = torch.linalg.qr(xs, mode="reduced")  # (P, m, k), (P, k, d)
    k = r1.shape[1]
    q2, r = torch.linalg.qr(r1.reshape(P * k, d), mode="reduced")  # (P·k, d), (d, d)
    return torch.bmm(q1, q2.reshape(P, k, -1)), r


def _inv_upper(a, eye):
    """a⁻¹ for upper-triangular a, by ``solve_triangular`` against the
    identity (the reference's order: R⁻¹ first, then one product)."""
    return torch.linalg.solve_triangular(a, eye, upper=True)


def blocked_gram(x):
    """XᵀX of the 2-D ``x``, summed over blocks of ``_GRAM_ROWS`` rows."""
    n, d = x.shape
    nb = n // _GRAM_ROWS
    tail = x[nb * _GRAM_ROWS:]
    g = tail.T @ tail
    if nb:
        head = x[: nb * _GRAM_ROWS].view(nb, _GRAM_ROWS, d)
        g = torch.bmm(head.mT, head).sum(dim=0) + g
    return g


def _local_cq(xs):
    """CholeskyQR2 over the lanes of ``xs`` (P, m, d) with its guard; the
    Householder route when the guard refuses."""
    d = xs.shape[2]
    eye = torch.eye(d, dtype=xs.dtype, device=xs.device)
    g = blocked_gram(xs.reshape(-1, d))
    l1, info1 = torch.linalg.cholesky_ex(g)
    q1 = xs @ _inv_upper(l1.T, eye)
    g2 = blocked_gram(q1.reshape(-1, d))
    l2, info2 = torch.linalg.cholesky_ex(g2)
    dev = torch.linalg.norm(g2 - eye)
    ok = ((info1 == 0) & (info2 == 0) & torch.isfinite(l1).all()
          & torch.isfinite(l2).all() & (dev < _CHOLQR2_DEV_MAX))
    if not host_read(ok):
        return _local_hh(xs)
    return q1 @ _inv_upper(l2.T, eye), l2.T @ l1.T  # R = R₂·R₁


def _as_rows(x):
    """(2-D tensor, true shape) of a ShardedRows, tensor or host array."""
    if isinstance(x, ShardedRows):
        return x.data, x.shape
    if not isinstance(x, torch.Tensor):
        x = host_to_device(x)
    return x, tuple(x.shape)


def tsqr(x, strategy=None):
    """Reduced QR of a tall-skinny matrix: X = Q R.

    ``x`` is a ShardedRows (Q comes back with its padded rows, as the
    reference's row-sharded Q), a tensor or a host array (Q has its rows).
    Its rows are split into the active logical shard count
    (``core.get_n_shards``) of contiguous lanes, zero-padded to a multiple
    of it.  R is (d, d).  ``strategy`` (``householder`` | ``cholqr2`` |
    ``auto``) defaults to :func:`tsqr_strategy`.
    """
    data, true_shape = _as_rows(x)
    if true_shape[0] < true_shape[1]:
        # lanes may be short; the whole matrix must be tall-skinny
        raise ValueError(
            f"tsqr requires a tall-skinny matrix: got shape {true_shape} "
            "(rows < cols); use randomized_svd instead"
        )
    if strategy in (None, "auto"):
        strategy = tsqr_strategy()
    elif strategy not in ("householder", "cholqr2"):
        raise ValueError(f"strategy must be householder|cholqr2|auto, got {strategy!r}")
    P = get_n_shards()
    n, d = data.shape
    pad = (-n) % P
    if pad:
        data = torch.cat([data, data.new_zeros(pad, d)])
    local = _local_cq if strategy == "cholqr2" else _local_hh
    with fp32_matmul():
        q, r = local(data.reshape(P, -1, d))
    return q.reshape(-1, q.shape[-1])[:n], r


def tsqr_svd(x):
    """SVD of a tall-skinny matrix through TSQR: X = Q R, R = U_r S Vᵀ, so
    U = Q U_r (reference: ``tsqr.py :: tsqr_svd``)."""
    q, r = tsqr(x)
    u_r, s, vt = torch.linalg.svd(r, full_matrices=False)
    with fp32_matmul():
        return q @ u_r, s, vt
