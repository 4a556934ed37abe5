"""Pairwise distances and kernels: the port of
``dask_ml_tpu/metrics/pairwise.py`` (reference: ``dask_ml/metrics/pairwise.py``).

X may be a padded ``ShardedRows``; Y (centres, a sample) is usually a
plain tensor, and a call is one tile over all of X's rows.  The
distances that consumers read as values (``euclidean_distances``,
``rbf_kernel``) go through K10 (``ops/pairwise.py :: sq_euclidean_safe``),
which centres both operands on one anchor and recomputes near-duplicate
entries exactly; argmin consumers (KMeans, ``pairwise_distances_argmin_min``)
take the plain expansion, K1b's arithmetic.

When both operands are sharded the reference runs a ppermute ring over the
mesh.  On one device the ring is a loop over Y's shards: each step fills
the column block of its shard for every row of X, and a self tile (X
against itself) gets its global offsets so that the diagonal is pinned to
0.  An NCCL ring waits for [port-multi].
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.mesh import get_n_shards
from ..core.sharded import ShardedRows, host_to_device

__all__ = ["PAIRWISE_KERNEL_FUNCTIONS", "euclidean_distances", "linear_kernel",
           "pairwise_distances", "pairwise_distances_argmin_min", "polynomial_kernel",
           "rbf_kernel", "ring_pairwise", "sigmoid_kernel"]


@contextlib.contextmanager
def fp32_matmul():
    """Run float32 products in full float32: no TF32 on the card, as the
    reference's ``Precision.HIGHEST`` gemms."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _data_of(x):
    """(padded data, true row count).  Padded rows are sliced off results at
    the public API boundary; a host array goes to the active device."""
    if isinstance(x, ShardedRows):
        return x.data, x.n_samples
    if not isinstance(x, torch.Tensor):
        x = host_to_device(np.asarray(x))
    return x, x.shape[0]


def _both_sharded(X, Y):
    return isinstance(X, ShardedRows) and isinstance(Y, ShardedRows)


def _f32(x):
    """Contiguous float32, as K10 takes it."""
    return x.to(torch.float32).contiguous()


def ring_pairwise(X: ShardedRows, Y: ShardedRows, fn):
    """Apply a pairwise tile ``fn(x, y) -> (nx, ny)`` with both operands
    sharded: a loop over Y's row blocks (the active logical shard count),
    each filling its column block for all of X's rows.  A tile with
    ``takes_offsets`` is called ``fn(x, y, row0, col0)`` with its global
    offsets; one with ``writes_into`` is called with ``out=`` its column
    block and fills it.  Returns the (n, m) result sliced to real rows and
    columns (Y's pad rows trail in global order)."""
    P = get_n_shards()
    x, y = X.data, Y.data
    if y.shape[0] % P:
        raise ValueError(f"Y's {y.shape[0]} padded rows do not split into {P} shards")
    m_l = y.shape[0] // P
    out = None
    for b in range(P):
        col = b * m_l
        args = (x, y[col:col + m_l]) + ((0, col) if getattr(fn, "takes_offsets", False) else ())
        if getattr(fn, "writes_into", False):
            if out is None:
                out = torch.empty((x.shape[0], y.shape[0]), dtype=torch.float32,
                                  device=x.device)
            fn(*args, out=out[:, col:col + m_l])
        else:
            tile = fn(*args)
            if out is None:
                out = tile.new_empty((x.shape[0], y.shape[0]))
            out[:, col:col + m_l] = tile
    return out[: X.n_samples, : Y.n_samples]


def _sq_euclidean(x, y):
    """max(‖x‖²+‖y‖²−2x·y, 0) for every row pair, in float32."""
    x_norm = torch.sum(x * x, dim=1, keepdim=True)
    y_norm = torch.sum(y * y, dim=1, keepdim=True).T
    with fp32_matmul():
        xy = x @ y.T
    return torch.clamp_min(x_norm + y_norm - 2.0 * xy, 0.0)


def _sq_euclidean_hi(x, y):
    """Distances for argmin consumers (KMeans assignment).  The
    reference's ``HIGHEST`` precision is the port's only precision."""
    return _sq_euclidean(x, y)


def _sq_euclidean_safe(x, y, row0=0, col0=0, self_pairs=False, kind="sq", gamma=None,
                       out=None):
    """Cancellation-guarded distances for value consumers, through K10
    (``ops/pairwise.py``); ``kind`` picks d², √d² or exp(−γd²)."""
    from ..ops.pairwise import sq_euclidean_safe

    return sq_euclidean_safe(_f32(x), _f32(y), row0, col0, self_pairs, kind, gamma, out)


class _SafeTile:
    """A ring tile through K10 for X against another Y: d², √d² or
    exp(−γd²) (``post``), written into its column block."""

    writes_into = True

    def __init__(self, post, **params):
        self.post = post  # 'sq' | 'euclid' | 'rbf'
        self.params = params

    def __call__(self, x, y, out=None):
        return _sq_euclidean_safe(x, y, kind=self.post, out=out, **self.params)


class _SelfTile(_SafeTile):
    """The ring tile for X against itself (``takes_offsets``): global
    offsets pin the exact self-pairs on the diagonal to 0 and keep them out
    of the exact recompute."""

    takes_offsets = True

    def __call__(self, x, y, row0, col0, out=None):
        return _sq_euclidean_safe(x, y, row0, col0, self_pairs=True, kind=self.post, out=out,
                                  **self.params)


class _BoundTile:
    """A tile function with its scalars bound, for the ring."""

    def __init__(self, fn, **params):
        self.fn = fn
        self.params = params

    def __call__(self, x, y):
        return self.fn(x, y, **self.params)


def _manhattan_tile(x, y):
    """L1 distances: |x−y| has no gemm form, so a row-chunked broadcast
    whose (rows, m, d) cube stays near 64 MB, as the reference's."""
    from ..ops.pairwise import _CUBE

    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    out = x.new_zeros((n, m))
    chunk = max(_CUBE // max(m * d, 1), 1)
    for s in range(0, n, chunk):
        out[s:s + chunk] = torch.sum(torch.abs(x[s:s + chunk, None, :] - y[None, :, :]), dim=-1)
    return out


def _cosine_tile(x, y):
    xn = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=1, keepdim=True), 1e-30)
    yn = y / torch.clamp_min(torch.linalg.vector_norm(y, dim=1, keepdim=True), 1e-30)
    with fp32_matmul():
        return 1.0 - xn @ yn.T


def _operands(X, Y):
    x, n = _data_of(X)
    y, m = (x, n) if Y is None else _data_of(Y)
    return x, n, y, m


def euclidean_distances(X, Y=None, squared: bool = False):
    """‖x−y‖ (or its square) for every row pair (reference
    ``euclidean_distances``).  Sharded×sharded inputs go through the ring;
    ``Y=None`` (or ``Y is X`` on the ring) is a self call with an exact
    zero diagonal."""
    post = "sq" if squared else "euclid"
    if Y is not None and _both_sharded(X, Y):
        return ring_pairwise(X, Y, _SelfTile(post) if Y is X else _SafeTile(post))
    x, n, y, m = _operands(X, Y)
    return _sq_euclidean_safe(x, y, self_pairs=Y is None, kind=post)[:n, :m]


def pairwise_distances(X, Y=None, metric="euclidean", **kwargs):
    """Distances by ``metric``: ``euclidean``, ``sqeuclidean``, ``cosine``,
    ``manhattan``/``cityblock``/``l1``, or a callable run once on the whole
    (padded) operands and sliced."""
    if callable(metric):
        x, n, y, m = _operands(X, Y)
        return metric(x, y, **kwargs)[:n, :m]
    if metric == "euclidean":
        return euclidean_distances(X, Y)
    if metric == "sqeuclidean":
        return euclidean_distances(X, Y, squared=True)
    tiles = {"cosine": _cosine_tile, "manhattan": _manhattan_tile,
             "cityblock": _manhattan_tile, "l1": _manhattan_tile}
    if metric not in tiles:
        raise ValueError(f"Unsupported metric: {metric!r}")
    if Y is not None and _both_sharded(X, Y):
        return ring_pairwise(X, Y, tiles[metric])
    x, n, y, m = _operands(X, Y)
    return tiles[metric](x, y)[:n, :m]


def pairwise_distances_argmin_min(X, Y):
    """(index of the nearest Y row, its distance) for every X row, through
    K1b (``ops/lloyd.py :: lloyd_assign``): √max(min d², 0), as the
    reference's ``_argmin_min``.  Indices are int64."""
    from ..ops.lloyd import lloyd_assign

    x, n = _data_of(X)
    x = _f32(x)
    if x.data_ptr() % 16:  # K1b reads x 16 bytes at a time
        x = x.clone()
    y, _ = _data_of(Y)
    ones = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    idx, min_d2, _ = lloyd_assign(x, ones, _f32(y.to(x.device)))
    return idx[:n], torch.sqrt(torch.clamp_min(min_d2, 0.0))[:n]


def _linear_tile(x, y):
    with fp32_matmul():
        return x @ y.T


def linear_kernel(X, Y=None):
    if Y is not None and _both_sharded(X, Y):
        return ring_pairwise(X, Y, _linear_tile)
    x, n, y, m = _operands(X, Y)
    return _linear_tile(x, y)[:n, :m]


def _poly_tile(x, y, gamma, coef0, degree):
    return (gamma * _linear_tile(x, y) + coef0) ** degree


def _default_gamma(x, gamma):
    return 1.0 / x.shape[1] if gamma is None else gamma


def polynomial_kernel(X, Y=None, degree: int = 3, gamma=None, coef0: float = 1.0):
    if Y is not None and _both_sharded(X, Y):
        return ring_pairwise(X, Y, _BoundTile(
            _poly_tile, gamma=float(_default_gamma(X.data, gamma)), coef0=float(coef0),
            degree=int(degree)))
    x, n, y, m = _operands(X, Y)
    return _poly_tile(x, y, _default_gamma(x, gamma), coef0, degree)[:n, :m]


def rbf_kernel(X, Y=None, gamma=None):
    """exp(−γ‖x−y‖²), γ = 1/d by default, through K10's ``rbf`` epilogue."""
    if Y is not None and _both_sharded(X, Y):
        g = float(_default_gamma(X.data, gamma))
        return ring_pairwise(X, Y, _SelfTile("rbf", gamma=g) if Y is X
                             else _SafeTile("rbf", gamma=g))
    x, n, y, m = _operands(X, Y)
    g = float(_default_gamma(x, gamma))
    return _sq_euclidean_safe(x, y, self_pairs=Y is None, kind="rbf", gamma=g)[:n, :m]


def sigmoid_kernel(X, Y=None, gamma=None, coef0: float = 1.0):
    x, n, y, m = _operands(X, Y)
    return torch.tanh(_default_gamma(x, gamma) * _linear_tile(x, y) + coef0)[:n, :m]


PAIRWISE_KERNEL_FUNCTIONS = {
    "linear": linear_kernel,
    "polynomial": polynomial_kernel,
    "rbf": rbf_kernel,
    "sigmoid": sigmoid_kernel,
}
