"""The squared-distance functions of ``dask_ml_tpu/metrics/pairwise.py``,
as plain PyTorch."""

from __future__ import annotations

import contextlib

import torch


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
