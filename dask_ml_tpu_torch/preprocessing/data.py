"""The ingest and transform-output helpers of
``dask_ml_tpu/preprocessing/data.py``."""

from __future__ import annotations

import torch

from ..core.sharded import ShardedRows, host_to_device
from ..utils import check_array


def _as_float(x):
    return x if x.is_floating_point() else x.to(torch.float32)


def _masked_or_plain(X):
    """(data, mask) for either a ShardedRows or a plain array.  A tensor
    stays on its own device; host input goes to the active device, float64
    as float32 (as ``shard_rows`` takes it)."""
    if isinstance(X, ShardedRows):
        return _as_float(X.data), X.mask
    if not isinstance(X, torch.Tensor):
        X = host_to_device(X)
    x = _as_float(X)
    return x, torch.ones(x.shape[0], dtype=torch.float32, device=x.device)


def _ingest_float(est, X) -> ShardedRows:
    """check_array + shard, casting integer input to float32."""
    X = check_array(X)
    if not isinstance(X, ShardedRows):
        X = est._ingest(X)
    if not X.data.is_floating_point():
        X = ShardedRows(data=X.data.to(torch.float32), mask=X.mask,
                        n_samples=X.n_samples)
    return X


def _like_input(X, out):
    """Wrap transform output like the input (sharded in, sharded out)."""
    if isinstance(X, ShardedRows):
        return ShardedRows(data=out, mask=X.mask, n_samples=X.n_samples)
    return out
