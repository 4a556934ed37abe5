"""The ingest helper of ``dask_ml_tpu/preprocessing/data.py``."""

from __future__ import annotations

import torch

from ..core.sharded import ShardedRows
from ..utils import check_array


def _ingest_float(est, X) -> ShardedRows:
    """check_array + shard, casting integer input to float32."""
    X = check_array(X)
    if not isinstance(X, ShardedRows):
        X = est._ingest(X)
    if not X.data.is_floating_point():
        X = ShardedRows(data=X.data.to(torch.float32), mask=X.mask,
                        n_samples=X.n_samples)
    return X
