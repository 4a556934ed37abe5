"""The port of ``dask_ml_tpu/linear_model/utils.py`` (reference:
``dask_ml/linear_model/utils.py :: add_intercept``)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.sharded import ShardedRows


def binary_indicator(y, positive_class):
    """0/1 float32 target for ``y == positive_class``, built where y lives:
    a ShardedRows on its device (the mask keeps pad rows inert), anything
    else on the host as numpy."""
    if isinstance(y, ShardedRows):
        return ShardedRows(
            data=(y.data == torch.as_tensor(positive_class, dtype=y.data.dtype,
                                            device=y.data.device)).to(torch.float32),
            mask=y.mask, n_samples=y.n_samples,
        )
    return (np.asarray(y) == positive_class).astype(np.float32)


def add_intercept(X: ShardedRows) -> ShardedRows:
    """Append a ones column (zeroed on padded rows so solvers stay exact)."""
    ones = X.mask[:, None].to(X.data.dtype)
    return ShardedRows(
        data=torch.cat([X.data, ones], dim=1),
        mask=X.mask,
        n_samples=X.n_samples,
    )
