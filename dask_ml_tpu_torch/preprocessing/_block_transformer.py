"""BlockTransformer: the port of
``dask_ml_tpu/preprocessing/_block_transformer.py``.

The user's function is applied to the rows as one tensor on their device
(the padded rows of a ``ShardedRows``), so it must be row-local, as the
reference's per-block function must.
"""

from __future__ import annotations

import torch

from ..base import TorchEstimator, TransformerMixin
from ..core.sharded import ShardedRows, host_to_device


class BlockTransformer(TransformerMixin, TorchEstimator):
    """``func`` gets a torch tensor (the reference's gets a JAX array)."""

    def __init__(self, func, *, validate=False, **kw_args):
        self.func = func
        self.validate = validate
        self.kw_args = kw_args

    def fit(self, X, y=None):
        return self

    def transform(self, X, y=None):
        kwargs = self.kw_args or {}
        if self.validate:
            from ..utils import check_array

            X = check_array(X)
        if isinstance(X, ShardedRows):
            out = self.func(X.data, **kwargs)
            if out.shape[0] != X.data.shape[0]:
                raise ValueError("BlockTransformer func must preserve row count")
            return ShardedRows(data=out, mask=X.mask, n_samples=X.n_samples)
        x = X if isinstance(X, torch.Tensor) else host_to_device(X)
        return self.func(x, **kwargs)
