"""Synthetic data born on the device: the port of
``dask_ml_tpu/datasets.py :: stream_classification_blocks``."""

from __future__ import annotations

import torch

from .core.mesh import get_device
from .core.sharded import ShardedRows


def stream_classification_blocks(n_blocks, block_rows, n_features, *, seed=0, coef=None,
                                 device=None):
    """Yield ``n_blocks`` synthetic classification blocks ``(X, y)``, each
    made on ``device`` (default: the active one) when it is asked for, as
    :class:`ShardedRows` with full masks: X standard normal ``(block_rows,
    n_features)`` float32, y = [sigmoid(X·w) > U] as 0.0/1.0 float32, with
    w standard normal (or ``coef``) and U uniform.  A block is dropped once
    the consumer lets it go, so the stream can exceed device memory while
    one block is live.  ``block_rows`` should be a bucket rung so that
    ``partial_fit`` pads nothing.

    The draws come from one ``torch.Generator`` seeded with ``seed``: the
    same seed gives the same blocks, but not the reference's
    ``jax.random`` numbers.
    """
    device = torch.device(device) if device is not None else get_device()
    gen = torch.Generator(device=device).manual_seed(int(seed))
    if coef is None:
        w = torch.randn(n_features, generator=gen, device=device)
    else:
        w = torch.as_tensor(coef, dtype=torch.float32).to(device)
    mask = torch.ones(block_rows, dtype=torch.float32, device=device)
    for _ in range(n_blocks):
        X = torch.randn(block_rows, n_features, generator=gen, device=device)
        u = torch.rand(block_rows, generator=gen, device=device)
        y = (torch.sigmoid(X @ w) > u).to(torch.float32)
        yield (ShardedRows(data=X, mask=mask, n_samples=block_rows),
               ShardedRows(data=y, mask=mask, n_samples=block_rows))
