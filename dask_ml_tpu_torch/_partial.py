"""Sequential ``partial_fit`` over row blocks: the port of
``dask_ml_tpu/_partial.py`` (reference: ``dask_ml/_partial.py``).

The model's state stays where it is (the device, for the port's
estimators) and the data streams through it a block at a time.  This is
the serial loop; the reference's prefetch pipeline, whose results are the
same at every depth, is the second slice of [port-stream], as are sharded
datasets.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .core.sharded import ShardedRows, unshard
from .utils import check_chunks, check_random_state

logger = logging.getLogger(__name__)


def _not_ported(what):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP: [port-stream], second slice)")


def _check_depth(prefetch_depth):
    if prefetch_depth not in (None, 0):
        raise _not_ported("prefetch (prefetch_depth > 0)")


def _row_chunks(n: int, chunk_size: int):
    for start in range(0, n, chunk_size):
        yield start, min(start + chunk_size, n)


def _iter_block_pairs(x):
    """An iterator's items as ``(X, y_or_None)``."""
    for item in x:
        if isinstance(item, tuple):
            if len(item) != 2:
                raise ValueError(f"block tuples must be (X, y); got length {len(item)}")
            yield item
        else:
            yield item, None


def _host_rows(a):
    """A ShardedRows' real rows on the host; tensors and arrays as they are
    (a tensor's slices stay on its device)."""
    if isinstance(a, ShardedRows):
        return unshard(a)
    return a if isinstance(a, torch.Tensor) else np.asarray(a)


def _stream(model, blocks, kwargs):
    for bx, by in blocks:
        if by is None:
            model.partial_fit(bx, **kwargs)
        else:
            model.partial_fit(bx, by, **kwargs)
    return model


def fit(model, x, y=None, *, chunk_size: int | None = None, shuffle_blocks=False,
        random_state=None, prefetch_depth: int | None = None, **kwargs):
    """Stream row chunks of (x, y) through ``model.partial_fit`` in order.

    ``shuffle_blocks`` permutes the chunks' visit order with a numpy
    ``RandomState`` (:func:`check_random_state`), as the reference does, so
    both packages visit the same blocks in the same order.  ``chunk_size``
    defaults to ``DEFAULT_STREAM_CHUNK`` (a bucket rung).  ``x`` may be an
    iterator of blocks (each ``X`` or ``(X, y)``): then ``y`` must be None
    and ``shuffle_blocks`` is ignored.  Returns ``model``.
    """
    _check_depth(prefetch_depth)
    if hasattr(x, "iter_blocks"):
        raise _not_ported("a sharded dataset source")
    if hasattr(x, "__next__"):
        if y is not None:
            raise ValueError("with an iterator of blocks, y must ride the stream as "
                             "(X, y) tuples, not be passed separately")
        if shuffle_blocks:
            logger.debug("shuffle_blocks ignored for an iterator source")
        return _stream(model, _iter_block_pairs(x), kwargs)

    xv = _host_rows(x)
    if chunk_size is None:
        from .linear_model._sgd import DEFAULT_STREAM_CHUNK

        chunk_size = DEFAULT_STREAM_CHUNK
    else:
        chunk_size = check_chunks(xv.shape[0], xv.shape[1] if xv.ndim > 1 else None,
                                  chunk_size)
    yv = None
    if y is not None:
        yv = _host_rows(y)
        if yv.shape[0] != xv.shape[0]:
            raise ValueError(f"x and y have different lengths: {xv.shape[0]} vs {yv.shape[0]}")
    spans = list(_row_chunks(xv.shape[0], chunk_size))
    if shuffle_blocks:
        check_random_state(random_state).shuffle(spans)
    blocks = ((xv[lo:hi], None if yv is None else yv[lo:hi]) for lo, hi in spans)
    return _stream(model, blocks, kwargs)


def _to_host(out):
    return out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def stage_predict_block(xb, policy):
    """Bucket-pad ONE host predict block: ``(block, n_real)`` with the real
    row count to slice back, or ``(block, None)`` where the pad must not
    touch it (device input, not 2-D, already bucket-sized).  Row-wise
    inference makes the pad exact."""
    from .programs import pad_block

    if isinstance(xb, (ShardedRows, torch.Tensor)):
        return xb, None
    xa = np.asarray(xb)
    if xa.ndim != 2:
        return xb, None
    padded, _, _ = pad_block(xa, policy=policy)
    return padded, (None if padded is xa else xa.shape[0])


def predict(model, x, *, chunk_size: int = 100_000, prefetch_depth: int | None = None):
    """Chunked predict (reference ``_partial.predict``).  ``x`` may be an
    iterator of blocks.  The port's estimators get the bucket policy on the
    way in: ragged blocks are padded and their predictions sliced back."""
    from .base import TorchEstimator
    from .programs import resolve_policy

    _check_depth(prefetch_depth)
    if hasattr(x, "iter_blocks"):
        raise _not_ported("a sharded dataset source")
    if hasattr(x, "__next__"):
        blocks = x
    else:
        xv = _host_rows(x)
        blocks = (xv[lo:hi] for lo, hi in _row_chunks(xv.shape[0], chunk_size))
    policy = resolve_policy()
    bucketed = policy.kind != "off" and isinstance(model, TorchEstimator)
    outs = []
    for xb in blocks:
        xb, n = stage_predict_block(xb, policy) if bucketed else (xb, None)
        p = _to_host(model.predict(xb))
        outs.append(p if n is None else p[:n])
    return np.concatenate(outs)
