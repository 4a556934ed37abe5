"""Bucket sums: the port of ``dask_ml_tpu/ops/scatter.py``.

Two lowerings accumulate rows into labelled buckets: ``segsum`` is
``index_add_`` and ``onehot`` is a one-hot gemm.  ``auto`` picks
``segsum``; the reference picks ``onehot`` only on a TPU.  Above 1024
segments ``segsum`` is forced whatever was asked: a one-hot with that
many columns is memory-quadratic.
"""

from __future__ import annotations

import torch

from ..metrics.pairwise import fp32_matmul

_ONEHOT_MAX_SEGMENTS = 1024
_STRATEGIES = ("segsum", "onehot")


def scatter_strategy(num_segments: int | None = None,
                     strategy: str = "auto") -> str:
    """Resolve ``strategy`` (``auto``/``segsum``/``onehot``) for a bucket
    count; the large-segment guard binds whatever was asked."""
    if strategy not in ("auto",) + _STRATEGIES:
        raise ValueError(
            f"strategy must be 'auto', 'segsum' or 'onehot', got {strategy!r}"
        )
    if num_segments is not None and num_segments > _ONEHOT_MAX_SEGMENTS:
        return "segsum"
    return "segsum" if strategy == "auto" else strategy


def bucket_sum(values, ids, num_segments: int, *, strategy: str = "auto"):
    """Sum ``values`` ((n,) or (n, d)) into buckets given by ``ids``.

    Pre-weight ``values`` for weighted accumulation.
    """
    if values.ndim not in (1, 2):
        raise ValueError(f"values must be 1-d or 2-d, got ndim={values.ndim}")
    if ids.ndim != 1:
        raise ValueError(f"ids must be 1-d, got ndim={ids.ndim}")
    if values.shape[0] != ids.shape[0]:
        raise ValueError(
            f"values and ids disagree on the row count: values has "
            f"{values.shape[0]} rows, ids has {ids.shape[0]}"
        )
    strategy = scatter_strategy(num_segments, strategy)
    if strategy == "segsum":
        out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
        return out.index_add_(0, ids.to(torch.int64), values)
    onehot = (ids[:, None] == torch.arange(num_segments, device=ids.device))
    with fp32_matmul():
        return onehot.to(values.dtype).T @ values
