"""The helpers of ``dask_ml_tpu/utils.py`` that the KMeans path calls,
re-done for torch tensors."""

from __future__ import annotations

import contextlib
import logging
import time

import numpy as np
import torch

from .core.sharded import ShardedRows

logger = logging.getLogger(__name__)


def check_array(array):
    """Validate 2-D numeric input like the reference's ``check_array``.

    Accepts numpy arrays, torch tensors, pandas objects and
    :class:`ShardedRows`.  A tensor is returned as it is, on its own
    device (no host transfer); other input comes back as numpy.
    """
    if isinstance(array, ShardedRows):
        if array.data.ndim != 2:
            raise ValueError(f"Expected 2D input, got ndim={array.data.ndim}")
        if array.n_samples == 0:
            raise ValueError("Found array with 0 samples")
        return array
    if hasattr(array, "to_numpy"):  # pandas
        array = array.to_numpy()
    if isinstance(array, torch.Tensor):
        numeric = array.dtype != torch.bool and not array.is_complex()
    else:
        array = np.asarray(array)
        numeric = np.issubdtype(array.dtype, np.number)
    if not numeric:
        raise ValueError(f"Expected numeric dtype, got {array.dtype}")
    if array.ndim != 2:
        raise ValueError(
            f"Expected 2D array, got ndim={array.ndim}. "
            "Reshape your data with .reshape(-1, 1) for a single feature."
        )
    if array.shape[0] == 0:
        raise ValueError("Found array with 0 samples")
    return array


def safe_denominator(x):
    """0-safe divisor that preserves fractional weight masses: the mask
    doubles as the per-row weight, so sub-unit masses are legitimate and
    ``maximum(x, 1)`` would shrink their means."""
    return torch.where(x > 0, x, torch.ones_like(x))


def effective_mask(mask, *, sample_weight=None, n_samples=None):
    """Fold per-row ``sample_weight`` into a validity mask (pad rows stay
    at 0).  The reference's ``class_weight`` branch is not on this path."""
    if sample_weight is None:
        return mask
    if isinstance(sample_weight, torch.Tensor):
        sw = sample_weight.detach().reshape(-1).to(mask.device, torch.float32)
    else:
        sw = torch.from_numpy(
            np.asarray(sample_weight, np.float32).ravel()).to(mask.device)
    n = int(n_samples) if n_samples is not None else sw.shape[0]
    if sw.shape[0] != n:
        raise ValueError(f"sample_weight has {sw.shape[0]} entries for {n} samples")
    pad = mask.shape[0] - sw.shape[0]
    if pad < 0:
        raise ValueError(
            f"sample_weight longer ({sw.shape[0]}) than padded rows "
            f"({mask.shape[0]})"
        )
    if pad:
        sw = torch.cat([sw, sw.new_zeros(pad)])
    return mask * sw


def reweight_rows(X: ShardedRows, *, sample_weight=None) -> ShardedRows:
    """``X`` with ``sample_weight`` folded into its mask; the same object
    when there are no weights."""
    if sample_weight is None:
        return X
    return ShardedRows(
        data=X.data,
        mask=effective_mask(X.mask, sample_weight=sample_weight,
                            n_samples=X.n_samples),
        n_samples=X.n_samples,
    )


@contextlib.contextmanager
def _timer(name: str, _logger=None, level=logging.INFO):
    """Log phase durations (reference: ``utils.py :: _timer``)."""
    _logger = _logger or logger
    start = time.perf_counter()
    _logger.log(level, "Starting %s", name)
    try:
        yield
    finally:
        _logger.log(level, "Finished %s in %.4fs", name,
                    time.perf_counter() - start)
