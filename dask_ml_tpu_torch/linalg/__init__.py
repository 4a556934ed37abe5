"""Tall-skinny linear algebra: TSQR, its SVD, and randomized SVD (the
port of ``dask_ml_tpu/linalg/``)."""

from .randomized import randomized_svd
from .tsqr import HOST_READS, tsqr, tsqr_strategy, tsqr_svd

__all__ = ["HOST_READS", "randomized_svd", "tsqr", "tsqr_strategy", "tsqr_svd"]
