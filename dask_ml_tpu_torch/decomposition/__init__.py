"""Decomposition: the port of ``dask_ml_tpu/decomposition/``."""

from .incremental_pca import IncrementalPCA
from .pca import PCA
from .truncated_svd import TruncatedSVD

__all__ = ["IncrementalPCA", "PCA", "TruncatedSVD"]
