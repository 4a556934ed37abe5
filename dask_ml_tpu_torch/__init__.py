"""dask-ml-tpu's port to PyTorch and CUDA.

The JAX package ``dask_ml_tpu`` is the reference; this package mirrors its
module paths and holds its hand-written Hopper kernels under ``csrc/``.
It imports neither JAX nor the reference, nor scikit-learn.  Entry points
run on CUDA unless the caller asks for the CPU (``core.set_device``).
"""

from .cluster import KMeans
from .convert import (
    kmeans_from_reference, linear_regression_from_reference, logistic_regression_from_reference,
    poisson_regression_from_reference)
from .core import get_device, set_device, shard_rows
from .linear_model import LinearRegression, LogisticRegression, PoissonRegression

__all__ = ["KMeans", "LinearRegression", "LogisticRegression", "PoissonRegression",
           "get_device", "kmeans_from_reference", "linear_regression_from_reference",
           "logistic_regression_from_reference", "poisson_regression_from_reference",
           "set_device", "shard_rows"]
