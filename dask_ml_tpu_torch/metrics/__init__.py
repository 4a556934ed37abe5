"""Metrics: the port of ``dask_ml_tpu/metrics/`` for the names it has so
far: the pairwise distances and kernels, ``accuracy_score`` and
``r2_score``."""

from .classification import accuracy_score
from .pairwise import (
    PAIRWISE_KERNEL_FUNCTIONS, euclidean_distances, linear_kernel, pairwise_distances,
    pairwise_distances_argmin_min, polynomial_kernel, rbf_kernel, sigmoid_kernel)
from .regression import r2_score

__all__ = ["PAIRWISE_KERNEL_FUNCTIONS", "accuracy_score", "euclidean_distances",
           "linear_kernel", "pairwise_distances", "pairwise_distances_argmin_min",
           "polynomial_kernel", "r2_score", "rbf_kernel", "sigmoid_kernel"]
