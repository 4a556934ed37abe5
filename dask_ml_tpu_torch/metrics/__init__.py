"""Metrics: the port of ``dask_ml_tpu/metrics/``: the pairwise distances and
kernels, the classification and regression metrics, and the scorers."""

from .classification import (
    accuracy_score, balanced_accuracy_score, confusion_matrix, f1_score, log_loss,
    precision_score, recall_score, roc_auc_score)
from .pairwise import (
    PAIRWISE_KERNEL_FUNCTIONS, euclidean_distances, linear_kernel, pairwise_distances,
    pairwise_distances_argmin_min, polynomial_kernel, rbf_kernel, sigmoid_kernel)
from .regression import (
    explained_variance_score, mean_absolute_error, mean_absolute_percentage_error,
    mean_squared_error, mean_squared_log_error, median_absolute_error, r2_score)
from .scorer import SCORERS, check_scoring, get_scorer, make_scorer

__all__ = ["PAIRWISE_KERNEL_FUNCTIONS", "SCORERS", "accuracy_score", "balanced_accuracy_score",
           "check_scoring", "confusion_matrix", "euclidean_distances",
           "explained_variance_score", "f1_score", "get_scorer", "linear_kernel", "log_loss",
           "make_scorer", "mean_absolute_error", "mean_absolute_percentage_error",
           "mean_squared_error", "mean_squared_log_error", "median_absolute_error",
           "pairwise_distances", "pairwise_distances_argmin_min", "polynomial_kernel",
           "precision_score", "r2_score", "rbf_kernel", "recall_score", "roc_auc_score",
           "sigmoid_kernel"]
