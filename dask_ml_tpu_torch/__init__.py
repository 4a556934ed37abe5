"""dask-ml-tpu's port to PyTorch and CUDA.

The JAX package ``dask_ml_tpu`` is the reference; this package mirrors its
module paths and holds its hand-written Hopper kernels under ``csrc/``.
It imports neither JAX nor the reference, nor scikit-learn.  Entry points
run on CUDA unless the caller asks for the CPU (``core.set_device``).
"""

from .cluster import KMeans, MiniBatchKMeans, SpectralClustering
from .convert import (
    incremental_pca_from_reference, kmeans_from_reference, linear_regression_from_reference,
    logistic_regression_from_reference, pca_from_reference, poisson_regression_from_reference,
    sgd_classifier_from_reference, sgd_regressor_from_reference, truncated_svd_from_reference)
from .core import get_device, set_device, shard_rows
from .decomposition import PCA, IncrementalPCA, TruncatedSVD
from .linalg import randomized_svd, tsqr, tsqr_svd
from .linear_model import (
    LinearRegression, LogisticRegression, PoissonRegression, SGDClassifier, SGDRegressor)
from .compose import Pipeline, make_pipeline
from .model_selection import (
    GridSearchCV, HyperbandSearchCV, IncrementalSearchCV, InverseDecaySearchCV,
    RandomizedSearchCV, SuccessiveHalvingSearchCV, train_test_split)
from .wrappers import Incremental, ParallelPostFit

__all__ = ["GridSearchCV", "HyperbandSearchCV", "Incremental", "IncrementalPCA",
           "IncrementalSearchCV", "InverseDecaySearchCV", "KMeans", "LinearRegression",
           "LogisticRegression", "MiniBatchKMeans", "PCA", "ParallelPostFit", "Pipeline", "PoissonRegression",
           "RandomizedSearchCV", "SGDClassifier", "SGDRegressor", "SpectralClustering",
           "SuccessiveHalvingSearchCV",
           "TruncatedSVD", "get_device", "make_pipeline",
           "incremental_pca_from_reference",
           "kmeans_from_reference", "linear_regression_from_reference",
           "logistic_regression_from_reference", "pca_from_reference",
           "poisson_regression_from_reference", "randomized_svd", "set_device", "shard_rows",
           "sgd_classifier_from_reference", "sgd_regressor_from_reference",
           "train_test_split", "truncated_svd_from_reference", "tsqr", "tsqr_svd"]
