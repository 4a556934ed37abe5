"""dask-ml-tpu's port to PyTorch and CUDA.

The JAX package ``dask_ml_tpu`` is the reference; this package mirrors its
module paths and holds its hand-written Hopper kernels under ``csrc/``.
It imports neither JAX nor the reference, nor scikit-learn, and pandas
only where a DataFrame is handed in.  Entry points run on CUDA unless the
caller asks for the CPU (``core.set_device``).

Ported: KMeans, MiniBatchKMeans and SpectralClustering; LogisticRegression,
LinearRegression, PoissonRegression, SGDClassifier and SGDRegressor; PCA,
TruncatedSVD and IncrementalPCA; the preprocessing estimators (the scalers,
QuantileTransformer, Normalizer, PolynomialFeatures, the encoders and
BlockTransformer); SimpleImputer and GaussianNB; BlockwiseVotingClassifier
and BlockwiseVotingRegressor; the metrics and scorers; Pipeline, the
searches, Incremental and ParallelPostFit; and the ``*_from_reference``
converters.
"""

from .cluster import KMeans, MiniBatchKMeans, SpectralClustering
from .convert import (
    blockwise_from_reference, gaussian_nb_from_reference, incremental_pca_from_reference, kmeans_from_reference,
    linear_regression_from_reference, logistic_regression_from_reference,
    max_abs_scaler_from_reference, min_max_scaler_from_reference, pca_from_reference,
    poisson_regression_from_reference, quantile_transformer_from_reference,
    robust_scaler_from_reference, sgd_classifier_from_reference, sgd_regressor_from_reference,
    simple_imputer_from_reference, standard_scaler_from_reference, truncated_svd_from_reference)
from .core import get_device, set_device, shard_rows
from .decomposition import PCA, IncrementalPCA, TruncatedSVD
from .ensemble import BlockwiseVotingClassifier, BlockwiseVotingRegressor
from .impute import SimpleImputer
from .linalg import randomized_svd, tsqr, tsqr_svd
from .linear_model import (
    LinearRegression, LogisticRegression, PoissonRegression, SGDClassifier, SGDRegressor)
from .compose import Pipeline, make_pipeline
from .naive_bayes import GaussianNB
from .preprocessing import (
    BlockTransformer, Categorizer, DummyEncoder, LabelEncoder, MaxAbsScaler, MinMaxScaler,
    Normalizer, OneHotEncoder, OrdinalEncoder, PolynomialFeatures, QuantileTransformer,
    RobustScaler, StandardScaler)
from .model_selection import (
    GridSearchCV, HyperbandSearchCV, IncrementalSearchCV, InverseDecaySearchCV,
    RandomizedSearchCV, SuccessiveHalvingSearchCV, train_test_split)
from .wrappers import Incremental, ParallelPostFit

__all__ = ["BlockTransformer", "BlockwiseVotingClassifier", "BlockwiseVotingRegressor",
           "Categorizer", "DummyEncoder", "GaussianNB", "GridSearchCV", "HyperbandSearchCV", "Incremental", "IncrementalPCA",
           "IncrementalSearchCV", "InverseDecaySearchCV", "KMeans", "LabelEncoder",
           "LinearRegression", "LogisticRegression", "MaxAbsScaler", "MinMaxScaler",
           "MiniBatchKMeans", "Normalizer", "OneHotEncoder", "OrdinalEncoder", "PCA",
           "ParallelPostFit", "Pipeline", "PoissonRegression", "PolynomialFeatures",
           "QuantileTransformer", "RandomizedSearchCV", "RobustScaler", "SGDClassifier",
           "SGDRegressor", "SimpleImputer", "SpectralClustering", "StandardScaler",
           "SuccessiveHalvingSearchCV",
           "TruncatedSVD", "blockwise_from_reference", "get_device", "make_pipeline",
           "gaussian_nb_from_reference", "incremental_pca_from_reference",
           "kmeans_from_reference", "linear_regression_from_reference",
           "logistic_regression_from_reference", "max_abs_scaler_from_reference",
           "min_max_scaler_from_reference", "pca_from_reference",
           "poisson_regression_from_reference", "quantile_transformer_from_reference",
           "randomized_svd", "robust_scaler_from_reference", "set_device", "shard_rows",
           "sgd_classifier_from_reference", "sgd_regressor_from_reference",
           "simple_imputer_from_reference", "standard_scaler_from_reference",
           "train_test_split", "truncated_svd_from_reference", "tsqr", "tsqr_svd"]
