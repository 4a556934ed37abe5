"""Preprocessing: the port of ``dask_ml_tpu/preprocessing/``.

Scalers fit by masked reductions over the padded rows on the device, the
quantile sketch through K12; transforms are elementwise tensor ops.
Encoders build their category inventories on the host with numpy and
expand rows on the device; the DataFrame transformers
(``Categorizer``/``DummyEncoder``) stay on the host and need pandas.
"""

from ._block_transformer import BlockTransformer
from ._encoders import OneHotEncoder, OrdinalEncoder
from .categorical import Categorizer, DummyEncoder
from .data import (
    MaxAbsScaler,
    MinMaxScaler,
    Normalizer,
    PolynomialFeatures,
    QuantileTransformer,
    RobustScaler,
    StandardScaler,
)
from .label import LabelEncoder

__all__ = [
    "StandardScaler",
    "MaxAbsScaler",
    "MinMaxScaler",
    "Normalizer",
    "RobustScaler",
    "QuantileTransformer",
    "PolynomialFeatures",
    "LabelEncoder",
    "BlockTransformer",
    "OneHotEncoder",
    "OrdinalEncoder",
    "Categorizer",
    "DummyEncoder",
]
