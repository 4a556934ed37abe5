"""Model selection: the port of ``dask_ml_tpu/model_selection/`` (the
adaptive searches, their packed cohorts, the splitters)."""

from ._hyperband import HyperbandSearchCV
from ._incremental import BaseIncrementalSearchCV, IncrementalSearchCV, InverseDecaySearchCV
from ._split import KFold, ShuffleSplit, train_test_split
from ._successive_halving import SuccessiveHalvingSearchCV

__all__ = ["BaseIncrementalSearchCV", "HyperbandSearchCV", "IncrementalSearchCV",
           "InverseDecaySearchCV", "KFold", "ShuffleSplit", "SuccessiveHalvingSearchCV",
           "train_test_split"]
