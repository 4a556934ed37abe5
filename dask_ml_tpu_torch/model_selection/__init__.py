"""Model selection: the port of ``dask_ml_tpu/model_selection/`` (the
cross-validated grid and randomized searches, the adaptive searches and
their packed cohorts, the splitters)."""

from ._hyperband import HyperbandSearchCV
from ._incremental import BaseIncrementalSearchCV, IncrementalSearchCV, InverseDecaySearchCV
from ._search import GridSearchCV, RandomizedSearchCV
from ._split import KFold, ShuffleSplit, StratifiedKFold, check_cv, train_test_split
from ._successive_halving import SuccessiveHalvingSearchCV

__all__ = ["BaseIncrementalSearchCV", "GridSearchCV", "HyperbandSearchCV",
           "IncrementalSearchCV", "InverseDecaySearchCV", "KFold", "RandomizedSearchCV",
           "ShuffleSplit", "StratifiedKFold", "SuccessiveHalvingSearchCV", "check_cv",
           "train_test_split"]
