"""Solver library: the port of ``dask_ml_tpu/solvers`` (the twin of
``dask_glm``), for binary logistic regression by consensus ADMM and
L-BFGS.  The P local L-BFGS solves of an ADMM round run as the lanes of
one batched loop whose objective is K2 (``ops/logistic.py``)."""

from .algorithms import DISPATCH_COUNTS, admm, lbfgs, reset_dispatch_counts  # noqa: F401
from .families import Logistic  # noqa: F401
from .lbfgs_core import HOST_SYNCS, lbfgs_minimize  # noqa: F401
from .regularizers import L1, L2, ElasticNet, get_regularizer  # noqa: F401

__all__ = [
    "Logistic",
    "L1",
    "L2",
    "ElasticNet",
    "get_regularizer",
    "admm",
    "lbfgs",
    "DISPATCH_COUNTS",
    "HOST_SYNCS",
    "reset_dispatch_counts",
    "lbfgs_minimize",
]
