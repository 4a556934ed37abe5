"""Solver library: the port of ``dask_ml_tpu/solvers`` (the twin of
``dask_glm``), for logistic regression by consensus ADMM and L-BFGS:
binary, packed one-vs-rest and multinomial.  The P local L-BFGS solves of
an ADMM round run as the lanes of one batched loop whose objective is K2
(``ops/logistic.py``), or K2-OvR and K2-MN (``ops/multiclass.py``)."""

from .algorithms import (  # noqa: F401
    DISPATCH_COUNTS, admm, lbfgs, pack_strategy, packed_solve, reset_dispatch_counts)
from .families import Logistic, multinomial  # noqa: F401
from .lbfgs_core import HOST_SYNCS, lbfgs_minimize  # noqa: F401
from .regularizers import L1, L2, ElasticNet, get_regularizer  # noqa: F401

__all__ = [
    "Logistic",
    "multinomial",
    "L1",
    "L2",
    "ElasticNet",
    "get_regularizer",
    "admm",
    "lbfgs",
    "pack_strategy",
    "packed_solve",
    "DISPATCH_COUNTS",
    "HOST_SYNCS",
    "reset_dispatch_counts",
    "lbfgs_minimize",
]
