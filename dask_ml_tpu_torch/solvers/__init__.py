"""Solver library: the port of ``dask_ml_tpu/solvers`` (the twin of
``dask_glm``): the logistic, normal and Poisson families by consensus
ADMM, L-BFGS, gradient descent, proximal gradient and Newton; binary,
packed one-vs-rest and multinomial.  The P local L-BFGS solves of an ADMM
round run as the lanes of one batched loop whose objective is K2
(``ops/logistic.py``), or K2-OvR and K2-MN (``ops/multiclass.py``); a
grid search's C-sweep (``lambda_sweep``) runs its values of λ as lanes
over one shared target through K2-OvR."""

from .algorithms import (  # noqa: F401
    DISPATCH_COUNTS, admm, check_lambda_sweep, grid_pack_strategy, gradient_descent,
    lambda_sweep, lbfgs, newton, pack_strategy, packed_solve, proximal_grad,
    reset_dispatch_counts)
from .families import Logistic, Normal, Poisson, multinomial  # noqa: F401
from .lbfgs_core import HOST_SYNCS, lbfgs_minimize  # noqa: F401
from .regularizers import L1, L2, ElasticNet, get_regularizer  # noqa: F401

__all__ = [
    "Logistic",
    "Normal",
    "Poisson",
    "multinomial",
    "L1",
    "L2",
    "ElasticNet",
    "get_regularizer",
    "admm",
    "gradient_descent",
    "lbfgs",
    "newton",
    "proximal_grad",
    "pack_strategy",
    "packed_solve",
    "grid_pack_strategy",
    "lambda_sweep",
    "check_lambda_sweep",
    "DISPATCH_COUNTS",
    "HOST_SYNCS",
    "reset_dispatch_counts",
    "lbfgs_minimize",
]
