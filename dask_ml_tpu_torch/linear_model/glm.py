"""GLM estimators: the port of ``dask_ml_tpu/linear_model/glm.py``.

An sklearn-style facade that maps ``C``/``penalty``/``solver`` onto the
solver library (``lamduh = 1/C``, the reference's convention), adds the
intercept column and exposes ``coef_``/``intercept_``.  The port has the
binary ``LogisticRegression`` by ``admm`` or ``lbfgs``; what it does not
have yet raises ``NotImplementedError`` naming its ROADMAP item
([port-admm]): more than two classes (packed one-vs-rest),
``multi_class='multinomial'``,
``class_weight``, ``fit_checkpoint``, the other solvers, and
``LinearRegression``/``PoissonRegression``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..base import ClassifierMixin, TorchEstimator
from ..core.sharded import ShardedRows, as_sharded
from ..preprocessing.data import _ingest_float
from ..solvers import Logistic, admm, get_regularizer, lbfgs
from ..utils import reweight_rows
from .utils import add_intercept, binary_indicator

_SOLVERS = {"admm": admm, "lbfgs": lbfgs}
_NOT_PORTED_SOLVERS = ("newton", "gradient_descent", "proximal_grad")


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: [port-admm] {what})")


def _ingest_f32(est, X) -> ShardedRows:
    """check_array + shard as float32: integers and float64 are cast, half
    precision raises (the reference's bf16 design path is not ported)."""
    X = _ingest_float(est, X)
    if X.data.dtype in (torch.float16, torch.bfloat16):
        raise _not_ported(f"a {X.data.dtype} design matrix (bf16 X)")
    if X.data.dtype != torch.float32:
        X = ShardedRows(data=X.data.to(torch.float32), mask=X.mask, n_samples=X.n_samples)
    return X


class _GLM(TorchEstimator):
    family: type = None

    def __init__(self, penalty="l2", dual=False, tol=1e-4, C=1.0,
                 fit_intercept=True, intercept_scaling=1.0, class_weight=None,
                 random_state=None, solver="admm", max_iter=100,
                 multi_class="ovr", verbose=0, warm_start=False, n_jobs=1,
                 solver_kwargs=None, fit_checkpoint=None):
        self.penalty = penalty
        self.dual = dual
        self.tol = tol
        self.C = C
        self.fit_intercept = fit_intercept
        self.intercept_scaling = intercept_scaling
        self.class_weight = class_weight
        self.random_state = random_state
        self.solver = solver
        self.max_iter = max_iter
        self.multi_class = multi_class
        self.verbose = verbose
        self.warm_start = warm_start
        self.n_jobs = n_jobs
        self.solver_kwargs = solver_kwargs
        self.fit_checkpoint = fit_checkpoint

    def _solver_call_kwargs(self):
        """Solver kwargs: ``lamduh = 1/C``, and ``tol`` is ADMM's
        ``abstol`` and the other solvers' ``tol``."""
        if self.solver in _NOT_PORTED_SOLVERS:
            raise _not_ported(f"solver={self.solver!r}")
        if self.solver not in _SOLVERS:
            raise ValueError(
                f"Unknown solver {self.solver!r}; valid: "
                f"{sorted(_SOLVERS) + sorted(_NOT_PORTED_SOLVERS)}"
            )
        kwargs = dict(
            regularizer=get_regularizer(self.penalty),
            lamduh=1.0 / self.C,
            max_iter=self.max_iter,
            **(self.solver_kwargs or {}),
        )
        if self.solver == "admm":
            kwargs["abstol"] = self.tol
        else:
            kwargs["tol"] = self.tol
        return kwargs

    def _solve(self, X: ShardedRows, y, family=None, beta0=None):
        return _SOLVERS[self.solver](
            X, y, return_n_iter=True, family=family or self.family, beta0=beta0,
            **self._solver_call_kwargs())

    @staticmethod
    def _warm_ok(prev, shape, *, classes_match=True):
        """Previous betas are reusable only for the same problem geometry
        (matching classes and parameter shape); else the solve cold-starts."""
        if prev is None or not classes_match:
            return None
        if tuple(prev.shape) != shape:
            return None
        return prev

    def fit(self, X, y=None, sample_weight=None):
        raise NotImplementedError


class LogisticRegression(ClassifierMixin, _GLM):
    """Binary logistic regression over the solver library.

    ``classes_`` is fitted and ``predict`` returns original labels (strings
    included).  ``fit(..., sample_weight=)`` scales the row mask, so the
    solvers' masked sums become the weighted loss.  ``warm_start=True``
    seeds the solver with the previous fit's coefficients when the classes
    and parameter shape are unchanged (ADMM re-seeds z and every shard's
    β).  Fitted ``coef_`` and ``betas_`` are tensors on the fit's device.
    """

    family = Logistic

    def fit(self, X, y=None, sample_weight=None):
        if self.class_weight is not None:
            raise _not_ported("class_weight")
        if self.fit_checkpoint is not None:
            raise _not_ported("fit_checkpoint")
        if self.multi_class not in ("ovr", "auto", "multinomial"):
            raise ValueError(
                f"multi_class must be 'ovr', 'auto' or 'multinomial'; got "
                f"{self.multi_class!r}"
            )
        self._solver_call_kwargs()  # validates the solver before any work
        prev_betas = getattr(self, "betas_", None) if self.warm_start else None
        prev_classes = getattr(self, "classes_", None) if self.warm_start else None

        y = as_sharded(y)
        if isinstance(y, ShardedRows):
            # only the label values reach the host; pad rows take the first
            # real label so that padding cannot mint a class
            yd = torch.where(y.mask > 0, y.data, y.data[0])
            classes = torch.unique(yd).cpu().numpy()
            yv = None
        else:
            yv = np.asarray(y)
            classes = np.unique(yv)
        if len(classes) < 2:
            raise ValueError(
                "LogisticRegression needs samples of at least 2 classes; "
                f"got {classes.tolist()}"
            )
        if len(classes) > 2:
            raise _not_ported(
                f"{len(classes)} classes (packed one-vs-rest and multinomial)")
        if self.multi_class == "multinomial":
            raise _not_ported("multinomial")
        self.classes_ = classes
        X = _ingest_f32(self, X)
        self.n_features_in_ = X.data.shape[1]
        Xi = add_intercept(X) if self.fit_intercept else X
        Xi = reweight_rows(Xi, sample_weight=sample_weight)

        warm = self._warm_ok(
            prev_betas, (1, Xi.data.shape[1]),
            classes_match=(prev_classes is not None
                           and np.array_equal(np.asarray(prev_classes), classes)))
        y01 = binary_indicator(yv if yv is not None else y, classes[1])
        beta, n_it = self._solve(Xi, y01, beta0=None if warm is None else warm[0])
        self.betas_ = beta[None, :]
        self.n_iter_ = np.asarray([n_it], dtype=np.int32)
        if self.fit_intercept:
            self.coef_ = beta[:-1]
            self.intercept_ = float(beta[-1])
        else:
            self.coef_ = beta
            self.intercept_ = 0.0
        return self

    def _etas(self, X):
        """(X, raw margins (padded n, 1))."""
        X = _ingest_f32(self, X)
        betas = self.betas_.to(X.data.device)
        if self.fit_intercept:
            eta = X.data @ betas[:, :-1].T + betas[:, -1]
        else:
            eta = X.data @ betas.T
        return X, eta

    def decision_function(self, X):
        X, eta = self._etas(X)
        return eta[: X.n_samples, 0]

    def predict(self, X):
        idx = (self.decision_function(X) > 0).cpu().numpy().astype(np.intp)
        return self.classes_[idx]

    def predict_proba(self, X):
        p1 = Logistic.predict(self.decision_function(X))
        return torch.stack([1.0 - p1, p1], dim=1)

    def predict_log_proba(self, X):
        """Log class probabilities as ``log_sigmoid(±eta)`` (stable)."""
        eta = self.decision_function(X)
        return torch.stack([torch.nn.functional.logsigmoid(-eta),
                            torch.nn.functional.logsigmoid(eta)], dim=1)

    def score(self, X, y, sample_weight=None):
        """Mean accuracy, weighted by ``sample_weight`` where given.  A
        tensor ``y`` (with numeric classes) is scored on its device, one
        scalar fetch; other labels are compared on the host."""
        X, y = as_sharded(X), as_sharded(y)
        if isinstance(y, ShardedRows) and np.issubdtype(self.classes_.dtype, np.number):
            Xi, eta = self._etas(X)
            yd = y.data.to(eta.device)
            c0, c1 = (torch.as_tensor(c, dtype=yd.dtype, device=yd.device)
                      for c in self.classes_)
            hit = torch.where(eta[:, 0] > 0, yd == c1, yd == c0).to(torch.float64)
            w = reweight_rows(Xi, sample_weight=sample_weight).mask.to(torch.float64)
            return float(torch.sum(hit * w) / torch.sum(w))
        yv = y.unpad().cpu().numpy() if isinstance(y, ShardedRows) else np.asarray(y)
        hits = self.predict(X) == yv
        if sample_weight is None:
            return float(hits.mean())
        return float(np.average(hits, weights=np.asarray(sample_weight)))


class LinearRegression(_GLM):
    """Not ported yet: ``fit`` raises."""

    def fit(self, X, y=None, sample_weight=None):
        raise _not_ported("LinearRegression")


class PoissonRegression(_GLM):
    """Not ported yet: ``fit`` raises."""

    def fit(self, X, y=None, sample_weight=None):
        raise _not_ported("PoissonRegression")
