"""GLM estimators: the port of ``dask_ml_tpu/linear_model/glm.py``.

An sklearn-style facade that maps ``C``/``penalty``/``solver`` onto the
solver library (``lamduh = 1/C``, the reference's convention), adds the
intercept column and exposes ``coef_``/``intercept_``: ``LogisticRegression``
(binary, packed one-vs-rest, multinomial, with ``sample_weight`` and
``class_weight``), ``LinearRegression`` and ``PoissonRegression``, by
``admm``, ``lbfgs``, ``gradient_descent``, ``proximal_grad`` or
``newton``.  A bfloat16 X stays bf16 through the binary-family fits (the
reference's mixed precision: float32 parameters); what the port does not
have yet raises ``NotImplementedError`` naming its ROADMAP item
([port-admm]): ``fit_checkpoint`` and bf16 X for multi-class fits.
``_sweep_fit_binary`` and ``_sweep_fit_values`` fit a grid search's values
of ``C`` as the lanes of one ``lambda_sweep``.
"""

from __future__ import annotations

import inspect

import numpy as np
import torch

from ..base import ClassifierMixin, RegressorMixin, TorchEstimator
from ..core.sharded import ShardedRows, as_sharded, unshard
from ..metrics.pairwise import fp32_matmul
from ..preprocessing.data import _ingest_float
from ..solvers import (
    Logistic, Normal, Poisson, admm, check_lambda_sweep, get_regularizer, gradient_descent,
    lambda_sweep, lbfgs, multinomial, newton, packed_solve, proximal_grad)
from ..utils import host_class_weight_rows, reweight_rows
from .utils import add_intercept, binary_indicator

# the keyword arguments ``lambda_sweep`` takes besides its data and λs
_SWEEP_KWARGS = frozenset(inspect.signature(lambda_sweep).parameters) - {
    "solver", "X", "y", "lams", "family"}

_SOLVERS = {
    "admm": admm,
    "lbfgs": lbfgs,
    "newton": newton,
    "gradient_descent": gradient_descent,
    "proximal_grad": proximal_grad,
}


def _not_ported(what):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: [port-admm] {what})")


def _ingest_x(est, X) -> ShardedRows:
    """check_array + shard: a float32 or bfloat16 design stays as it is
    (bf16 is the reference's mixed precision); integers, float64 and
    float16 become float32 (K2 reads float32 or bf16)."""
    X = _ingest_float(est, X)
    if X.data.dtype not in (torch.float32, torch.bfloat16):
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
        if self.solver not in _SOLVERS:
            raise ValueError(f"Unknown solver {self.solver!r}; valid: {sorted(_SOLVERS)}")
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

    def _sweep_args(self, Cs):
        """The solver's kwargs for a sweep over ``Cs`` (λ = 1/C a lane,
        ``lamduh`` left out) and the λs, after ``lambda_sweep``'s argument
        checks: a ``ValueError`` here is raised before any data is read
        or any kernel launched.  ``solver_kwargs`` that ``lambda_sweep``
        does not take (``adaptive_rho``, say) are refused here too."""
        kwargs = self._solver_call_kwargs()
        kwargs.pop("lamduh")
        unknown = sorted(set(kwargs) - _SWEEP_KWARGS)
        if unknown:
            raise ValueError(f"lambda_sweep takes no {unknown}")
        lams = [1.0 / float(c) for c in Cs]
        check_lambda_sweep(self.solver, lams, family=self.family,
                           regularizer=kwargs["regularizer"])
        return kwargs, lams

    def _sweep_fit_values(self, X, y, Cs):
        """``len(Cs)`` fits of the identity-link family that differ only in
        ``C``, as the lanes of one ``lambda_sweep`` (reference:
        ``glm.py :: _sweep_fit_values``); the grid search's packed path
        calls it, and checks eligibility itself.  Returns betas (K, p)."""
        kwargs, lams = self._sweep_args(Cs)
        X = _ingest_x(self, X)
        Xi = add_intercept(X) if self.fit_intercept else X
        betas, _ = lambda_sweep(self.solver, Xi, y, lams, family=self.family, **kwargs)
        return betas

    @staticmethod
    def _warm_ok(prev, shape, *, was_multinomial=False, want_multinomial=False,
                 classes_match=True):
        """Previous betas are reusable only for the same problem geometry
        (matching classes, parameter shape and multinomial-ness); else the
        solve cold-starts."""
        if prev is None or not classes_match:
            return None
        if was_multinomial != want_multinomial:
            return None
        if tuple(prev.shape) != shape:
            return None
        return prev

    def fit(self, X, y=None, sample_weight=None):
        """One solve of ``self.family`` (the regressors' fit): the intercept
        column, ``sample_weight`` folded into the mask, and a warm start
        from the previous fit where its parameter shape matches."""
        if self.fit_checkpoint is not None:
            raise _not_ported("fit_checkpoint")
        kwargs = self._solver_call_kwargs()  # validates the solver before any work
        X = _ingest_x(self, X)
        self.n_features_in_ = X.data.shape[1]
        Xi = add_intercept(X) if self.fit_intercept else X
        Xi = reweight_rows(Xi, sample_weight=sample_weight)
        warm = None
        if self.warm_start:
            warm = self._warm_ok(getattr(self, "betas_", None), (1, Xi.data.shape[1]))
        beta, n_it = _SOLVERS[self.solver](
            Xi, y, return_n_iter=True, family=self.family,
            beta0=None if warm is None else warm[0], **kwargs)
        self.n_iter_ = np.asarray([n_it], dtype=np.int32)
        if self.fit_intercept:
            self.coef_ = beta[:-1]
            self.intercept_ = float(beta[-1])
        else:
            self.coef_ = beta
            self.intercept_ = 0.0
        self.betas_ = beta[None, :]
        return self

    def _eta(self, X):
        """(X, the linear predictor over its padded rows); a bf16 X is
        widened to float32 for the product."""
        X = _ingest_x(self, X)
        coef = self.coef_.to(X.data.device)
        with fp32_matmul():
            eta = X.data.to(coef.dtype) @ coef + self.intercept_
        return X, eta


class LogisticRegression(ClassifierMixin, _GLM):
    """Binary and multi-class logistic regression over the solver library.

    Multi-class is one-vs-rest (``multi_class='ovr'``): the K class solves
    run as the lanes of one packed solve (``solvers.packed_solve``), or a
    true softmax fit with ``multi_class='multinomial'``.  ``classes_`` is
    fitted and ``predict`` returns original labels (strings included).
    ``class_weight`` (dict or ``'balanced'``) and ``fit(...,
    sample_weight=)`` scale the row mask, so the solvers' masked sums
    become the weighted loss.  ``warm_start=True`` seeds the solver with
    the previous fit's coefficients when the classes, parameter shape and
    multinomial-ness are unchanged (ADMM re-seeds z and every shard's β).
    Fitted ``coef_`` and ``betas_`` are tensors on the fit's device.
    """

    family = Logistic
    _multinomial = False  # a fitted softmax model (K > 2)

    def _sweep_fit_binary(self, X, y, Cs, classes):
        """``len(Cs)`` binary fits that differ only in ``C``, as the lanes
        of one ``lambda_sweep`` over one 0/1 target (reference: ``glm.py ::
        _sweep_fit_binary``), 1 where y is ``classes[1]``.  The classes and
        eligibility (binary labels, no weights, one-vs-rest) are the
        caller's: the grid search finds both with one read of the fold's
        labels.  Returns betas (K, p)."""
        kwargs, lams = self._sweep_args(Cs)
        X = _ingest_x(self, X)
        Xi = add_intercept(X) if self.fit_intercept else X
        betas, _ = lambda_sweep(self.solver, Xi, binary_indicator(as_sharded(y), classes[1]),
                                lams, family=self.family, **kwargs)
        return betas

    def fit(self, X, y=None, sample_weight=None):
        if self.fit_checkpoint is not None:
            raise _not_ported("fit_checkpoint")
        if self.multi_class not in ("ovr", "auto", "multinomial"):
            raise ValueError(
                f"multi_class must be 'ovr', 'auto' or 'multinomial'; got "
                f"{self.multi_class!r}"
            )
        kwargs = self._solver_call_kwargs()  # validates the solver before any work
        prev_betas = getattr(self, "betas_", None) if self.warm_start else None
        prev_classes = getattr(self, "classes_", None) if self.warm_start else None
        prev_multinomial = self._multinomial

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
        self.classes_ = classes
        X = _ingest_x(self, X)
        self.n_features_in_ = X.data.shape[1]
        Xi = add_intercept(X) if self.fit_intercept else X
        if self.class_weight is not None and yv is not None:
            # host labels may be strings or big ints that a device cast
            # would corrupt: resolve the row weights on the host
            row_w = host_class_weight_rows(self.class_weight, classes, yv)
            if sample_weight is not None:
                row_w = row_w * np.asarray(sample_weight, np.float32)
            Xi = reweight_rows(Xi, sample_weight=row_w)
        else:
            Xi = reweight_rows(Xi, sample_weight=sample_weight, class_weight=self.class_weight,
                               classes=classes, y_padded=None if yv is not None else y.data)

        K, p = len(classes), Xi.data.shape[1]

        def warm(shape, want_multinomial=False):
            return self._warm_ok(
                prev_betas, shape, was_multinomial=prev_multinomial,
                want_multinomial=want_multinomial,
                classes_match=(prev_classes is not None and len(prev_classes) == K
                               and np.array_equal(np.asarray(prev_classes), classes)))

        self._multinomial = False
        if K == 2 and not (self.multi_class == "multinomial" and self.penalty != "l2"):
            # one sigmoid solve; a two-class softmax under L2 is the sigmoid
            # at half the penalty (w = w1 - w0)
            w0 = warm((1, p))
            if self.multi_class == "multinomial":
                kwargs["lamduh"] = kwargs["lamduh"] / 2.0
            beta, n_it = _SOLVERS[self.solver](
                Xi, binary_indicator(yv if yv is not None else y, classes[1]),
                return_n_iter=True, family=self.family, beta0=None if w0 is None else w0[0],
                **kwargs)
            self.betas_ = beta[None, :]
            n_iter = [n_it]
        elif self.multi_class == "multinomial":
            # one softmax solve over a flat (features, K) parameter vector
            if yv is None:
                cls = torch.as_tensor(classes, dtype=yd.dtype, device=yd.device)
                y_idx = ShardedRows(data=torch.searchsorted(cls, yd).to(torch.float32),
                                    mask=y.mask, n_samples=y.n_samples)
            else:
                y_idx = np.searchsorted(classes, yv).astype(np.float32)
            # betas_ holds W (K, p); the flat vector is its (p, K) transpose
            wm = warm((K, p), want_multinomial=True)
            beta_flat, n_it = _SOLVERS[self.solver](
                Xi, y_idx, return_n_iter=True, family=multinomial(K),
                beta0=None if wm is None else wm.T.reshape(-1), **kwargs)
            W = beta_flat.reshape(p, K).T
            if K == 2:
                # non-L2 two-class softmax, collapsed to the sigmoid form
                self.betas_ = (W[1] - W[0])[None, :]
            else:
                self.betas_ = W.contiguous()
                self._multinomial = True
            n_iter = [n_it]
        else:
            # packed one-vs-rest: K solves as the lanes of one
            if yv is None:
                cls = torch.as_tensor(classes, dtype=y.data.dtype, device=y.data.device)
                Y = (y.data[None, :] == cls[:, None]).to(torch.float32)
            else:
                Y = (yv[None, :] == classes[:, None]).astype(np.float32)
            self.betas_, n_iter = packed_solve(self.solver, Xi, Y, family=self.family,
                                               Beta0=warm((K, p)), **kwargs)
        self.n_iter_ = np.asarray(n_iter, dtype=np.int32)
        if self.fit_intercept:
            self.coef_ = self.betas_[0, :-1] if K == 2 else self.betas_[:, :-1]
            icpt = self.betas_[:, -1]
        else:
            self.coef_ = self.betas_[0] if K == 2 else self.betas_
            icpt = torch.zeros(K)
        self.intercept_ = float(icpt[0]) if K == 2 else icpt.cpu().numpy()
        return self

    def _etas(self, X):
        """(X, raw margins (padded n, K or 1))."""
        X = _ingest_x(self, X)
        betas = self.betas_.to(X.data.device)
        x = X.data.to(betas.dtype)  # a bf16 X widened for the product
        if self.fit_intercept:
            eta = x @ betas[:, :-1].T + betas[:, -1]
        else:
            eta = x @ betas.T
        return X, eta

    def _pred_index(self, eta):
        if len(self.classes_) == 2:
            return (eta[:, 0] > 0).to(torch.int64)
        return torch.argmax(eta, dim=1)

    def decision_function(self, X):
        X, eta = self._etas(X)
        eta = eta[: X.n_samples]
        return eta[:, 0] if len(self.classes_) == 2 else eta

    def predict(self, X):
        X, eta = self._etas(X)
        idx = self._pred_index(eta[: X.n_samples]).cpu().numpy()
        return self.classes_[idx]

    def predict_proba(self, X):
        """Binary: the sigmoid; multinomial: the softmax; one-vs-rest: the
        per-class sigmoids, normalised to sum to 1."""
        eta = self.decision_function(X)
        if len(self.classes_) == 2:
            p1 = Logistic.predict(eta)
            return torch.stack([1.0 - p1, p1], dim=1)
        if self._multinomial:
            return torch.softmax(eta, dim=1)
        p = Logistic.predict(eta)
        return p / torch.sum(p, dim=1, keepdim=True)

    def predict_log_proba(self, X):
        """Log class probabilities: ``log_sigmoid(±eta)`` (binary) and
        ``log_softmax`` (multinomial), both stable; one-vs-rest logs its
        normalised sigmoids."""
        eta = self.decision_function(X)
        if len(self.classes_) == 2:
            return torch.stack([torch.nn.functional.logsigmoid(-eta),
                                torch.nn.functional.logsigmoid(eta)], dim=1)
        if self._multinomial:
            return torch.log_softmax(eta, dim=1)
        p = Logistic.predict(eta)
        return torch.log(p / torch.sum(p, dim=1, keepdim=True))

    def score(self, X, y, sample_weight=None):
        """Mean accuracy, weighted by ``sample_weight`` where given.  A
        tensor ``y`` (with numeric classes) is scored on its device, one
        scalar fetch; other labels are compared on the host."""
        X, y = as_sharded(X), as_sharded(y)
        if isinstance(y, ShardedRows) and np.issubdtype(self.classes_.dtype, np.number):
            Xi, eta = self._etas(X)
            yd = y.data.to(eta.device)
            cls = torch.as_tensor(self.classes_, dtype=yd.dtype, device=yd.device)
            hit = (cls[self._pred_index(eta)] == yd).to(torch.float64)
            w = reweight_rows(Xi, sample_weight=sample_weight).mask.to(torch.float64)
            return float(torch.sum(hit * w) / torch.sum(w))
        yv = y.unpad().cpu().numpy() if isinstance(y, ShardedRows) else np.asarray(y)
        hits = self.predict(X) == yv
        if sample_weight is None:
            return float(hits.mean())
        return float(np.average(hits, weights=np.asarray(sample_weight)))


class LinearRegression(RegressorMixin, _GLM):
    """Least squares (the ``Normal`` family) over the solver library;
    ``score`` is R²."""

    family = Normal

    def predict(self, X):
        X, eta = self._eta(X)
        return eta[: X.n_samples]

    def score(self, X, y, sample_weight=None):
        from ..metrics.regression import r2_score

        return r2_score(y, self.predict(X), sample_weight=sample_weight)


class PoissonRegression(RegressorMixin, _GLM):
    """Poisson regression (log link) over the solver library; ``score`` is
    minus the deviance."""

    family = Poisson

    def predict(self, X):
        X, eta = self._eta(X)
        return torch.exp(eta)[: X.n_samples]

    def get_deviance(self, X, y, sample_weight=None):
        """2·Σ w·(y·log(y/μ) − (y − μ)), taken on the host as the
        reference's is (``y·log(y/μ)`` is 0 where y is 0)."""
        mu = unshard(self.predict(X))
        yv = unshard(y) if isinstance(y, (torch.Tensor, ShardedRows)) else np.asarray(y)
        with np.errstate(divide="ignore", invalid="ignore"):
            term = np.where(yv > 0, yv * np.log(yv / mu), 0.0)
        dev = term - (yv - mu)
        if sample_weight is not None:
            dev = dev * np.asarray(sample_weight)
        return 2 * np.sum(dev)

    def score(self, X, y, sample_weight=None):
        return -self.get_deviance(X, y, sample_weight=sample_weight)
