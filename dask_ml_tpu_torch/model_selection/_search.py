"""Cross-validated searches: the port of
``dask_ml_tpu/model_selection/_search.py`` (``GridSearchCV``,
``RandomizedSearchCV``).

Candidate × fold fits run through the estimators; a pipeline's prefix
steps whose (step, parameters, fold) repeat across candidates are fitted
and applied once (``_OnceCache``: compute once under threads, evicted when
the last task that needs an entry is done).  Fold slices of ``ShardedRows``
input are gathered once a fold and shared between its candidates, fold by
fold.  A grid over ``C`` alone of a bare ``LogisticRegression`` or
``LinearRegression`` runs packed where ``grid_pack_strategy()`` says so:
every candidate of a fold is a lane of one ``lambda_sweep``, scored by one
product for all lanes.  Whether a fold may run packed is decided by
explicit checks before its solve, each counted in ``SWEEP_STATS``; a
``ValueError`` from the solver's argument checks (made before any data is
read) is the one failure that falls back to the per-candidate fits, and
every other error propagates.

``n_jobs`` runs candidate fits on a thread pool only when no step of the
search fits on the device (a ``TorchEstimator``): device fits are
serialized, as the reference serializes its device estimators.  The
splits come from the port's copies of scikit-learn's ``check_cv``,
``StratifiedKFold`` and ``KFold`` (``_split.py``), the candidates from its
``ParameterGrid`` and ``ParameterSampler`` (``_sampling.py``), so that the
port searches the folds and candidates the reference does.
"""

from __future__ import annotations

import logging
import os
import threading
import warnings
from collections import Counter
from concurrent.futures import ThreadPoolExecutor, as_completed

import numpy as np
import torch

from ..base import TorchEstimator, clone, is_classifier
from ..core.mesh import adopt_scope, current_scope, get_device
from ..core.sharded import ShardedRows, as_sharded, shard_rows, unshard
from ..metrics.pairwise import fp32_matmul
from ..metrics.scorer import check_scoring, get_scorer
from ..utils import check_consistent_length, check_random_state
from ._sampling import ParameterGrid, ParameterSampler
from ._split import _take as _rows
from ._split import check_cv

__all__ = ["GridSearchCV", "RandomizedSearchCV", "SWEEP_STATS", "reset_sweep_stats"]

logger = logging.getLogger(__name__)

#: How each fold of the searches ran: ``packed_folds`` through one
#: ``lambda_sweep`` a fold; ``ineligible`` by reason (``estimator``,
#: ``sequential``, ``fit_params``, ``scoring``, ``class_weight``,
#: ``multinomial``, ``grid``, ``dtype``, ``solver_args``, ``no_target``,
#: ``classes``), every fold of a search counted once.
SWEEP_STATS = {"packed_folds": 0, "ineligible": Counter()}


def reset_sweep_stats():
    SWEEP_STATS["packed_folds"] = 0
    SWEEP_STATS["ineligible"] = Counter()


# ------------------------------------------------------ packed scoring --

def _sweep_x(X) -> ShardedRows:
    return X if isinstance(X, ShardedRows) else shard_rows(np.asarray(X, dtype=np.float32))


def _sweep_pad(vec, n_padded, device):
    if isinstance(vec, ShardedRows):
        return vec.data.to(device=device, dtype=torch.float32)
    v = np.asarray(vec, dtype=np.float32)
    return torch.from_numpy(np.pad(v, (0, n_padded - v.shape[0]))).to(device)


def _sweep_eta(data, betas, fit_intercept):
    """(n, K): every lane's linear predictor, one product."""
    betas = betas.to(data.device)
    with fp32_matmul():
        if fit_intercept:
            return data @ betas[:, :-1].T + betas[:, -1]
        return data @ betas.T


def _sweep_accuracy(X, y, betas, classes, fit_intercept) -> np.ndarray:
    """Each lane's accuracy for a (K, p) stack of binary coefficients: one
    ``[n, d]×[d, K]`` product and masked sums for all lanes, then one (K,)
    read.  The labels are encoded against the train fold's classes where
    they lie (strings on the host)."""
    from ..linear_model.utils import binary_indicator

    Xs = _sweep_x(X)
    dev = Xs.data.device
    y01 = _sweep_pad(binary_indicator(y, classes[1]), Xs.data.shape[0], dev)
    eta = _sweep_eta(Xs.data, betas, fit_intercept)
    hit = ((eta > 0).to(torch.float32) == y01[:, None]).to(torch.float32) * Xs.mask[:, None]
    acc = torch.sum(hit, dim=0) / torch.clamp(torch.sum(Xs.mask), min=1.0)
    return acc.cpu().numpy()


def _sweep_r2(X, y, betas, fit_intercept) -> np.ndarray:
    """Each lane's R² for a (K, p) stack of identity-link coefficients, one
    product for all lanes and one (K,) read.  A fold whose y is constant
    (its total sum of squares within 1e-10·Σy² of 0) scores 1.0 where the
    fit is also exact and 0.0 else, as ``r2_score`` does, where the
    clamped division would give a large negative score."""
    Xs = _sweep_x(X)
    dev = Xs.data.device
    yv = _sweep_pad(y, Xs.data.shape[0], dev)
    mask = Xs.mask
    eta = _sweep_eta(Xs.data, betas, fit_intercept)
    ss_res = torch.sum((eta - yv[:, None]) ** 2 * mask[:, None], dim=0)
    tot = torch.clamp(torch.sum(mask), min=1.0)
    mean_y = torch.sum(yv * mask) / tot
    ss_tot = torch.sum((yv - mean_y) ** 2 * mask)
    tol_deg = 1e-10 * torch.sum(yv * yv * mask) + 1e-30
    r2 = 1.0 - ss_res / torch.clamp(ss_tot, min=1e-30)
    degenerate = torch.where(ss_res <= tol_deg, 1.0, 0.0)
    return torch.where(ss_tot > tol_deg, r2, degenerate).cpu().numpy()


def _host(a):
    return unshard(a) if isinstance(a, ShardedRows) else a


def _fold_classes_ok(ytr, yte):
    """A packed fold's labels: its two classes, or None where the fold does
    not pack.  The train fold must be exactly binary, and every test label
    among its two classes.  Sharded labels are checked on their device with
    one read, which also brings back the classes (their least and largest
    valid label are the two classes where every label is one of them)."""
    if isinstance(ytr, ShardedRows):
        yd = torch.where(ytr.mask > 0, ytr.data, ytr.data[0])
        lo, hi = torch.min(yd), torch.max(yd)
        ok = (lo != hi) & torch.all((yd == lo) | (yd == hi))
        if isinstance(yte, ShardedRows):
            yt = yte.data.to(yd.device)
            ok = ok & torch.all((yte.mask.to(yd.device) <= 0) | (yt == lo) | (yt == hi))
        ok, lo, hi = torch.stack([ok.to(yd.dtype), lo, hi]).cpu().numpy()
        if not ok:
            return None
        classes = np.asarray([lo, hi])
        if not isinstance(yte, ShardedRows) and not np.isin(np.asarray(yte), classes).all():
            return None
        return classes
    classes = np.unique(np.asarray(ytr))
    if classes.shape[0] != 2 or not np.isin(np.asarray(_host(yte)), classes).all():
        return None
    return classes


# ------------------------------------------------------- prefix cache --

class _CacheKey:
    """Token for (estimator class, parameters, fold): the key under which
    a pipeline prefix's fit is shared between candidates."""

    @staticmethod
    def make(step, params, fold_idx):
        items = tuple(sorted((k, repr(v)) for k, v in params.items()))
        return (type(step).__name__, items, fold_idx)


class _OnceCache:
    """Compute-once cache with refcount eviction.  The first caller of a
    token computes its value; concurrent callers of the same token wait
    for it.  ``set_expected_uses`` says how many tasks consume each token;
    ``release`` counts one down and drops the entry at zero."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict = {}
        self._uses: dict = {}

    def set_expected_uses(self, counts: dict):
        with self._lock:
            self._uses = dict(counts)

    def get_or_compute(self, token, fn):
        with self._lock:
            entry = self._entries.get(token)
            owner = entry is None
            if owner:
                entry = {"event": threading.Event(), "value": None, "error": None}
                self._entries[token] = entry
        if owner:
            try:
                entry["value"] = fn()
            except BaseException as e:  # the waiters see it too
                entry["error"] = e
                raise
            finally:
                entry["event"].set()
            return entry["value"]
        entry["event"].wait()
        if entry["error"] is not None:
            raise entry["error"]
        return entry["value"]

    def release(self, token):
        """One consumer of ``token`` is done; evict at zero uses."""
        with self._lock:
            if token not in self._uses:
                return
            self._uses[token] -= 1
            if self._uses[token] <= 0:
                self._uses.pop(token)
                self._entries.pop(token, None)

    def __len__(self):
        with self._lock:
            return len(self._entries)


class _CachedPredictor:
    """A proxy that computes ``predict``, ``predict_proba``,
    ``decision_function`` and ``transform`` once for each X, so that
    several scorers of one (estimator, X) pair call each method once."""

    _CACHEABLE = ("predict", "predict_proba", "decision_function", "transform")

    def __init__(self, est):
        self._est = est
        self._memo: dict = {}

    def __getattr__(self, name):
        attr = getattr(self._est, name)
        if name in self._CACHEABLE and callable(attr):
            memo = self._memo

            def cached(X, _name=name, _fn=attr):
                key = (_name, id(X))
                if key not in memo:
                    memo[key] = _fn(X)
                return memo[key]

            return cached
        return attr


def _resolve_n_jobs(n_jobs) -> int:
    if n_jobs is None or n_jobs == 1:
        return 1
    if n_jobs < 0:  # -1: all cores
        return max(1, (os.cpu_count() or 1) + 1 + n_jobs)
    return int(n_jobs)


def _steps(est):
    """A pipeline's (name, step) pairs, recognised by its ``steps``."""
    steps = getattr(est, "steps", None)
    return steps if isinstance(steps, list) else None


def _uses_device_estimator(est) -> bool:
    """Whether fitting ``est`` runs a ``TorchEstimator``, pipeline steps
    included."""
    if isinstance(est, TorchEstimator):
        return True
    steps = _steps(est)
    return steps is not None and any(
        _uses_device_estimator(s) for _, s in steps if s is not None and s != "passthrough")


# ---------------------------------------------------------- the search --

class _BaseSearchCV(TorchEstimator):
    def __init__(self, estimator, scoring=None, cv=None, refit=True, error_score="raise",
                 return_train_score=False, scheduler=None, n_jobs=-1, cache_cv=True):
        self.estimator = estimator
        self.scoring = scoring
        self.cv = cv
        self.refit = refit
        self.error_score = error_score
        self.return_train_score = return_train_score
        self.scheduler = scheduler
        self.n_jobs = n_jobs
        self.cache_cv = cache_cv

    def _get_param_iterator(self):
        raise NotImplementedError

    def _resolve_cv(self, yh=None):
        cv = self.cv
        if cv is None or isinstance(cv, int):
            # an int (or the default) stratifies for classifiers
            return check_cv(cv, yh, classifier=is_classifier(self.estimator))
        return cv

    def _resolve_scorers(self):
        """``scoring`` as an ordered {name: scorer}: one metric (None, a
        name, a callable) under the key ``"score"``; a list, tuple, set or
        dict is the multimetric form, and ``refit`` must then name one of
        the metrics, be a callable or be False."""
        sc = self.scoring
        if sc is None or isinstance(sc, str) or callable(sc):
            return {"score": check_scoring(self.estimator, sc)}, False
        if isinstance(sc, (list, tuple, set)):
            scorers = {name: get_scorer(name) for name in sc}
        elif isinstance(sc, dict):
            scorers = {name: (v if callable(v) else get_scorer(v)) for name, v in sc.items()}
        else:
            raise ValueError(f"Invalid scoring: {sc!r}")
        if self.refit is not False and not callable(self.refit) and self.refit not in scorers:
            raise ValueError(
                "For multimetric scoring, refit must be False, a callable selecting "
                "best_index_ from cv_results_, or the name of the metric used to pick the "
                f"best candidate; got {self.refit!r} with metrics {sorted(scorers)}")
        return scorers, True

    def _device_capable(self):
        """Whether every step that fits or scores is a ``TorchEstimator``,
        so that sharded input stays on its device."""
        steps = _steps(self.estimator)
        if steps is not None:
            return all(isinstance(s, TorchEstimator) for _, s in steps)
        return isinstance(self.estimator, TorchEstimator)

    def _prefix_tokens_for(self, est, fold_idx):
        """The cumulative prefix tokens of one (candidate, fold) task: the
        fit path and the refcount count both take them from here."""
        steps = _steps(est)
        if not (self.cache_cv and steps is not None):
            return []
        toks, acc = [], []
        for _, step in steps[:-1]:
            params = step.get_params() if hasattr(step, "get_params") else {}
            acc.append(_CacheKey.make(step, params, fold_idx))
            toks.append(tuple(acc))
        return toks

    def _splits(self, X, y):
        """(Xh, yh, splits): sharded input stays on its device where every
        step fits there (unshuffled KFold unless y is on the host or the
        splitter is explicit), else everything comes to the host."""
        device_path = isinstance(X, ShardedRows) and self._device_capable()
        if not device_path:
            Xh, yh = _host(X), _host(y) if y is not None else None
            return Xh, yh, list(self._resolve_cv(yh).split(Xh, yh))
        explicit_cv = self.cv is not None and not isinstance(self.cv, int)
        if y is not None and not isinstance(y, ShardedRows):
            y_split = np.asarray(y)  # host labels: stratify at no cost
        elif explicit_cv and y is not None:
            y_split = np.asarray(_host(y))  # a user's splitter may read the labels
        else:
            y_split = None
            if y is not None and is_classifier(self.estimator):
                warnings.warn(
                    "sharded input uses unshuffled KFold (no stratification) — class-sorted "
                    "labels can yield single-class folds; pass an explicit splitter (e.g. "
                    "StratifiedKFold) to stratify at the cost of one 1-D label fetch",
                    UserWarning, stacklevel=3)
        cv = self._resolve_cv(y_split)
        return X, y, list(cv.split(np.empty((X.n_samples, 0)), y_split))

    def fit(self, X, y=None, **fit_params):
        if y is not None:
            check_consistent_length(X, y)
        X, y = as_sharded(X), as_sharded(y)
        Xh, yh, splits = self._splits(X, y)
        candidates = list(self._get_param_iterator())
        if not candidates:
            raise ValueError("No candidate parameters")
        scorers, multimetric = self._resolve_scorers()
        n_cand, n_folds = len(candidates), len(splits)

        # pipeline prefixes: fitted once a (prefix, fold), evicted after
        # their last consumer
        prefix_cache = _OnceCache()
        if self.cache_cv and _steps(self.estimator) is not None:
            use_counts: dict = {}
            for params in candidates:
                est0 = clone(self.estimator).set_params(**params)
                for fi in range(n_folds):
                    for tok in self._prefix_tokens_for(est0, fi):
                        use_counts[tok] = use_counts.get(tok, 0) + 1
            prefix_cache.set_expected_uses(use_counts)

        test_scores = {m: np.zeros((n_cand, n_folds)) for m in scorers}
        train_scores = ({m: np.zeros((n_cand, n_folds)) for m in scorers}
                        if self.return_train_score else None)

        # fold slices gathered once a fold and shared by its candidates,
        # only for sharded input (host slices are fresh a task: a step may
        # write into its input); refcounted, and the tasks run fold-major,
        # so that a fold's slices go before the next fold's are gathered
        fold_lock = threading.Lock()
        fold_cache: dict = {}
        fold_refs = {fi: n_cand for fi in range(n_folds)}
        fold_cacheable = isinstance(Xh, ShardedRows)

        def fold_slices(fi):
            tr, te = splits[fi]
            return (_rows(Xh, tr), _rows(yh, tr) if yh is not None else None,
                    _rows(Xh, te), _rows(yh, te) if yh is not None else None)

        def fold_get(fi):
            if not fold_cacheable:
                return fold_slices(fi)
            with fold_lock:
                if fi not in fold_cache:
                    fold_cache[fi] = fold_slices(fi)
                return fold_cache[fi]

        def fold_release(fi):
            with fold_lock:
                fold_refs[fi] -= 1
                if fold_refs[fi] <= 0:
                    fold_cache.pop(fi, None)

        packed = self._maybe_packed_glm_sweep(Xh, candidates, n_folds, fold_get, fold_release,
                                              scorers, fit_params, test_scores, train_scores)
        if not packed:
            with fold_lock:  # a fold given up half-way spent its references
                fold_cache.clear()
                for fi in fold_refs:
                    fold_refs[fi] = n_cand
        fit_failed = np.zeros(n_cand, dtype=bool)

        def run_task(ci, fi):
            Xtr, ytr, Xte, yte = fold_get(fi)
            est = clone(self.estimator).set_params(**candidates[ci])
            tokens = self._prefix_tokens_for(est, fi)
            try:
                est = self._fit_candidate(est, Xtr, ytr, prefix_cache, tokens, fit_params)
                if len(scorers) > 1:
                    est = _CachedPredictor(est)  # one predict a method for all metrics
                for m, scorer in scorers.items():
                    test_scores[m][ci, fi] = scorer(est, Xte, yte)
                    if self.return_train_score:
                        train_scores[m][ci, fi] = scorer(est, Xtr, ytr)
            except Exception:
                if self.error_score == "raise":
                    raise
                for m in scorers:
                    test_scores[m][ci, fi] = float(self.error_score)
                    if self.return_train_score:
                        train_scores[m][ci, fi] = float(self.error_score)
                fit_failed[ci] = True
            finally:
                for tok in tokens:
                    prefix_cache.release(tok)
                fold_release(fi)

        tasks = [] if packed else [(ci, fi) for fi in range(n_folds) for ci in range(n_cand)]
        n_workers = min(_resolve_n_jobs(self.n_jobs), max(len(tasks), 1))
        if n_workers > 1 and (
                _uses_device_estimator(self.estimator)
                or any(_uses_device_estimator(v) for p in candidates for v in p.values())):
            # device fits already take the whole card: serialize them
            n_workers = 1
        if n_workers <= 1:
            for ci, fi in tasks:
                run_task(ci, fi)
        else:
            scope = current_scope()

            def run_scoped(ci, fi):
                with adopt_scope(scope):
                    run_task(ci, fi)

            with ThreadPoolExecutor(max_workers=n_workers) as pool:
                futures = [pool.submit(run_scoped, ci, fi) for ci, fi in tasks]
                try:
                    for f in as_completed(futures):
                        f.result()
                except BaseException:
                    pool.shutdown(wait=False, cancel_futures=True)
                    raise

        primary = False if callable(self.refit) else (self.refit if multimetric else "score")
        self._build_results(candidates, splits, test_scores, train_scores, primary=primary)
        self.multimetric_ = multimetric
        if callable(self.refit):
            picked = self.refit(self.cv_results_)
            if not isinstance(picked, (int, np.integer)):
                raise TypeError("refit callable must return an integer index, got "
                                f"{type(picked).__name__} ({picked!r})")
            self.best_index_ = int(picked)
            if not 0 <= self.best_index_ < n_cand:
                raise IndexError(f"refit callable returned index {self.best_index_} outside "
                                 f"[0, {n_cand})")
            self.best_params_ = candidates[self.best_index_]
        if self.refit:
            best = clone(self.estimator).set_params(**self.best_params_)
            if yh is not None:
                best.fit(Xh, yh, **fit_params)
            else:
                best.fit(Xh, **fit_params)
            self.best_estimator_ = best
        return self

    def _maybe_packed_glm_sweep(self, Xh, candidates, n_folds, fold_get, fold_release, scorers,
                                fit_params, test_scores, train_scores):
        """Every candidate of a fold as a lane of one ``lambda_sweep``, for
        a grid over ``C`` alone of a bare ``LogisticRegression`` or
        ``LinearRegression`` under ``grid_pack_strategy() == "packed"``,
        scored by one product for all lanes.  Returns True when it filled
        the scores; each fold is counted in ``SWEEP_STATS``."""
        from ..linear_model import LinearRegression, LogisticRegression
        from ..solvers import grid_pack_strategy

        est = self.estimator
        is_clf = type(est) is LogisticRegression
        is_reg = type(est) is LinearRegression
        device = Xh.data.device if isinstance(Xh, ShardedRows) else get_device()
        Cs = [p.get("C") for p in candidates]

        def ineligible(reason):
            SWEEP_STATS["ineligible"][reason] += n_folds
            return False

        if not (is_clf or is_reg):
            return ineligible("estimator")
        if grid_pack_strategy(device) != "packed":
            return ineligible("sequential")
        if fit_params:
            return ineligible("fit_params")
        if self.scoring is not None or set(scorers) != {"score"}:
            return ineligible("scoring")
        if is_clf and est.class_weight is not None:
            return ineligible("class_weight")
        if is_clf and est.multi_class == "multinomial":
            return ineligible("multinomial")
        if not candidates or any(set(p) != {"C"} for p in candidates):
            return ineligible("grid")
        if isinstance(Xh, ShardedRows) and Xh.data.dtype != torch.float32:
            return ineligible("dtype")  # K2-OvR takes float32 only
        sweep_est = clone(est)
        try:
            sweep_est._sweep_args(Cs)  # the solver's argument checks: no data, no launch
        except ValueError:
            logger.info("packed C-sweep refused by the solver's checks; per-candidate fits",
                        exc_info=True)
            return ineligible("solver_args")

        filled_test = np.empty((len(Cs), n_folds))
        filled_train = np.empty_like(filled_test) if self.return_train_score else None
        for fi in range(n_folds):
            Xtr, ytr, Xte, yte = fold_get(fi)
            try:
                if ytr is None or yte is None:
                    return ineligible("no_target")
                if is_clf:
                    # the scorer encodes labels against the train fold's two
                    # classes: a test label outside them must not count as a hit
                    classes = _fold_classes_ok(ytr, yte)
                    if classes is None:
                        return ineligible("classes")
                    betas = sweep_est._sweep_fit_binary(Xtr, ytr, Cs, classes)

                    def score(Xf, yf):
                        return _sweep_accuracy(Xf, yf, betas, classes, est.fit_intercept)
                else:
                    betas = sweep_est._sweep_fit_values(Xtr, ytr, Cs)

                    def score(Xf, yf):
                        return _sweep_r2(Xf, yf, betas, est.fit_intercept)
                filled_test[:, fi] = score(Xte, yte)
                if filled_train is not None:
                    filled_train[:, fi] = score(Xtr, ytr)
            finally:
                for _ in Cs:  # this path spends all of the fold's references
                    fold_release(fi)
        SWEEP_STATS["packed_folds"] += n_folds
        test_scores["score"][:, :] = filled_test
        if train_scores is not None:
            train_scores["score"][:, :] = filled_train
        return True

    def _fit_candidate(self, est, Xtr, ytr, prefix_cache, tokens, fit_params):
        steps = _steps(est)
        if not (self.cache_cv and steps is not None):
            if ytr is not None:
                est.fit(Xtr, ytr, **fit_params)
            else:
                est.fit(Xtr, **fit_params)
            return est

        # walk the steps, taking each fitted prefix step and its output from
        # the cache; a shared host array reaches a step as a copy, since a
        # step may write into its input
        def _host_copy(a):
            return a.copy() if isinstance(a, np.ndarray) else a

        data, fitted_steps, cached_data = Xtr, [], False
        for (name, step), token in zip(steps[:-1], tokens):

            def fit_prefix(step=step, data_in=data, shared=cached_data):
                fitted = clone(step)
                return fitted, fitted.fit_transform(_host_copy(data_in) if shared else data_in,
                                                    ytr)

            fitted_step, data = prefix_cache.get_or_compute(token, fit_prefix)
            fitted_steps.append((name, fitted_step))
            cached_data = True
        final_name, final = steps[-1]
        final = clone(final)
        fit_x = _host_copy(data) if cached_data else data
        if ytr is not None:
            final.fit(fit_x, ytr, **fit_params)
        else:
            final.fit(fit_x, **fit_params)
        fitted_steps.append((final_name, final))
        est.steps = fitted_steps
        return est

    def _build_results(self, candidates, splits, test_scores, train_scores, *, primary):
        """``cv_results_`` from {metric: (n_cand, n_folds)} scores, and the
        best candidate by ``primary`` (False: none).  A NaN mean (a failed
        fit under ``error_score=nan``) ranks last."""
        cv_results = {"params": candidates}
        for metric, scores in test_scores.items():
            mean_test = scores.mean(axis=1)
            std_test = scores.std(axis=1)
            mean_ranked = np.where(np.isnan(mean_test), -np.inf, mean_test)
            ranks = np.argsort(np.argsort(-mean_ranked)) + 1
            cv_results[f"mean_test_{metric}"] = mean_test.tolist()
            cv_results[f"std_test_{metric}"] = std_test.tolist()
            cv_results[f"rank_test_{metric}"] = ranks.tolist()
            for fi in range(len(splits)):
                cv_results[f"split{fi}_test_{metric}"] = scores[:, fi].tolist()
            if train_scores is not None:
                tr = train_scores[metric]
                cv_results[f"mean_train_{metric}"] = tr.mean(axis=1).tolist()
                for fi in range(len(splits)):
                    cv_results[f"split{fi}_train_{metric}"] = tr[:, fi].tolist()
        for k in sorted({k for p in candidates for k in p}):
            cv_results[f"param_{k}"] = [p.get(k) for p in candidates]
        self.cv_results_ = cv_results
        self.n_splits_ = len(splits)
        if primary is False:
            return
        mean_test = np.asarray(cv_results[f"mean_test_{primary}"])
        if np.all(np.isnan(mean_test)):
            raise ValueError("every candidate's fit failed (all mean test scores are NaN); "
                             "re-run with error_score='raise' to see the cause")
        self.best_index_ = int(np.nanargmax(mean_test))
        self.best_score_ = float(mean_test[self.best_index_])
        self.best_params_ = candidates[self.best_index_]

    # -- after the fit -------------------------------------------------
    def _check_refit(self, method):
        if not self.refit:
            raise AttributeError(f"{method} requires refit=True")

    def _inference_input(self, X):
        """Sharded input stays sharded for a winner that runs on the
        device; anything else comes to the host."""
        X = as_sharded(X)
        if isinstance(X, ShardedRows) and self._device_capable():
            return X
        return _host(X)

    def predict(self, X):
        self._check_refit("predict")
        return self.best_estimator_.predict(self._inference_input(X))

    def predict_proba(self, X):
        self._check_refit("predict_proba")
        return self.best_estimator_.predict_proba(self._inference_input(X))

    def transform(self, X):
        self._check_refit("transform")
        return self.best_estimator_.transform(self._inference_input(X))

    def score(self, X, y=None):
        self._check_refit("score")
        scorers, multimetric = self._resolve_scorers()
        if multimetric and callable(self.refit):
            raise ValueError("score() is ambiguous with multimetric scoring and a callable "
                             "refit (no single refit metric); score the best_estimator_ "
                             "directly or pass refit=<metric name>")
        scorer = scorers[self.refit] if multimetric else scorers["score"]
        Xi = self._inference_input(X)
        yi = as_sharded(y) if isinstance(Xi, ShardedRows) else _host(as_sharded(y))
        return scorer(self.best_estimator_, Xi, yi)


class GridSearchCV(_BaseSearchCV):
    """Exhaustive search over ``param_grid`` (reference:
    ``_search.py :: GridSearchCV``)."""

    def __init__(self, estimator, param_grid, scoring=None, cv=None, refit=True,
                 error_score="raise", return_train_score=False, scheduler=None, n_jobs=-1,
                 cache_cv=True):
        self.param_grid = param_grid
        super().__init__(estimator, scoring=scoring, cv=cv, refit=refit,
                         error_score=error_score, return_train_score=return_train_score,
                         scheduler=scheduler, n_jobs=n_jobs, cache_cv=cache_cv)

    def _get_param_iterator(self):
        return ParameterGrid(self.param_grid)


class RandomizedSearchCV(_BaseSearchCV):
    """``n_iter`` candidates drawn from ``param_distributions`` (reference:
    ``_search.py :: RandomizedSearchCV``)."""

    def __init__(self, estimator, param_distributions, n_iter=10, random_state=None,
                 scoring=None, cv=None, refit=True, error_score="raise",
                 return_train_score=False, scheduler=None, n_jobs=-1, cache_cv=True):
        self.param_distributions = param_distributions
        self.n_iter = n_iter
        self.random_state = random_state
        super().__init__(estimator, scoring=scoring, cv=cv, refit=refit,
                         error_score=error_score, return_train_score=return_train_score,
                         scheduler=scheduler, n_jobs=n_jobs, cache_cv=cache_cv)

    def _get_param_iterator(self):
        return ParameterSampler(self.param_distributions, self.n_iter,
                                random_state=check_random_state(self.random_state))
