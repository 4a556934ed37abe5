"""The adaptive searches' core: the port of
``dask_ml_tpu/model_selection/_incremental.py``
(``BaseIncrementalSearchCV``, ``IncrementalSearchCV``,
``InverseDecaySearchCV``).

A search samples its candidates, splits off a held-out set, cuts the
training rows into blocks (kept where the data lives: a device
``ShardedRows`` input gives device blocks), and then runs rounds: each model
told to train takes its next ``n_calls`` blocks, one ``partial_fit`` a
block, and is scored on the held-out set; a policy,
``_additional_calls(info)``, reads every model's records and says what
trains next, until it returns ``{}``.  Each round's instructed models are
grouped by (pack key, budget, calls so far); a group of more than one
trains as a :class:`~._packing.Cohort`, one K5 launch a block, and is
scored by one packed product.

The port runs the reference's serialized round loop (its loop under
``DASK_ML_TPU_SEARCH_CONCURRENCY=off``): a round's cohorts in the order of
their keys, then its single models by id, one after another, each model's
calls one ``partial_fit`` at a time.  Not ported yet: ``checkpoint=``
([port-planes]), the concurrent orchestrator, the prefetched staged
streams, the fault-retry budget and the trace spans.
"""

from __future__ import annotations

import logging
import time
from collections import defaultdict

import numpy as np

from ..base import TorchEstimator, clone
from ..core.sharded import ShardedRows, unshard
from ..metrics.scorer import check_scoring
from ..utils import check_random_state
from ._sampling import ParameterGrid, ParameterSampler
from ._split import train_test_split

logger = logging.getLogger(__name__)

__all__ = ["BaseIncrementalSearchCV", "IncrementalSearchCV", "InverseDecaySearchCV"]


def _partial_fit(model_and_meta, X, y, fit_params):
    """One unit of budget: ``partial_fit`` on one block."""
    model, meta = model_and_meta
    start = time.time()
    model.partial_fit(X, y, **(fit_params or {}))
    meta = dict(meta)
    meta["partial_fit_calls"] += 1
    meta["partial_fit_time"] = time.time() - start
    return model, meta


def _score(model_and_meta, X_test, y_test, scorer):
    model, meta = model_and_meta
    start = time.time()
    score = scorer(model, X_test, y_test)
    meta = dict(meta)
    meta["score_time"] = time.time() - start
    meta["score"] = float(score)
    return meta


def _create_model(estimator, params, random_state):
    model = clone(estimator).set_params(**params)
    if "random_state" in model.get_params():
        model.set_params(random_state=random_state)
    return model


class BaseIncrementalSearchCV(TorchEstimator):
    """Adaptive search over ``partial_fit`` estimators.

    Subclasses supply ``_additional_calls(info)``; ``info`` maps a model id
    to its list of records (dicts with ``partial_fit_calls``, ``score``, ...).
    """

    def __init__(self, estimator, parameters, n_initial_parameters=10, test_size=None,
                 random_state=None, scoring=None, max_iter=100, patience=False, tol=1e-3,
                 fits_per_score=1, verbose=False, prefix="", chunk_size=None, checkpoint=None):
        self.estimator = estimator
        self.parameters = parameters
        self.n_initial_parameters = n_initial_parameters
        self.test_size = test_size
        self.random_state = random_state
        self.scoring = scoring
        self.checkpoint = checkpoint
        self.max_iter = max_iter
        self.patience = patience
        self.tol = tol
        self.fits_per_score = fits_per_score
        self.verbose = verbose
        self.prefix = prefix
        self.chunk_size = chunk_size

    # -- policy hooks --------------------------------------------------
    def _additional_calls(self, info):
        raise NotImplementedError

    def _patience_calls(self) -> int:
        """The patience budget in ``partial_fit`` calls; 0 is off.
        ``patience=True`` is ``max_iter // aggressiveness`` (3 where the
        policy has none)."""
        if not self.patience:
            return 0
        if self.patience is True:
            eta = int(getattr(self, "aggressiveness", 3) or 3)
            return max(int(self.max_iter) // eta, 1)
        return int(self.patience)

    def _filter_plateaued(self, info, instructions):
        """Drop the positive instructions of models whose score has not
        improved by ``tol`` over their last ``patience`` calls (a window in
        ``partial_fit_calls`` distance, not in records), after every
        policy's ``_additional_calls``."""
        patience = self._patience_calls()
        if not patience:
            return instructions
        out = {}
        for ident, n_calls in instructions.items():
            if n_calls > 0:
                recs = info[ident]
                edge = recs[-1]["partial_fit_calls"] - patience
                window = [r["score"] for r in recs if r["partial_fit_calls"] > edge]
                older = [r["score"] for r in recs if r["partial_fit_calls"] <= edge]
                if older and window and all(s < older[-1] + self.tol for s in window):
                    continue
            out[ident] = n_calls
        return out

    def _reset_policy(self):
        """Clear the policy's state between fits."""

    # -- parameter sampling -------------------------------------------
    def _get_params(self):
        rng = check_random_state(self.random_state)
        if self.n_initial_parameters == "grid":
            return list(ParameterGrid(self.parameters))
        return list(ParameterSampler(self.parameters, self.n_initial_parameters,
                                     random_state=rng))

    # -- data plumbing -------------------------------------------------
    def _to_blocks(self, X, y):
        """Row blocks where the data lives: a ShardedRows input gives device
        slices (views, no copy), a host input host slices."""
        if isinstance(X, ShardedRows):
            n = X.n_samples
            chunk = self.chunk_size or max(1, n // 10)
            ysr = y if isinstance(y, ShardedRows) else None
            yh = None if ysr is not None else np.asarray(y)
            blocks = []
            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                xb = ShardedRows(data=X.data[lo:hi], mask=X.mask[lo:hi], n_samples=hi - lo)
                if ysr is not None:
                    yb = ShardedRows(data=ysr.data[lo:hi], mask=ysr.mask[lo:hi],
                                     n_samples=hi - lo)
                else:
                    yb = yh[lo:hi]
                blocks.append((xb, yb))
            return blocks
        Xh = np.asarray(X)
        yh = unshard(y) if isinstance(y, ShardedRows) else np.asarray(y)
        n = Xh.shape[0]
        chunk = self.chunk_size or max(1, n // 10)
        return [(Xh[lo: lo + chunk], yh[lo: lo + chunk]) for lo in range(0, n, chunk)]

    def _fit(self, X_train, y_train, X_test, y_test, **fit_params):
        """The round loop; returns ``(models, info)``."""
        from ._packing import Cohort, pack_key

        self._reset_policy()
        scorer = check_scoring(self.estimator, self.scoring)
        params = self._get_params()
        rng = check_random_state(self.random_state)
        seeds = rng.randint(0, 2 ** 31 - 1, size=len(params))
        blocks = self._to_blocks(X_train, y_train)
        n_blocks = len(blocks)
        models = {}
        info = defaultdict(list)
        start_time = time.time()
        for ident, (p, seed) in enumerate(zip(params, seeds)):
            model = _create_model(self.estimator, p, int(seed))
            models[ident] = (model, {"model_id": ident, "params": p, "partial_fit_calls": 0,
                                     "partial_fit_time": 0.0, "score_time": 0.0,
                                     "elapsed_wall_time": 0.0})
        host_block_cache: dict = {}

        def block_for(model, block_idx):
            """A block as the model takes it: host models get a host copy of
            a device block, fetched once for the whole search."""
            Xb, yb = blocks[block_idx]
            if isinstance(Xb, ShardedRows) and not isinstance(model, TorchEstimator):
                if block_idx not in host_block_cache:
                    host_block_cache[block_idx] = (
                        unshard(Xb), unshard(yb) if isinstance(yb, ShardedRows) else yb)
                return host_block_cache[block_idx]
            return Xb, yb

        def train_one(ident, n_calls):
            model, meta = models[ident]
            for _ in range(n_calls):
                Xb, yb = block_for(model, meta["partial_fit_calls"] % n_blocks)
                model, meta = _partial_fit((model, meta), Xb, yb, fit_params)
            meta = _score((model, meta), X_test, y_test, scorer)
            meta["elapsed_wall_time"] = time.time() - start_time
            models[ident] = (model, meta)
            info[ident].append(meta)

        def score_cohort(cohort, idents):
            """Every member's score from one packed product and one read
            with the default (accuracy) scorer; (None, 0) where that does
            not apply."""
            if self.scoring is not None:
                return None, 0.0
            try:
                t0s = time.time()
                scores = cohort.packed_accuracy(X_test, y_test)
                return scores, (time.time() - t0s) / max(len(idents), 1)
            except (TypeError, ValueError):
                return None, 0.0

        def train_cohort(idents, n_calls):
            """A lockstep group: one K5 launch a block advances the group;
            the records are what ``train_one`` on each member would give."""
            cohort = Cohort([models[i][0] for i in idents],
                            classes=(fit_params or {}).get("classes"))
            calls0 = models[idents[0]][1]["partial_fit_calls"]
            t0 = time.time()
            for j in range(n_calls):
                Xb, yb = blocks[(calls0 + j) % n_blocks]
                cohort.step(Xb, yb)
            t_fit_end = time.time()
            packed_scores, packed_score_time = score_cohort(cohort, idents)
            cohort.finalize()
            # one model's one call, as train_one's partial_fit_time
            pf_time = (t_fit_end - t0) / max(n_calls * len(idents), 1)
            for i, ident in enumerate(idents):
                model, meta = models[ident]
                meta = dict(meta)
                meta["partial_fit_calls"] += n_calls
                meta["partial_fit_time"] = pf_time
                if packed_scores is not None:
                    meta["score"] = float(packed_scores[i])
                    meta["score_time"] = packed_score_time
                else:
                    meta = _score((model, meta), X_test, y_test, scorer)
                meta["elapsed_wall_time"] = time.time() - start_time
                models[ident] = (model, meta)
                info[ident].append(meta)

        def pack_groups(instructions):
            """Instructed models grouped by (pack key, budget, calls so far):
            ``(groups of more than one, single (ident, n_calls) pairs)``."""
            groups = defaultdict(list)
            singles = []
            for ident, n_calls in instructions.items():
                if n_calls <= 0:
                    continue
                model, meta = models[ident]
                key = pack_key(model)
                if key is None:
                    singles.append((ident, n_calls))
                else:
                    groups[(key, n_calls, meta["partial_fit_calls"])].append(ident)
            packed = {k: v for k, v in groups.items() if len(v) > 1}
            singles += [(v[0], k[1]) for k, v in groups.items() if len(v) == 1]
            return packed, singles

        def run_round(instructions):
            packed, singles = pack_groups(instructions)
            for (_, n_calls, _), idents in sorted(packed.items(), key=lambda kv: repr(kv[0])):
                train_cohort(list(idents), n_calls)
            for ident, n_calls in sorted(singles):
                train_one(ident, n_calls)

        run_round({ident: 1 for ident in models})
        self._n_rounds = 1
        round_no = 0
        while True:
            instructions = self._filter_plateaued(info, self._additional_calls(dict(info)))
            if self.verbose:
                best = max((recs[-1]["score"] for recs in info.values()), default=float("nan"))
                active = sum(1 for v in instructions.values() if v > 0)
                logger.info("%s[round %d] %d/%d models continue, best score %.4f", self.prefix,
                            round_no, active, len(info), best)
            if not instructions:
                break
            round_no += 1
            run_round(instructions)
            self._n_rounds += 1
        return models, dict(info)

    def _process_results(self, models, info):
        best_id = max(info, key=lambda ident: info[ident][-1]["score"])
        best_model, best_meta = models[best_id]
        self.best_estimator_ = best_model
        self.best_index_ = int(best_id)
        self.best_score_ = best_meta["score"]
        self.best_params_ = best_meta["params"]
        self.history_ = sorted((rec for recs in info.values() for rec in recs),
                               key=lambda r: (r["elapsed_wall_time"], r["model_id"]))
        self.model_history_ = {k: list(v) for k, v in info.items()}
        cv_results = {"model_id": [], "params": [], "test_score": [], "partial_fit_calls": []}
        for ident, recs in sorted(info.items()):
            last = recs[-1]
            cv_results["model_id"].append(ident)
            cv_results["params"].append(last["params"])
            cv_results["test_score"].append(last["score"])
            cv_results["partial_fit_calls"].append(last["partial_fit_calls"])
        keys = {k for rec in cv_results["params"] for k in rec}
        for k in sorted(keys):
            cv_results[f"param_{k}"] = [p.get(k) for p in cv_results["params"]]
        ranks = np.argsort(np.argsort(-np.asarray(cv_results["test_score"]))) + 1
        cv_results["rank_test_score"] = ranks.tolist()
        self.cv_results_ = cv_results
        self.n_models_ = len(info)
        return self

    def _check_checkpoint(self):
        if self.checkpoint:
            raise NotImplementedError(
                "checkpoint= is not ported yet (ROADMAP: [port-planes] checkpoint)")

    def fit(self, X, y=None, **fit_params):
        self._check_checkpoint()
        X_train, X_test, y_train, y_test = self._split(X, y)
        models, info = self._fit(X_train, y_train, X_test, y_test, **fit_params)
        return self._process_results(models, info)

    def _split(self, X, y):
        if y is None:
            raise ValueError("y is required: incremental searches score models on a held-out "
                             "(X_test, y_test) split")
        test_size = self.test_size if self.test_size is not None else 0.15
        X_train, X_test, y_train, y_test = train_test_split(
            X, y, test_size=test_size, random_state=self.random_state)
        device_scoring_ok = self.scoring is None or isinstance(self.scoring, str)
        if not (isinstance(self.estimator, TorchEstimator) and device_scoring_ok):
            # host models score host arrays; device models keep the held-out
            # split on the device
            X_test = unshard(X_test) if isinstance(X_test, ShardedRows) else X_test
            y_test = unshard(y_test) if isinstance(y_test, ShardedRows) else y_test
        return X_train, X_test, y_train, y_test

    # -- inference forwards to the winner ------------------------------
    def predict(self, X):
        return self.best_estimator_.predict(unshard(X) if isinstance(X, ShardedRows) else X)

    def predict_proba(self, X):
        return self.best_estimator_.predict_proba(
            unshard(X) if isinstance(X, ShardedRows) else X)

    def score(self, X, y=None):
        scorer = check_scoring(self.estimator, self.scoring)
        return scorer(self.best_estimator_, unshard(X) if isinstance(X, ShardedRows) else X,
                      unshard(y) if isinstance(y, ShardedRows) else y)


class IncrementalSearchCV(BaseIncrementalSearchCV):
    """Train many models incrementally; with ``patience`` stop each whose
    score plateaus, else train every model to ``max_iter``."""

    def _additional_calls(self, info):
        out = {}
        for ident, recs in info.items():
            calls = recs[-1]["partial_fit_calls"]
            if calls >= self.max_iter:
                continue
            out[ident] = min(self.fits_per_score, self.max_iter - calls)
        return out


class InverseDecaySearchCV(BaseIncrementalSearchCV):
    """Keep ``n_initial / (1 + k)**decay_rate`` of the models in round k."""

    def __init__(self, estimator, parameters, n_initial_parameters=10, test_size=None,
                 random_state=None, scoring=None, max_iter=100, patience=False, tol=1e-3,
                 fits_per_score=1, decay_rate=1.0, verbose=False, prefix="", chunk_size=None,
                 checkpoint=None):
        self.decay_rate = decay_rate
        super().__init__(estimator, parameters, n_initial_parameters=n_initial_parameters,
                         test_size=test_size, random_state=random_state, scoring=scoring,
                         max_iter=max_iter, patience=patience, tol=tol,
                         fits_per_score=fits_per_score, verbose=verbose, prefix=prefix,
                         chunk_size=chunk_size, checkpoint=checkpoint)
        self._step = 1

    def _reset_policy(self):
        self._step = 1

    def _additional_calls(self, info):
        n_initial = len(info)
        keep = max(1, int(np.ceil(n_initial / (1 + self._step) ** self.decay_rate)))
        by_score = sorted(info, key=lambda ident: info[ident][-1]["score"], reverse=True)
        self._step += 1
        out = {}
        for ident in by_score[:keep]:
            calls = info[ident][-1]["partial_fit_calls"]
            if calls < self.max_iter:
                out[ident] = min(self.fits_per_score, self.max_iter - calls)
        return out
