"""``SuccessiveHalvingSearchCV``: the port of
``dask_ml_tpu/model_selection/_successive_halving.py``, host logic copied
as it is.  A :class:`BaseIncrementalSearchCV` whose policy is SHA: train n
configurations r calls, keep the best 1/eta, grow each survivor's budget
eta-fold."""

from __future__ import annotations

import math

from ._incremental import BaseIncrementalSearchCV

__all__ = ["SuccessiveHalvingSearchCV"]


class SuccessiveHalvingSearchCV(BaseIncrementalSearchCV):
    def __init__(self, estimator, parameters, n_initial_parameters=10, n_initial_iter=None,
                 max_iter=None, aggressiveness=3, test_size=None, random_state=None,
                 scoring=None, patience=False, tol=1e-3, verbose=False, prefix="",
                 chunk_size=None, checkpoint=None):
        self.n_initial_iter = n_initial_iter
        self.aggressiveness = aggressiveness
        self._steps = 0
        self._survivors = None
        super().__init__(estimator, parameters, n_initial_parameters=n_initial_parameters,
                         test_size=test_size, random_state=random_state, scoring=scoring,
                         max_iter=max_iter if max_iter is not None else 100, patience=patience,
                         tol=tol, verbose=verbose, prefix=prefix, chunk_size=chunk_size,
                         checkpoint=checkpoint)

    def _reset_policy(self):
        self._steps = 0
        self._survivors = None

    def _additional_calls(self, info):
        if self.n_initial_iter is None:
            raise ValueError("n_initial_iter must be specified")
        # n: the models made (n_initial_parameters="grid" included)
        n, r, eta = len(info), self.n_initial_iter, self.aggressiveness
        n_i = int(math.floor(n * eta ** -self._steps))
        r_i = int(round(r * eta ** self._steps))
        self._steps += 1
        # only models still in the running are ranked: once halved out a
        # model stays out, so metadata_ == metadata whatever the scores
        pool = self._survivors if getattr(self, "_survivors", None) is not None else list(info)
        best = sorted(pool, key=lambda ident: info[ident][-1]["score"], reverse=True)[
            : max(n_i, 1)]
        self._survivors = best
        if len(best) in (0, 1) and self._steps > 1:
            # the last survivor: grant the rest of its budget, then stop
            out = {}
            for ident in best:
                target = min(r_i, self.max_iter) if self.max_iter else r_i
                more = max(0, target - info[ident][-1]["partial_fit_calls"])
                if more:
                    out[ident] = more
            return out
        out = {}
        any_progress = False
        capped = True
        for ident in best:
            calls = info[ident][-1]["partial_fit_calls"]
            target = r_i
            if self.max_iter:
                target = min(target, self.max_iter)
                capped = capped and target >= self.max_iter
            else:
                capped = False
            more = max(0, target - calls)
            out[ident] = more
            any_progress = any_progress or more > 0
        if not any_progress and capped:
            return {}  # every survivor is at the max_iter budget
        return out
