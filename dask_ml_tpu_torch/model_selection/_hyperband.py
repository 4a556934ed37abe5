"""``HyperbandSearchCV``: the port of
``dask_ml_tpu/model_selection/_hyperband.py``.

The bracket schedule comes from ``max_iter`` and ``aggressiveness`` (Li et
al. 2016, algorithm 1); each bracket is a :class:`SuccessiveHalvingSearchCV`
and ``metadata``/``metadata_`` give the budget before and after a fit, by
the reference's arithmetic.  The port runs the brackets one after another;
``sequential_brackets=False`` is accepted and gives the same results (the
brackets share no state, and the reference's concurrent and sequential
brackets agree).
"""

from __future__ import annotations

import math

from ._incremental import BaseIncrementalSearchCV
from ._successive_halving import SuccessiveHalvingSearchCV

__all__ = ["HyperbandSearchCV"]


def _get_hyperband_params(R, eta=3):
    """The bracket schedule: a list of (bracket, n, r)."""
    s_max = int(math.floor(math.log(R) / math.log(eta)))
    B = (s_max + 1) * R
    out = []
    for s in range(s_max, -1, -1):
        n = int(math.ceil(B / R * eta ** s / (s + 1)))
        r = int(R * eta ** -s)
        out.append((s, n, max(r, 1)))
    return out


def _simulate_sha_calls(n, r, R, eta):
    """The ``partial_fit`` calls an (n, r) SHA bracket makes, by
    SuccessiveHalvingSearchCV's policy (the first round of one call each,
    then the adaptive loop)."""
    calls = {i: 1 for i in range(n)}
    total = n
    steps = 0
    while True:
        n_i = int(math.floor(n * eta ** -steps))
        raw_target = int(round(r * eta ** steps))
        r_i = min(raw_target, R)
        steps += 1
        survivors = sorted(calls)[: max(n_i, 1)]
        if len(survivors) in (0, 1) and steps > 1:
            # the policy keeps raising the last survivor's rung until it
            # holds the whole budget: it ends at exactly R calls
            for ident in survivors:
                total += max(0, R - calls[ident])
            break
        added = 0
        for ident in survivors:
            more = max(0, r_i - calls[ident])
            calls[ident] += more
            added += more
        total += added
        if added == 0 and raw_target >= R:
            break  # every survivor at the max_iter budget
        calls = {i: calls[i] for i in survivors}
    return total


class HyperbandSearchCV(BaseIncrementalSearchCV):
    def __init__(self, estimator, parameters, max_iter=81, aggressiveness=3, test_size=None,
                 random_state=None, scoring=None, patience=False, tol=1e-3, verbose=False,
                 prefix="", chunk_size=None, checkpoint=None, sequential_brackets=False):
        self.max_iter = max_iter
        self.aggressiveness = aggressiveness
        self.sequential_brackets = sequential_brackets
        super().__init__(estimator, parameters, test_size=test_size, random_state=random_state,
                         scoring=scoring, max_iter=max_iter, patience=patience, tol=tol,
                         verbose=verbose, prefix=prefix, chunk_size=chunk_size,
                         checkpoint=checkpoint)

    @property
    def metadata(self):
        """The budget before fitting: models and ``partial_fit`` calls, in
        all and a bracket."""
        brackets = []
        n_models = total_calls = 0
        for s, n, r in _get_hyperband_params(self.max_iter, self.aggressiveness):
            calls = _simulate_sha_calls(n, r, self.max_iter, self.aggressiveness)
            brackets.append({"bracket": s, "n_models": n, "partial_fit_calls": calls})
            n_models += n
            total_calls += calls
        return {"n_models": n_models, "partial_fit_calls": total_calls, "brackets": brackets}

    def _make_brackets(self):
        brackets = []
        for s, n, r in _get_hyperband_params(self.max_iter, self.aggressiveness):
            seed = None if self.random_state is None else int(self.random_state) + s
            sha = SuccessiveHalvingSearchCV(
                self.estimator, self.parameters, n_initial_parameters=n, n_initial_iter=r,
                max_iter=self.max_iter, aggressiveness=self.aggressiveness,
                test_size=self.test_size, random_state=seed, scoring=self.scoring,
                prefix=f"{self.prefix}bracket={s}", chunk_size=self.chunk_size,
                patience=self.patience, tol=self.tol, verbose=self.verbose)
            brackets.append((s, sha))
        return brackets

    def fit(self, X, y=None, **fit_params):
        self._check_checkpoint()
        X_train, X_test, y_train, y_test = self._split(X, y)
        brackets = self._make_brackets()
        results = [sha._fit(X_train, y_train, X_test, y_test, **fit_params)
                   for _, sha in brackets]
        # the brackets' results merged under ids unique across them
        all_models, all_info = {}, {}
        meta_observed = []
        offset = 0
        for (s, sha), (models, info) in zip(brackets, results):
            meta_observed.append({
                "bracket": s, "n_models": len(info),
                "partial_fit_calls": sum(recs[-1]["partial_fit_calls"] for recs in info.values()),
            })
            for ident, recs in info.items():
                new_id = offset + ident
                all_info[new_id] = [{**rec, "model_id": new_id, "bracket": s} for rec in recs]
                all_models[new_id] = models[ident]
            offset += len(info)
        self._n_rounds = sum(sha._n_rounds for _, sha in brackets)
        self._process_results(all_models, all_info)
        self.metadata_ = {
            "n_models": sum(m["n_models"] for m in meta_observed),
            "partial_fit_calls": sum(m["partial_fit_calls"] for m in meta_observed),
            "brackets": meta_observed,
        }
        return self
