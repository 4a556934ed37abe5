"""A minimal ``Pipeline``: what the port's grid search needs of
scikit-learn's (``sklearn.pipeline.Pipeline``), which the reference's
search takes from scikit-learn and the port runs without, as
``model_selection/_sampling.py`` keeps a copy of ``ParameterGrid``.

Steps are (name, estimator) pairs; every step but the last transforms
(``fit_transform``, ``transform``), and any may be ``None`` or
``"passthrough"``.  Parameters follow scikit-learn's contract:
``get_params(deep=True)`` lists each step by its name and each step's own
parameters as ``<step>__<param>``, ``set_params`` routes them back, and
``clone`` clones every step.  The search recognises a pipeline by its
``steps``.  (``dask_ml_tpu_torch/pipeline/`` is the input pipeline, not
this.)
"""

from __future__ import annotations

from collections import Counter

from ..base import BaseEstimator

__all__ = ["Pipeline", "make_pipeline"]

_SKIP = (None, "passthrough")


class Pipeline(BaseEstimator):
    """Chain transforms and a final estimator: ``fit`` fits each step on
    the previous step's output; ``predict``, ``predict_proba``,
    ``transform`` and ``score`` pass X through the fitted transforms to
    the last step."""

    def __init__(self, steps):
        self.steps = steps

    # -- parameters ----------------------------------------------------
    def _check_steps(self):
        names = [name for name, _ in self.steps]
        if len(set(names)) != len(names):
            raise ValueError(f"Names provided are not unique: {names!r}")
        for name in names:
            if "__" in name:
                raise ValueError(f"Estimator names must not contain __: got {name!r}")
            if name in self._get_param_names():
                raise ValueError(f"Estimator names conflict with constructor arguments: "
                                 f"{name!r}")
        for name, est in self.steps[:-1]:
            if est not in _SKIP and not (hasattr(est, "fit") and hasattr(est, "transform")):
                raise TypeError(f"All intermediate steps should be transformers and implement "
                                f"fit and transform or be 'passthrough'; {name!r} ({est!r}) "
                                "doesn't")

    def get_params(self, deep=True):
        out = {name: getattr(self, name) for name in self._get_param_names()}
        if deep:
            for name, est in self.steps:
                out[name] = est
                if hasattr(est, "get_params"):
                    out.update((f"{name}__{k}", v) for k, v in est.get_params(deep=True).items())
        return out

    def set_params(self, **params):
        if "steps" in params:
            self.steps = list(params.pop("steps"))
        names = [name for name, _ in self.steps]
        for key in [k for k in params if k in names]:
            i = names.index(key)
            self.steps = list(self.steps)
            self.steps[i] = (key, params.pop(key))
        nested = {}
        for key, value in params.items():
            name, sep, sub = key.partition("__")
            if sep and name in names:
                nested.setdefault(name, {})[sub] = value
            elif not sep and name in self._get_param_names():
                setattr(self, name, value)
            else:
                raise ValueError(f"Invalid parameter {name!r} for estimator Pipeline. Valid "
                                 f"parameters are: {sorted(self._get_param_names()) + names!r}.")
        steps = dict(self.steps)
        for name, sub in nested.items():
            steps[name].set_params(**sub)
        return self

    @property
    def named_steps(self):
        return dict(self.steps)

    @property
    def _final_estimator(self):
        return self.steps[-1][1]

    @property
    def _estimator_type(self):
        return getattr(self._final_estimator, "_estimator_type", None)

    # -- fitting -------------------------------------------------------
    def _route(self, fit_params):
        """``<step>__<param>`` fit parameters, by step."""
        routed = {name: {} for name, _ in self.steps}
        for key, value in fit_params.items():
            name, sep, sub = key.partition("__")
            if not sep or name not in routed:
                raise ValueError(f"Pipeline.fit does not accept the {key} parameter; pass "
                                 "<step>__<param>")
            routed[name][sub] = value
        return routed

    def _fit_prefix(self, X, y, routed):
        self._check_steps()
        Xt = X
        for name, est in self.steps[:-1]:
            if est in _SKIP:
                continue
            Xt = est.fit_transform(Xt, y, **routed[name])
        return Xt

    def fit(self, X, y=None, **fit_params):
        routed = self._route(fit_params)
        Xt = self._fit_prefix(X, y, routed)
        name, final = self.steps[-1]
        if final not in _SKIP:
            final.fit(Xt, y, **routed[name])
        return self

    def fit_transform(self, X, y=None, **fit_params):
        routed = self._route(fit_params)
        Xt = self._fit_prefix(X, y, routed)
        name, final = self.steps[-1]
        if final in _SKIP:
            return Xt
        if hasattr(final, "fit_transform"):
            return final.fit_transform(Xt, y, **routed[name])
        return final.fit(Xt, y, **routed[name]).transform(Xt)

    # -- inference -----------------------------------------------------
    def _transform_prefix(self, X):
        Xt = X
        for _, est in self.steps[:-1]:
            if est not in _SKIP:
                Xt = est.transform(Xt)
        return Xt

    def predict(self, X, **params):
        return self._final_estimator.predict(self._transform_prefix(X), **params)

    def predict_proba(self, X):
        return self._final_estimator.predict_proba(self._transform_prefix(X))

    def transform(self, X):
        Xt = self._transform_prefix(X)
        final = self._final_estimator
        return Xt if final in _SKIP else final.transform(Xt)

    def score(self, X, y=None, sample_weight=None):
        kw = {} if sample_weight is None else {"sample_weight": sample_weight}
        return self._final_estimator.score(self._transform_prefix(X), y, **kw)


def make_pipeline(*steps) -> Pipeline:
    """A :class:`Pipeline` whose steps are named by their lowercased class
    names, numbered ``-1``, ``-2``, ... where a name repeats (scikit-learn's
    naming)."""
    names = [type(est).__name__.lower() for est in steps]
    counts = Counter(names)
    seen = Counter()
    named = []
    for name, est in zip(names, steps):
        if counts[name] > 1:
            seen[name] += 1
            name = f"{name}-{seen[name]}"
        named.append((name, est))
    return Pipeline(named)
