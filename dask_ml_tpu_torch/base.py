"""Estimator base classes without scikit-learn.

The reference subclasses sklearn's ``BaseEstimator`` for the parameter
contract.  The port must run where scikit-learn is not installed, so it
carries the part of that contract its estimators use: ``get_params`` and
``set_params`` read from the ``__init__`` signature, ``clone``, a
``repr`` of the changed parameters and ``fit_transform``.
"""

from __future__ import annotations

import copy
import inspect

from .core.sharded import ShardedRows, shard_rows


def _changed(value, default) -> bool:
    try:
        return bool(value != default)
    except (TypeError, ValueError, RuntimeError):  # arrays, tensors
        return True


class BaseEstimator:
    """``get_params``/``set_params`` from the ``__init__`` signature."""

    @classmethod
    def _get_param_names(cls):
        sig = inspect.signature(cls.__init__)
        return sorted(
            p.name for p in sig.parameters.values()
            if p.name != "self" and p.kind not in (p.VAR_POSITIONAL,
                                                   p.VAR_KEYWORD)
        )

    def get_params(self, deep=True):
        out = {}
        for name in self._get_param_names():
            value = getattr(self, name)
            if deep and isinstance(value, BaseEstimator):
                out.update((f"{name}__{k}", v)
                           for k, v in value.get_params().items())
            out[name] = value
        return out

    def set_params(self, **params):
        valid = self.get_params(deep=True)
        nested = {}
        for key, value in params.items():
            name, sep, sub = key.partition("__")
            if name not in valid:
                raise ValueError(
                    f"Invalid parameter {name!r} for estimator "
                    f"{type(self).__name__}. Valid parameters are: "
                    f"{sorted(self._get_param_names())!r}."
                )
            if sep:
                nested.setdefault(name, {})[sub] = value
            else:
                setattr(self, name, value)
        for name, sub in nested.items():
            getattr(self, name).set_params(**sub)
        return self

    def __repr__(self):
        defaults = {
            p.name: p.default
            for p in inspect.signature(type(self).__init__).parameters.values()
        }
        shown = ", ".join(
            f"{k}={v!r}" for k, v in self.get_params(deep=False).items()
            if _changed(v, defaults.get(k, inspect.Parameter.empty))
        )
        return f"{type(self).__name__}({shown})"


def clone(estimator):
    """A new unfitted estimator with the same parameters (deep-copied,
    estimators among them cloned)."""
    params = {
        k: clone(v) if isinstance(v, BaseEstimator) else copy.deepcopy(v)
        for k, v in estimator.get_params(deep=False).items()
    }
    return type(estimator)(**params)


class TransformerMixin:
    def fit_transform(self, X, y=None, **fit_params):
        return self.fit(X, y, **fit_params).transform(X)


class TorchEstimator(BaseEstimator):
    """Base for the port's estimators: parameter contract + padded ingest."""

    def _ingest(self, X) -> ShardedRows:
        return shard_rows(X)
