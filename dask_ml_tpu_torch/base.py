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

import numpy as np

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


def _clone_param(v):
    if isinstance(v, BaseEstimator):
        return clone(v)
    if type(v) in (list, tuple):  # a pipeline's steps: (name, estimator) pairs
        return type(v)(_clone_param(e) for e in v)
    return copy.deepcopy(v)


def clone(estimator):
    """A new unfitted estimator with the same parameters (deep-copied,
    estimators among them cloned, also inside lists and tuples)."""
    params = {k: _clone_param(v) for k, v in estimator.get_params(deep=False).items()}
    return type(estimator)(**params)


def is_classifier(estimator) -> bool:
    """Whether ``estimator`` is a classifier (its ``_estimator_type``, as
    scikit-learn's ``is_classifier`` reads it)."""
    return getattr(estimator, "_estimator_type", None) == "classifier"


class ClassifierMixin:
    """Marks a classifier, as scikit-learn's mixin does; each estimator
    defines its own ``score``."""

    _estimator_type = "classifier"


class RegressorMixin:
    """Marks a regressor, as scikit-learn's mixin does; each estimator
    defines its own ``score``."""

    _estimator_type = "regressor"


class TransformerMixin:
    def fit_transform(self, X, y=None, **fit_params):
        return self.fit(X, y, **fit_params).transform(X)


class OneToOneFeatureMixin:
    """Output feature names equal to the input names, for transformers that
    map each input feature to one output feature (scikit-learn's mixin of
    that name, whose ``get_feature_names_out`` this repeats)."""

    def get_feature_names_out(self, input_features=None):
        if not hasattr(self, "n_features_in_"):
            raise AttributeError(
                f"This {type(self).__name__} instance is not fitted yet; call 'fit' first.")
        names_in = getattr(self, "feature_names_in_", None)
        if input_features is not None:
            input_features = np.asarray(input_features, dtype=object)
            if names_in is not None and not np.array_equal(names_in, input_features):
                raise ValueError("input_features is not equal to feature_names_in_")
            if len(input_features) != self.n_features_in_:
                raise ValueError(
                    f"input_features should have length equal to number of features "
                    f"({self.n_features_in_}), got {len(input_features)}")
            return input_features
        if names_in is not None:
            return np.asarray(names_in, dtype=object)
        return np.asarray([f"x{i}" for i in range(self.n_features_in_)], dtype=object)


class ComponentsOutMixin:
    """Output feature names ``<classname><i>`` for each fitted component
    (scikit-learn's ``ClassNamePrefixFeaturesOutMixin``, bound to
    ``components_``'s row count as the reference's mixin binds it; shared
    by PCA, TruncatedSVD and IncrementalPCA)."""

    @property
    def _n_features_out(self):
        return self.components_.shape[0]

    def get_feature_names_out(self, input_features=None):
        if not hasattr(self, "components_"):
            raise AttributeError(
                f"This {type(self).__name__} instance is not fitted yet; call 'fit' first.")
        n_in = getattr(self, "n_features_in_", None)
        if input_features is not None and n_in is not None and len(input_features) != n_in:
            raise ValueError(
                f"input_features should have length equal to number of features "
                f"({n_in}), got {len(input_features)}")
        prefix = type(self).__name__.lower()
        return np.asarray([f"{prefix}{i}" for i in range(self._n_features_out)], dtype=object)


class TorchEstimator(BaseEstimator):
    """Base for the port's estimators: parameter contract + padded ingest."""

    def _ingest(self, X) -> ShardedRows:
        return shard_rows(X)
