"""Meta-estimators: the port of ``dask_ml_tpu/wrappers.py`` (reference:
``dask_ml/wrappers.py``).

``ParallelPostFit`` fits an estimator once and runs inference over large
data in row chunks; with one of the port's estimators and a
``ShardedRows`` input, inference is one call on the device.
``Incremental`` streams row blocks through ``partial_fit``
(``_partial.fit``, through the input pipeline at ``prefetch_depth``) from
an array, an iterator of blocks or a sharded dataset.  A string
``scoring`` goes through ``metrics.scorer.check_scoring``: ``accuracy``
and ``r2`` are ported, and the other names raise there.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _partial
from .base import TorchEstimator, clone
from .core.sharded import ShardedRows, as_sharded, unshard
from .utils import copy_learned_attributes


class NotFittedError(ValueError, AttributeError):
    """An estimator was used before it was fitted (scikit-learn's error of
    the same name)."""


def _check_is_fitted(estimator):
    """scikit-learn's rule: an estimator is fitted once it has a public
    attribute ending in an underscore."""
    if not [v for v in vars(estimator) if v.endswith("_") and not v.startswith("__")]:
        raise NotFittedError(
            f"This {type(estimator).__name__} instance is not fitted yet. Call 'fit' with "
            "appropriate arguments before using this estimator.")


def _host(a):
    """A ShardedRows' real rows, or a tensor, on the host."""
    if isinstance(a, ShardedRows):
        return unshard(a)
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


class ParallelPostFit(TorchEstimator):
    def __init__(self, estimator=None, scoring=None, predict_meta=None, predict_proba_meta=None,
                 transform_meta=None):
        self.estimator = estimator
        self.scoring = scoring
        self.predict_meta = predict_meta
        self.predict_proba_meta = predict_proba_meta
        self.transform_meta = transform_meta

    def fit(self, X, y=None, **kwargs):
        est = clone(self.estimator)
        Xh = unshard(X) if isinstance(X, ShardedRows) else X
        yh = unshard(y) if isinstance(y, ShardedRows) else y
        est.fit(Xh, yh, **kwargs) if yh is not None else est.fit(Xh, **kwargs)
        self.estimator_ = est
        copy_learned_attributes(est, self)
        return self

    @property
    def _postfit_estimator(self):
        if hasattr(self, "estimator_"):
            return self.estimator_
        _check_is_fitted(self.estimator)  # a fitted estimator may be passed in
        return self.estimator

    def _apply(self, method, X, chunk_size=100_000):
        est = self._postfit_estimator
        fn = getattr(est, method)
        native = isinstance(est, TorchEstimator)
        if native:
            X = as_sharded(X)
            if isinstance(X, ShardedRows):
                return fn(X)  # one call on the device, no chunking
        X = np.asarray(_host(X))
        return np.concatenate([_partial._to_host(fn(X[lo:hi]))
                               for lo, hi in _partial._row_chunks(X.shape[0], chunk_size)])

    def predict_blocks(self, X, method="predict", chunk_size=100_000):
        """Yield each chunk's inference result (host arrays; sparse outputs
        stay sparse) instead of concatenating them.  ``X`` may be an array,
        a tensor, a ``ShardedRows``, a scipy sparse matrix, a sharded dataset
        (its readers feed inference; the targets are dropped) or an iterable
        of row blocks."""
        import scipy.sparse

        est = self._postfit_estimator
        fn = getattr(est, method)
        native = isinstance(est, TorchEstimator)

        def _as_block(out):
            return out if scipy.sparse.issparse(out) else _partial._to_host(out)

        if hasattr(X, "iter_blocks"):
            for xb in _partial._x_only(X.iter_blocks()):
                yield _as_block(fn(xb))
            return
        if native:
            X = as_sharded(X)
        if isinstance(X, ShardedRows):
            for lo, hi in _partial._row_chunks(X.n_samples, chunk_size):
                if native:  # device views, chunk-sized results
                    yield _as_block(fn(ShardedRows(data=X.data[lo:hi], mask=X.mask[lo:hi],
                                                   n_samples=hi - lo)))
                else:
                    yield _as_block(fn(X.data[lo:hi].detach().cpu().numpy()))
            return
        if isinstance(X, torch.Tensor):
            X = X.detach().cpu().numpy()
        if scipy.sparse.issparse(X) or hasattr(X, "shape"):
            X = X if scipy.sparse.issparse(X) else np.asarray(X)
            for lo, hi in _partial._row_chunks(X.shape[0], chunk_size):
                yield _as_block(fn(X[lo:hi]))
            return
        for block in X:
            yield _as_block(fn(block))

    def predict(self, X):
        return self._apply("predict", X)

    def predict_proba(self, X):
        return self._apply("predict_proba", X)

    def predict_log_proba(self, X):
        return self._apply("predict_log_proba", X)

    def transform(self, X):
        return self._apply("transform", X)

    def score(self, X, y, compute=True):
        """The estimator's own ``score`` on host rows (``scoring=None``), or
        the scorer that ``metrics.scorer.check_scoring`` gives for
        ``scoring`` (a callable, or a name: ``accuracy`` and ``r2`` are
        ported, the other names raise from ``get_scorer``) on this wrapper."""
        from .metrics.scorer import check_scoring

        scorer = check_scoring(self._postfit_estimator, self.scoring)
        if self.scoring:
            return scorer(self, X, y)
        Xh = unshard(X) if isinstance(X, ShardedRows) else X
        yh = unshard(y) if isinstance(y, ShardedRows) else y
        return self._postfit_estimator.score(Xh, yh)


class Incremental(ParallelPostFit):
    """Fit by sequential ``partial_fit`` over row chunks (reference:
    ``wrappers.py :: Incremental``: ``shuffle_blocks``, ``random_state``,
    ``assume_equal_chunks``).  ``chunk_size=None`` resolves at use to
    ``DEFAULT_STREAM_CHUNK``, and ``prefetch_depth=None`` to the
    ``DASK_ML_TPU_TORCH_PREFETCH_DEPTH`` knob (else 2): the next block's
    read and staging overlap the current block's step, with the same result
    at every depth."""

    def __init__(self, estimator=None, scoring=None, shuffle_blocks=True, random_state=None,
                 assume_equal_chunks=True, predict_meta=None, predict_proba_meta=None,
                 transform_meta=None, chunk_size=None, prefetch_depth=None):
        self.shuffle_blocks = shuffle_blocks
        self.random_state = random_state
        self.assume_equal_chunks = assume_equal_chunks
        self.chunk_size = chunk_size
        self.prefetch_depth = prefetch_depth
        super().__init__(estimator=estimator, scoring=scoring, predict_meta=predict_meta,
                         predict_proba_meta=predict_proba_meta, transform_meta=transform_meta)

    def _fit_for_estimator(self, estimator, X, y, **fit_kwargs):
        _partial.fit(estimator, X, y, chunk_size=self.chunk_size,
                     shuffle_blocks=self.shuffle_blocks, random_state=self.random_state,
                     prefetch_depth=self.prefetch_depth, **fit_kwargs)
        self.estimator_ = estimator
        copy_learned_attributes(estimator, self)
        return self

    def fit(self, X, y=None, **fit_kwargs):
        return self._fit_for_estimator(clone(self.estimator), X, y, **fit_kwargs)

    def partial_fit(self, X, y=None, **fit_kwargs):
        """One more pass over (X, y) without re-initializing the model."""
        est = getattr(self, "estimator_", None) or clone(self.estimator)
        return self._fit_for_estimator(est, X, y, **fit_kwargs)
