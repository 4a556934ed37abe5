"""Multi-model packing: a cohort of same-key SGD models advanced in one
launch a block.  The port of ``dask_ml_tpu/model_selection/_packing.py``.

Models whose static configuration matches (:func:`pack_key`: the class,
loss, penalty, schedule and ``fit_intercept``) differ only in their
hyperparameters, so their states stack to coef ``[M, d, K]``, intercept
``[M, K]``, t ``[M]`` and their hyperparameters to ``[M, 7]``, and K5
(``ops/cohort.py``, ``csrc/cohort.cu``) advances all M on a block in one
launch that reads the block once.  ``BaseIncrementalSearchCV`` packs each
round's lockstep groups this way, so a Hyperband bracket of 81 models costs
one launch a block where it would cost 81.  ``DISPATCH_STATS`` counts the
launches against the model-steps they covered, as the reference counts its
dispatches.

The port runs on one device: there is no model axis to shard the stack
over.  Not ported yet: the staged streaming protocol (``_pf_stage``,
``_pf_consume``) and compile-ahead (``warm``), which come with the second
slice of [port-stream].
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.sharded import ShardedRows
from ..linear_model._sgd import SGDClassifier, SGDRegressor
from ..ops import cohort as k5
from ..utils import safe_denominator

__all__ = ["Cohort", "DISPATCH_STATS", "pack_key", "reset_dispatch_stats"]

#: launches of the packed step against the model-steps they covered: a
#: packed round of M models adds M to ``models_stepped`` and 1 to
#: ``dispatches``
DISPATCH_STATS = {"dispatches": 0, "models_stepped": 0, "cohorts": 0, "score_dispatches": 0}


def reset_dispatch_stats():
    for k in DISPATCH_STATS:
        DISPATCH_STATS[k] = 0


def pack_key(model):
    """A hashable key of the static configuration, or None when the model
    cannot be packed.  Models sharing a key take the same branches of the
    step; only their hyperparameters differ."""
    if isinstance(model, (SGDClassifier, SGDRegressor)):
        if getattr(model, "class_weight", None) == "balanced":
            # 'balanced' needs the whole label distribution, which a stream
            # of blocks does not give (partial_fit raises the same way)
            return None
        return (type(model).__name__, model.loss, model.penalty, model.learning_rate,
                model.fit_intercept)
    return None


class Cohort:
    """A lockstep group of same-key SGD models trained as one stack.

    The states are stacked at the first step, advanced by K5 for any number
    of blocks, and ``finalize()`` gives each model its slice (and its last
    mean loss) back: the models end as if ``partial_fit`` had been called
    on each of them.
    """

    def __init__(self, models, classes=None):
        if not models:
            raise ValueError("empty cohort")
        keys = {pack_key(m) for m in models}
        if len(keys) != 1 or None in keys:
            raise ValueError(f"models are not packable together: {keys}")
        for m in models:
            # the validation partial_fit applies: packed and unpacked rounds
            # reject the same configurations
            m._validate()
        self.models = list(models)
        self._m0 = models[0]
        self._classes = classes
        self._stacked = None
        self._losses = None

    def _prep(self, X, y, with_weights=True):
        """The shared block ``(xb, yb, masks, mask)`` on the device: the
        targets encoded once for the cohort, ``masks`` ``[M, B]`` a
        broadcast of ``mask`` unless a member has class weights (then each
        lane's own weighted copy)."""
        m0 = self._m0
        if isinstance(m0, SGDClassifier):
            for m in self.models:
                if not hasattr(m, "classes_"):
                    if self._classes is None:
                        raise ValueError("classes must be provided to pack unfitted "
                                         "classifiers (pass classes= to fit)")
                    m._set_classes(self._classes)
            if isinstance(y, ShardedRows) and isinstance(X, ShardedRows):
                targets = m0._encode_targets_device(y.data, y.mask)
            else:
                targets = m0._encode_targets(np.asarray(y))
        else:
            targets = m0._targets(y, X)
        xb, yb, mask = m0._prep_block(X, targets)
        for m in self.models:
            m._ensure_state(xb.shape[1], xb.device)
        n_real = m0._n_real(X)
        if with_weights and any(getattr(m, "class_weight", None) is not None
                                for m in self.models):
            masks = torch.stack([
                m._apply_weights(yb, mask, None, n_real, allow_balanced=False)
                if getattr(m, "class_weight", None) is not None else mask
                for m in self.models])
        else:
            masks = mask[None, :].expand(len(self.models), mask.shape[0])
        return xb, yb, masks, mask

    def _stack(self, device):
        states = [m._state for m in self.models]
        stacked = {k: torch.stack([s[k] for s in states]) for k in ("coef", "intercept", "t")}
        hypers = torch.stack([m._hyper(device) for m in self.models])
        return stacked, hypers

    def _advance(self, xb, yb, masks):
        """One K5 launch on the prepared block (the stack made at the first
        one), and the books."""
        if self._stacked is None:
            self._stacked, self._hypers = self._stack(xb.device)
        m0, s = self._m0, self._stacked
        out = k5.cohort_step(xb, yb, masks, s["coef"], s["intercept"], s["t"], self._hypers,
                             loss=m0.loss, penalty=m0.penalty, schedule=m0.learning_rate,
                             fit_intercept=m0.fit_intercept)
        self._losses = out[:, 0]
        DISPATCH_STATS["dispatches"] += 1
        DISPATCH_STATS["models_stepped"] += len(self.models)
        return self

    def step(self, X, y):
        """Advance every model of the cohort by one block: one launch."""
        xb, yb, masks, _ = self._prep(X, y)
        return self._advance(xb, yb, masks)

    def partial_fit(self, X, y=None, **kwargs):
        """The estimator's surface: a cohort takes ``(X, y)`` blocks as one
        model does (``classes`` came at construction)."""
        return self.step(X, y)

    def packed_accuracy(self, X, y):
        """Every member's accuracy on ``(X, y)`` from one product of the
        block by the stacked columns ``[d, M·K]`` and one ``(M,)`` read.
        Classifier cohorts only, and only where the members score by plain
        accuracy."""
        m0 = self._m0
        if not isinstance(m0, SGDClassifier):
            raise TypeError("packed_accuracy requires a classifier cohort")
        if type(m0).score is not SGDClassifier.score:
            raise TypeError("cohort models override score(); packed accuracy would "
                            "silently replace their metric")
        # accuracy is unweighted: score with the plain validity mask
        xb, yb, _, mask = self._prep(X, y, with_weights=False)
        if self._stacked is None:
            self._stacked, self._hypers = self._stack(xb.device)
        coef, b = self._stacked["coef"], self._stacked["intercept"]
        M, d, K = coef.shape
        margins = (xb @ coef.permute(1, 0, 2).reshape(d, M * K) + b.reshape(M * K)).view(-1, M, K)
        if K == 1:
            y_idx = (yb[:, 0] > 0).to(torch.int64)
            pred = (margins[:, :, 0] > 0).to(torch.int64)
        else:
            y_idx = torch.argmax(yb, dim=1)
            pred = torch.argmax(margins, dim=2)
        hit = (pred == y_idx[:, None]).to(torch.float32) * mask[:, None]
        accs = torch.sum(hit, dim=0) / safe_denominator(torch.sum(mask))
        DISPATCH_STATS["score_dispatches"] += 1
        return accs.cpu().numpy()

    def finalize(self):
        """Give each model its slice of the stack (views, no copy)."""
        if self._stacked is None:
            return self.models
        parts = {k: v.unbind(0) for k, v in self._stacked.items()}
        losses = self._losses.unbind(0) if self._losses is not None else None
        for i, m in enumerate(self.models):
            m._state = {k: parts[k][i] for k in parts}
            if losses is not None:
                m._loss_ = losses[i]
        self._stacked = None
        DISPATCH_STATS["cohorts"] += 1
        return self.models
