"""``SGDClassifier`` and ``SGDRegressor``: the port of
``dask_ml_tpu/linear_model/_sgd.py``.

The state (``coef`` ``[d, K]``, ``intercept`` ``[K]``, the step count ``t``)
lives on the device as a dict of tensors.  ``partial_fit`` is one minibatch
gradient step over the whole block through K4 (``ops/sgd.py``,
``csrc/sgd.cu``): one read of the block, the update made in place, and no
host read in the step.  ``fit`` runs one full-batch step an epoch, or with
``batch_size`` one step a minibatch of the padded rows, minibatch ``i``
the rows ``i::n_mb`` (the reference's stride interleave, read where they
lie), all of an epoch's steps in one launch of K4's epoch.  Multi-class
is one-vs-all in one ``[d, K]`` matrix; binary keeps one column with ±1
targets.  Host blocks are padded to the bucket ladder
(``programs/bucket.py``) as in the reference, so both packages step on the
same padded shapes.

By design the held-out split of ``early_stopping`` is drawn from a
``torch.Generator`` (:func:`_validation_split`), where the reference draws
from ``jax.random``.  Not ported yet, and raising ``NotImplementedError``:
``fit_checkpoint`` ([port-planes]), a bfloat16 X (bf16 K4), and the staged
prefetch protocol (``_pf_stage``, compile-ahead), which is the second slice
of [port-stream].
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from ..base import ClassifierMixin, RegressorMixin, TorchEstimator
from ..core.mesh import get_device, get_n_shards
from ..core.prng import as_generator
from ..core.sharded import ShardedRows, as_sharded, unshard
from ..ops import sgd as k4
from ..programs import DEFAULT_BUCKETS, pad_block
from ..utils import check_max_iter, safe_denominator

__all__ = ["SGDClassifier", "SGDRegressor"]

#: default streaming block size: a bucket rung, so default-chunk streams
#: pad no rows
DEFAULT_STREAM_CHUNK = DEFAULT_BUCKETS[3]

_CLS_LOSSES = k4.CLASSIFIER_LOSSES
_REG_LOSSES = ("squared_error", "huber")
_PENALTIES = ("l2", "l1", "elasticnet", None)
_SCHEDULES = ("constant", "optimal", "invscaling", "adaptive")
_HYPER_KEYS = k4.HYPER_KEYS


def _not_ported(what, item):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: {item})")


def sgd_init(n_features: int, n_outputs: int, device=None):
    """A fresh state on ``device`` (default: the active one): K = n_classes
    one-vs-all columns, 1 for binary and for regression."""
    device = torch.device(device) if device is not None else get_device()
    return {
        "coef": torch.zeros((n_features, n_outputs), dtype=torch.float32, device=device),
        "intercept": torch.zeros((n_outputs,), dtype=torch.float32, device=device),
        "t": torch.zeros((), dtype=torch.float32, device=device),
    }


def sgd_step(state, xb, yb, mask, hyper, *, loss, penalty, schedule, fit_intercept=True,
             out=None):
    """One minibatch step through K4, the state updated in place; returns
    ``(state, mean_loss)`` with ``mean_loss`` a 0-d device tensor (a view of
    ``out``'s first element; ``out[1]`` is Σ mask)."""
    out = k4.sgd_update(xb, yb, mask, state["coef"], state["intercept"], state["t"], hyper,
                        loss=loss, penalty=penalty, schedule=schedule,
                        fit_intercept=fit_intercept, out=out)
    return state, out[0]


def sgd_epoch(state, xs, ys, ms, hyper, *, loss, penalty, schedule, fit_intercept=True):
    """One epoch: a step for each minibatch ``i`` of stacks ``(B, n_mb, ...)``
    (the strided views ``xs[:, i]``, no copy), in order, through K4's epoch
    (one launch an epoch on the card; one minibatch is a plain step).
    Returns ``(state, epoch loss)``, the steps' losses weighted by their
    real row counts, on the device."""
    n_mb = xs.shape[1]
    outs = torch.empty((n_mb, 2), dtype=torch.float32, device=xs.device)
    kw = dict(loss=loss, penalty=penalty, schedule=schedule, fit_intercept=fit_intercept)
    if n_mb == 1:
        sgd_step(state, xs[:, 0], ys[:, 0], ms[:, 0], hyper, out=outs[0], **kw)
    else:
        k4.sgd_epoch(xs, ys, ms, state["coef"], state["intercept"], state["t"], hyper, out=outs,
                     **kw)
    losses, counts = outs[:, 0], outs[:, 1]
    return state, torch.sum(losses * counts) / safe_denominator(torch.sum(counts))


def _eval_loss_fn(state, xb, yb, mask, hyper, *, loss):
    """Masked mean loss of the current state over ``mask`` rows (the
    held-out loss of ``early_stopping``), through K4's value-only variant."""
    return k4.sgd_loss(xb, yb, mask, state["coef"], state["intercept"], hyper, loss=loss)[0]


def _row_shard_count(X) -> int:
    """The logical row-shard count of a block: the active one for a
    ``ShardedRows``, 1 for a host block (the reference's sharding of the
    device array it steps on)."""
    return get_n_shards() if isinstance(X, ShardedRows) else 1


def _minibatch_views(est, xb, yb, mask, n_real=None, n_shards=1):
    """(xs, ys, ms) minibatch stacks ``(B, n_mb, ...)`` for ``fit``, or None
    for the full-batch path: the reference's rule, minibatch ``i`` the rows
    ``i::n_mb``, ``n_mb`` at most the real row count and clamped to a
    divisor of the per-shard row count."""
    bs = getattr(est, "batch_size", None)
    n_pad = int(xb.shape[0])
    if bs is None:
        return None
    bs = int(bs)
    if bs >= (int(n_real) if n_real is not None else n_pad):
        return None
    local = n_pad // max(int(n_shards), 1)
    n_mb = max(n_pad // bs, 1)
    if n_real is not None:
        n_mb = min(n_mb, int(n_real))
    while n_mb > 1 and local % n_mb:
        n_mb -= 1
    if n_mb <= 1:
        return None
    B = n_pad // n_mb
    return (xb.reshape(B, n_mb, *xb.shape[1:]), yb.reshape(B, n_mb, *yb.shape[1:]),
            mask.reshape(B, n_mb))


class EpochStopper:
    """sklearn's stopping rule: stop once ``patience`` consecutive epochs
    fail to improve the best loss by ``tol``; inactive with ``tol=None``."""

    def __init__(self, tol, patience: int = 5):
        self.tol = tol
        self.patience = patience
        self.best = np.inf
        self.bad = 0

    @property
    def active(self) -> bool:
        return self.tol is not None

    def update(self, cur: float) -> bool:
        if not self.active:
            return False
        if cur > self.best - self.tol:
            self.bad += 1
            if self.bad >= self.patience:
                return True
        else:
            self.bad = 0
        self.best = min(self.best, cur)
        return False

    def reset_patience(self) -> None:
        """Clear the no-improvement count and keep the best loss (the
        adaptive schedule's eta/5 rule)."""
        self.bad = 0


def _validation_split(n, random_state, device):
    """Uniform draws ``(n,)`` on ``device`` from ``random_state``: a row is
    held out when its draw is below ``validation_fraction``."""
    return torch.rand(n, generator=as_generator(random_state, device), device=device)


def _run_epochs(est, xb, yb, mask, n_real=None, n_shards=1) -> int:
    """The epoch loop of ``fit``: one full-batch step an epoch, or one
    ``sgd_epoch`` of minibatch steps with ``batch_size``.  The epoch loss is
    read on the host only while a ``tol`` is active.  ``early_stopping``
    holds out rows by mask and stops on their masked mean loss; the
    ``adaptive`` schedule divides eta by 5 on each plateau until it falls
    below 1e-6."""
    check_max_iter(est.max_iter)
    if getattr(est, "fit_checkpoint", None) is not None:
        raise _not_ported("fit_checkpoint", "[port-planes] resilience/")
    hyper = est._hyper(xb.device)
    eta_scale = np.float32(1.0)
    adaptive = est.learning_rate == "adaptive"
    early = bool(getattr(est, "early_stopping", False))
    train_mask, val_mask = mask, None
    if early:
        frac = float(getattr(est, "validation_fraction", 0.1))
        sel = (_validation_split(xb.shape[0], getattr(est, "random_state", None), xb.device)
               < frac).to(mask.dtype)
        val_mask = mask * sel
        train_mask = mask * (1.0 - sel)
        if float(torch.sum(val_mask)) == 0.0:  # degenerate tiny input
            early, train_mask, val_mask = False, mask, None
    stop = EpochStopper(est.tol, getattr(est, "n_iter_no_change", 5))
    views = _minibatch_views(est, xb, yb, train_mask, n_real, n_shards)
    n_iter = est.max_iter
    for epoch in range(est.max_iter):
        if views is not None:
            xs, ys, ms = views
            est._state, loss = sgd_epoch(est._state, xs, ys, ms, hyper, loss=est.loss,
                                         penalty=est.penalty, schedule=est.learning_rate,
                                         fit_intercept=est.fit_intercept)
        else:
            loss = est._step_block(xb, yb, train_mask, hyper)
        if not stop.active:
            continue
        monitor = (_eval_loss_fn(est._state, xb, yb, val_mask, hyper, loss=est.loss)
                   if early else loss)
        if stop.update(float(monitor)):
            if not adaptive:
                n_iter = epoch + 1
                break
            new_scale = np.float32(eta_scale / np.float32(5.0))
            if float(new_scale) * float(np.float32(est.eta0)) < 1e-6:
                n_iter = epoch + 1
                break
            eta_scale = new_scale
            hyper = hyper.clone()
            hyper[_HYPER_KEYS.index("eta_scale")] = float(new_scale)
            stop.reset_patience()
    return n_iter


class _BaseSGD(TorchEstimator):
    """Shared plumbing: ingest and pad blocks, drive K4."""

    def _hyper(self, device=None):
        """The hyperparameters as one float32 device tensor, uploaded once
        for a set of values and a device (a ``set_params`` changes the key)."""
        device = torch.device(device) if device is not None else self._device()
        eta0 = float(self.eta0)
        alpha = float(self.alpha)
        if self.learning_rate == "optimal" and eta0 <= 0:
            eta0 = 1.0
        t0 = 1.0 / (alpha * eta0) if alpha > 0 and eta0 > 0 else 1.0
        values = (alpha, float(self.eta0), float(getattr(self, "power_t", 0.25)), t0,
                  float(getattr(self, "l1_ratio", 0.15)), float(getattr(self, "epsilon", 0.1)),
                  1.0)
        key = (values, device)
        cached = getattr(self, "_hyper_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        hyper = torch.tensor(values, dtype=torch.float32, device=device)
        self._hyper_cache = (key, hyper)
        return hyper

    def _device(self):
        state = getattr(self, "_state", None)
        return state["coef"].device if state is not None else get_device()

    def _validate(self):
        bs = getattr(self, "batch_size", None)
        if bs is not None and (not isinstance(bs, numbers.Integral) or int(bs) < 1):
            raise ValueError(f"batch_size must be a positive int or None; got {bs!r}")
        if getattr(self, "early_stopping", False):
            vf = float(getattr(self, "validation_fraction", 0.1))
            if not 0.0 < vf < 1.0:
                raise ValueError(f"validation_fraction must be in (0, 1); got {vf}")
            if self.tol is None:
                raise ValueError("early_stopping requires a tol (the stopping rule "
                                 "compares held-out losses against it)")
        if self.penalty not in _PENALTIES:
            raise ValueError(f"penalty must be one of {_PENALTIES}")
        if self.learning_rate not in _SCHEDULES:
            raise ValueError(f"learning_rate must be one of {_SCHEDULES}")
        if self.learning_rate == "optimal" and not float(self.alpha) > 0:
            raise ValueError("alpha must be > 0 with learning_rate='optimal' "
                             "(the schedule is eta = 1/(alpha*(t0+t)))")

    def _prep_block(self, X, targets):
        """Block → (xb, yb, mask) on the device.  A ``ShardedRows`` X steps
        where it lies with its own mask (host targets are padded to its rows
        and uploaded); a host X goes through :meth:`_prep_block_host`."""
        if isinstance(X, ShardedRows):
            xd = X.data
            if xd.dtype == torch.bfloat16:
                raise _not_ported("SGD on a bfloat16 X", "bf16 K4")
            if xd.dtype != torch.float32:
                xd = xd.to(torch.float32)
            if isinstance(targets, torch.Tensor):
                return xd, targets, X.mask
            t = np.asarray(targets, np.float32)
            if t.shape[0] != xd.shape[0]:
                t = np.concatenate([t, np.zeros((xd.shape[0] - t.shape[0], t.shape[1]),
                                                np.float32)])
            return xd, torch.from_numpy(t).to(xd.device), X.mask
        return self._prep_block_host(X, targets)

    def _prep_block_host(self, X, targets):
        """Bucket-pad a host block and upload it to the estimator's device."""
        X, targets, mask = pad_block(np.asarray(X, dtype=np.float32),
                                     np.asarray(targets, dtype=np.float32))
        device = self._device()
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (X, targets, mask))

    def _step_block(self, xb, yb, mask, hyper=None):
        _, loss = sgd_step(self._state, xb, yb, mask,
                           self._hyper(xb.device) if hyper is None else hyper,
                           loss=self.loss, penalty=self.penalty, schedule=self.learning_rate,
                           fit_intercept=self.fit_intercept)
        return loss

    def _pf_consume(self, staged):
        """The device step on a prepared block ``(xb, yb, mask)``: the shared
        tail of ``partial_fit``.  ``_loss_`` is the block's mean loss, a 0-d
        device tensor."""
        xb, yb, mask = staged
        self._ensure_state(xb.shape[1], xb.device)
        self._loss_ = self._step_block(xb, yb, mask)
        return self

    @staticmethod
    def _n_real(X) -> int:
        return X.n_samples if isinstance(X, ShardedRows) else int(np.asarray(X).shape[0])

    def _linear(self, X):
        """x·coef + intercept for the real rows of X (a plain product)."""
        coef, b = self._state["coef"], self._state["intercept"]
        if isinstance(X, ShardedRows):
            return (X.data.to(torch.float32) @ coef + b)[: X.n_samples]
        if isinstance(X, torch.Tensor):
            return X.to(device=coef.device, dtype=torch.float32) @ coef + b
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(X, np.float32)))
        return x.to(coef.device) @ coef + b

    @property
    def t_(self):
        return float(self._state["t"]) if hasattr(self, "_state") else 0.0


class SGDClassifier(ClassifierMixin, _BaseSGD):
    """Linear classifier trained by minibatch SGD, its state on the device.

    One-vs-all over ``classes_`` in one coefficient matrix; binary keeps one
    column (±1 targets).  Reference counterpart: the JAX package's
    ``SGDClassifier``.
    """

    def __init__(self, loss="log_loss", penalty="l2", alpha=1e-4, l1_ratio=0.15,
                 fit_intercept=True, max_iter=1000, tol=1e-3, learning_rate="optimal",
                 eta0=0.01, power_t=0.25, n_iter_no_change=5, random_state=None,
                 warm_start=False, class_weight=None, batch_size=None, early_stopping=False,
                 validation_fraction=0.1, fit_checkpoint=None):
        self.class_weight = class_weight
        self.batch_size = batch_size
        self.early_stopping = early_stopping
        self.validation_fraction = validation_fraction
        self.fit_checkpoint = fit_checkpoint
        self.loss = loss
        self.penalty = penalty
        self.alpha = alpha
        self.l1_ratio = l1_ratio
        self.fit_intercept = fit_intercept
        self.max_iter = max_iter
        self.tol = tol
        self.learning_rate = learning_rate
        self.eta0 = eta0
        self.power_t = power_t
        self.n_iter_no_change = n_iter_no_change
        self.random_state = random_state
        self.warm_start = warm_start

    def _validate(self):
        super()._validate()
        if self.loss not in _CLS_LOSSES:
            raise ValueError(f"loss must be one of {_CLS_LOSSES}")

    def _set_classes(self, classes):
        classes = np.sort(np.asarray(classes))
        if len(classes) < 2:
            raise ValueError(
                f"classifier needs samples of at least 2 classes; got {classes.tolist()}")
        self.classes_ = classes

    def _encode_targets(self, y):
        """Labels → ±1 one-vs-all float matrix ``[n, K]`` (K=1 binary)."""
        y = np.asarray(y).ravel()
        idx = np.searchsorted(self.classes_, y)
        if (idx >= len(self.classes_)).any() or (self.classes_[idx] != y).any():
            raise ValueError("y contains labels not in `classes`")
        if len(self.classes_) == 2:
            return np.where(idx == 1, 1.0, -1.0).astype(np.float32)[:, None]
        out = -np.ones((y.shape[0], len(self.classes_)), dtype=np.float32)
        out[np.arange(y.shape[0]), idx] = 1.0
        return out

    def _encode_targets_device(self, ydata, mask):
        """Device twin of :meth:`_encode_targets`: labels stay on the device;
        pad rows (mask 0) are exempt from the label check, whose one scalar
        is read on the host."""
        key = (ydata.device, ydata.dtype, self.classes_.tobytes())
        cached = getattr(self, "_classes_cache", None)
        if cached is None or cached[0] != key:  # uploaded once, not once a block
            cached = (key, torch.from_numpy(np.asarray(self.classes_)).to(device=ydata.device,
                                                                          dtype=ydata.dtype))
            self._classes_cache = cached
        classes = cached[1]
        k = len(self.classes_)
        idx = torch.clamp(torch.searchsorted(classes, ydata), 0, k - 1)
        bad = torch.sum((classes[idx] != ydata).to(torch.float32) * (mask > 0))
        if float(bad) > 0:
            raise ValueError("y contains labels not in `classes`")
        if k == 2:
            return torch.where(idx == 1, 1.0, -1.0)[:, None].to(torch.float32)
        return (2.0 * torch.nn.functional.one_hot(idx, k) - 1.0).to(torch.float32)

    def _ensure_state(self, n_features: int, device=None):
        if not hasattr(self, "_state"):
            k = 1 if len(self.classes_) == 2 else len(self.classes_)
            self._state = sgd_init(n_features, k, device)
            self.n_features_in_ = int(n_features)

    def _apply_weights(self, yb, mask, sample_weight, n_real, allow_balanced=True):
        """Fold sample and class weights into the block mask (the mask is
        each row's weight in every masked sum); the class index comes back
        from the ±1 target matrix."""
        cwd = getattr(self, "class_weight", None)
        if sample_weight is None and cwd is None:
            return mask
        from ..utils import _check_class_weight_keys, effective_mask

        idx = classes = None
        if cwd is not None:
            if isinstance(cwd, str) and cwd == "balanced" and not allow_balanced:
                raise ValueError("class_weight 'balanced' is not supported for partial_fit")
            if isinstance(cwd, dict):
                _check_class_weight_keys(cwd, self.classes_)
                cwd = {i: float(cwd.get(c, 1.0)) for i, c in enumerate(self.classes_.tolist())}
            if yb.shape[1] == 1:
                idx = (yb[:, 0] > 0).to(torch.float32)
            else:
                idx = torch.argmax(yb, dim=1).to(torch.float32)
            classes = np.arange(len(self.classes_))
        return effective_mask(mask, idx, sample_weight=sample_weight, class_weight=cwd,
                              classes=classes, n_samples=n_real)

    def partial_fit(self, X, y, classes=None, sample_weight=None, **kwargs):
        self._validate()
        if not hasattr(self, "classes_"):
            if classes is None:
                raise ValueError("classes must be passed on the first partial_fit call")
            self._set_classes(classes)
        X, y = as_sharded(X), as_sharded(y)
        if isinstance(y, ShardedRows):
            if isinstance(X, ShardedRows):
                targets = self._encode_targets_device(y.data, y.mask)
            else:
                targets = self._encode_targets(unshard(y))
        else:
            targets = self._encode_targets(np.asarray(y))
        xb, yb, mask = self._prep_block(X, targets)
        mask = self._apply_weights(yb, mask, sample_weight, self._n_real(X),
                                   allow_balanced=False)
        return self._pf_consume((xb, yb, mask))

    def fit(self, X, y, sample_weight=None, **kwargs):
        self._validate()
        X = as_sharded(X)
        y = unshard(as_sharded(y)) if isinstance(y, (ShardedRows, torch.Tensor)) else y
        y = np.asarray(y)
        if self.warm_start and hasattr(self, "classes_"):
            extra = np.setdiff1d(np.unique(y), self.classes_)
            if extra.size:
                raise ValueError(f"warm_start refit saw labels {extra.tolist()} not in "
                                 f"the fitted classes_ {self.classes_.tolist()}")
        else:
            for attr in ("_state", "classes_"):
                if hasattr(self, attr):
                    delattr(self, attr)
            self._set_classes(np.unique(y))
        xb, yb, mask = self._prep_block(X, self._encode_targets(y))
        mask = self._apply_weights(yb, mask, sample_weight, len(y))
        self._ensure_state(xb.shape[1], xb.device)
        self.n_iter_ = _run_epochs(self, xb, yb, mask, n_real=len(y),
                                   n_shards=_row_shard_count(X))
        return self

    def decision_function(self, X):
        m = self._linear(X)
        return m[:, 0] if m.shape[1] == 1 else m

    def _pred_idx(self, m):
        return (m[:, 0] > 0).to(torch.int64) if m.shape[1] == 1 else torch.argmax(m, dim=1)

    def predict(self, X):
        return self.classes_[self._pred_idx(self._linear(X)).cpu().numpy()]

    def predict_proba(self, X):
        if self.loss not in ("log_loss", "modified_huber"):
            raise AttributeError(
                f"probability estimates are not available for loss={self.loss!r}")
        m = self._linear(X)
        if self.loss == "modified_huber":
            p = (torch.clamp(m, -1.0, 1.0) + 1.0) / 2.0
        else:
            p = torch.sigmoid(m)
        if m.shape[1] == 1:
            return torch.stack([1.0 - p[:, 0], p[:, 0]], dim=1)
        z = torch.sum(p, dim=1, keepdim=True)
        if self.loss == "modified_huber":
            # rows with every class clipped to -1 are uniform
            return torch.where(z > 0, p / torch.where(z > 0, z, 1.0), 1.0 / p.shape[1])
        return p / z

    def predict_log_proba(self, X):
        return torch.log(self.predict_proba(X))

    @property
    def coef_(self):
        return self._state["coef"].T.cpu().numpy()  # (K, d), (1, d) binary

    @property
    def intercept_(self):
        return self._state["intercept"].cpu().numpy()

    def score(self, X, y, sample_weight=None):
        """Mean accuracy; all-device inputs read one scalar."""
        from ..metrics.classification import accuracy_score
        from ..utils import classes_f32_exact, masked_device_accuracy

        X, y = as_sharded(X), as_sharded(y)
        if sample_weight is not None:
            if isinstance(y, ShardedRows):
                return float(accuracy_score(y, self.predict(X), sample_weight=sample_weight))
            hits = self.predict(X) == np.asarray(y)
            return float(np.average(hits, weights=np.asarray(sample_weight)))
        if (isinstance(X, ShardedRows) and isinstance(y, ShardedRows)
                and classes_f32_exact(self.classes_)):
            coef, b = self._state["coef"], self._state["intercept"]
            idx = self._pred_idx(X.data.to(torch.float32) @ coef + b)
            return masked_device_accuracy(idx, y.data, X.mask, self.classes_)
        return accuracy_score(y, self.predict(X))


class SGDRegressor(RegressorMixin, _BaseSGD):
    """Linear regressor trained by minibatch SGD on the device."""

    def __init__(self, loss="squared_error", penalty="l2", alpha=1e-4, l1_ratio=0.15,
                 fit_intercept=True, max_iter=1000, tol=1e-3, learning_rate="invscaling",
                 eta0=0.01, power_t=0.25, epsilon=0.1, n_iter_no_change=5, random_state=None,
                 warm_start=False, batch_size=None, early_stopping=False,
                 validation_fraction=0.1, fit_checkpoint=None):
        self.batch_size = batch_size
        self.early_stopping = early_stopping
        self.validation_fraction = validation_fraction
        self.fit_checkpoint = fit_checkpoint
        self.loss = loss
        self.penalty = penalty
        self.alpha = alpha
        self.l1_ratio = l1_ratio
        self.fit_intercept = fit_intercept
        self.max_iter = max_iter
        self.tol = tol
        self.learning_rate = learning_rate
        self.eta0 = eta0
        self.power_t = power_t
        self.epsilon = epsilon
        self.n_iter_no_change = n_iter_no_change
        self.random_state = random_state
        self.warm_start = warm_start

    def _validate(self):
        super()._validate()
        if self.loss not in _REG_LOSSES:
            raise ValueError(f"loss must be one of {_REG_LOSSES}")

    def _targets(self, y, X=None):
        y = as_sharded(y)
        if isinstance(y, ShardedRows):
            if isinstance(X, ShardedRows):
                return y.data.to(torch.float32).reshape(-1, 1)
            y = unshard(y)
        return np.asarray(y, dtype=np.float32).reshape(-1, 1)

    def _ensure_state(self, n_features: int, device=None):
        if not hasattr(self, "_state"):
            self._state = sgd_init(n_features, 1, device)
            self.n_features_in_ = int(n_features)

    def _weighted_mask(self, X, mask, sample_weight):
        if sample_weight is None:
            return mask
        from ..utils import effective_mask

        return effective_mask(mask, sample_weight=sample_weight, n_samples=self._n_real(X))

    def partial_fit(self, X, y, sample_weight=None, **kwargs):
        self._validate()
        X = as_sharded(X)
        xb, yb, mask = self._prep_block(X, self._targets(y, X))
        mask = self._weighted_mask(X, mask, sample_weight)
        return self._pf_consume((xb, yb, mask))

    def fit(self, X, y, sample_weight=None, **kwargs):
        self._validate()
        if not self.warm_start and hasattr(self, "_state"):
            delattr(self, "_state")
        X = as_sharded(X)
        xb, yb, mask = self._prep_block(X, self._targets(y, X))
        mask = self._weighted_mask(X, mask, sample_weight)
        self._ensure_state(xb.shape[1], xb.device)
        self.n_iter_ = _run_epochs(self, xb, yb, mask, n_real=self._n_real(X),
                                   n_shards=_row_shard_count(X))
        return self

    def predict(self, X):
        return self._linear(X)[:, 0]

    @property
    def coef_(self):
        return self._state["coef"][:, 0].cpu().numpy()

    @property
    def intercept_(self):
        return self._state["intercept"].cpu().numpy()

    def score(self, X, y, sample_weight=None):
        from ..metrics.regression import r2_score

        X, y = as_sharded(X), as_sharded(y)
        return r2_score(y, self.predict(X), sample_weight=sample_weight)
