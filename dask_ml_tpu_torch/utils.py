"""The helpers of ``dask_ml_tpu/utils.py`` that the KMeans, GLM,
decomposition and SGD paths call, re-done for torch tensors."""

from __future__ import annotations

import contextlib
import logging
import numbers
import time

import numpy as np
import torch

from .core.sharded import ShardedRows

logger = logging.getLogger(__name__)


def check_array(array):
    """Validate 2-D numeric input like the reference's ``check_array``.

    Accepts numpy arrays, torch tensors, pandas objects and
    :class:`ShardedRows`.  A tensor is returned as it is, on its own
    device (no host transfer); other input comes back as numpy.
    """
    if isinstance(array, ShardedRows):
        if array.data.ndim != 2:
            raise ValueError(f"Expected 2D input, got ndim={array.data.ndim}")
        if array.n_samples == 0:
            raise ValueError("Found array with 0 samples")
        return array
    if hasattr(array, "to_numpy"):  # pandas
        array = array.to_numpy()
    if isinstance(array, torch.Tensor):
        numeric = array.dtype != torch.bool and not array.is_complex()
    else:
        array = np.asarray(array)
        numeric = np.issubdtype(array.dtype, np.number)
    if not numeric:
        raise ValueError(f"Expected numeric dtype, got {array.dtype}")
    if array.ndim != 2:
        raise ValueError(
            f"Expected 2D array, got ndim={array.ndim}. "
            "Reshape your data with .reshape(-1, 1) for a single feature."
        )
    if array.shape[0] == 0:
        raise ValueError("Found array with 0 samples")
    return array


def check_consistent_length(*arrays):
    """Raise where the arrays (None skipped; a ShardedRows by its true row
    count) disagree on their number of rows."""
    lengths = set()
    for a in arrays:
        if a is None:
            continue
        if isinstance(a, ShardedRows):
            n = a.n_samples
        else:
            shape = getattr(a, "shape", None)
            n = shape[0] if shape else len(a)
        lengths.add(int(n))
    if len(lengths) > 1:
        raise ValueError(f"Inconsistent sample counts: {sorted(lengths)}")


def safe_denominator(x):
    """0-safe divisor that preserves fractional weight masses: the mask
    doubles as the per-row weight, so sub-unit masses are legitimate and
    ``maximum(x, 1)`` would shrink their means."""
    return torch.where(x > 0, x, torch.ones_like(x))


def chan_merge(na, ma, m2a, nb, mb, vb):
    """Merge two (count, mean, M2) moment summaries (Chan et al. 1979), as
    the reference's ``chan_merge``: the parallel-variance update of
    ``StandardScaler.partial_fit`` (scalar count, (d,) moments) and
    ``GaussianNB.partial_fit`` ((k, 1) counts, (k, d) moments).  ``vb`` is
    the second summary's variance; returns ``(n, mean, m2)``."""
    n = na + nb
    nsafe = safe_denominator(n) if isinstance(n, torch.Tensor) else (n if n > 0 else 1.0)
    delta = mb - ma
    mean = ma + delta * (nb / nsafe)
    m2 = m2a + vb * nb + delta * delta * (na * nb / nsafe)
    return n, mean, m2


def handle_zeros_in_scale(scale):
    """Scales of (nearly) 0 become 1, so a constant feature is left as it
    is (reference: ``utils.py :: handle_zeros_in_scale``): below
    10·float eps for a vector, exactly 0 for a 0-d scale."""
    scale = torch.as_tensor(scale)
    if scale.ndim == 0:
        return torch.where(scale == 0.0, torch.ones_like(scale), scale)
    eps = 10 * torch.finfo(scale.dtype).eps
    return torch.where(torch.abs(scale) < eps, torch.ones_like(scale), scale)


def _check_class_weight_keys(class_weight, classes):
    """A dict key naming no fitted class is a typo, not a preference: raise
    as sklearn's ``compute_class_weight`` does."""
    known = set(np.asarray(classes).tolist())
    unknown = [k for k in class_weight if k not in known]
    if unknown:
        raise ValueError(
            f"class_weight keys {unknown!r} are not in the fitted classes "
            f"{sorted(known)!r}"
        )


def _check_balanced(class_weight):
    if class_weight != "balanced":
        raise ValueError(f"class_weight must be a dict or 'balanced'; got {class_weight!r}")


def effective_mask(mask, y_padded=None, *, sample_weight=None, class_weight=None,
                   classes=None, n_samples=None):
    """Fold per-row weights into a validity mask (pad rows stay at 0): the
    mask is the per-row weight of every masked reduction, so
    ``sample_weight`` and ``class_weight`` scale it.  sklearn semantics:
    ``'balanced'`` is ``n / (K·count_k)`` with unweighted counts, and a
    dict's absent classes weigh 1.0.  ``class_weight`` needs the padded
    labels ``y_padded`` (on the mask's device, numeric) and ``classes``."""
    w = mask
    if sample_weight is not None:
        if isinstance(sample_weight, torch.Tensor):
            sw = sample_weight.detach().reshape(-1).to(mask.device, torch.float32)
        else:
            sw = torch.from_numpy(
                np.asarray(sample_weight, np.float32).ravel()).to(mask.device)
        n = int(n_samples) if n_samples is not None else sw.shape[0]
        if sw.shape[0] != n:
            raise ValueError(f"sample_weight has {sw.shape[0]} entries for {n} samples")
        pad = mask.shape[0] - sw.shape[0]
        if pad < 0:
            raise ValueError(
                f"sample_weight longer ({sw.shape[0]}) than padded rows "
                f"({mask.shape[0]})"
            )
        if pad:
            sw = torch.cat([sw, sw.new_zeros(pad)])
        w = w * sw
    if class_weight is not None:
        if y_padded is None or classes is None:
            raise ValueError("class_weight requires labels and classes")
        cls_np = np.asarray(classes)
        cls = torch.as_tensor(cls_np, dtype=y_padded.dtype, device=mask.device)
        ind = (y_padded.to(mask.device)[None, :] == cls[:, None]).to(torch.float32) * mask[None, :]
        if isinstance(class_weight, str):
            _check_balanced(class_weight)
            cw = torch.sum(mask) / (len(cls_np) * safe_denominator(torch.sum(ind, dim=1)))
        else:
            _check_class_weight_keys(class_weight, cls_np)
            cw = torch.tensor([float(class_weight.get(c, 1.0)) for c in cls_np.tolist()],
                              dtype=torch.float32, device=mask.device)
        w = w * torch.sum(cw[:, None] * ind, dim=0)
    return w


def reweight_rows(X: ShardedRows, *, sample_weight=None, class_weight=None, classes=None,
                  y_padded=None) -> ShardedRows:
    """``X`` with per-row weights folded into its mask
    (:func:`effective_mask`); the same object when there are no weights."""
    if sample_weight is None and class_weight is None:
        return X
    return ShardedRows(
        data=X.data,
        mask=effective_mask(X.mask, y_padded, sample_weight=sample_weight,
                            class_weight=class_weight, classes=classes,
                            n_samples=X.n_samples),
        n_samples=X.n_samples,
    )


def host_class_weight_rows(class_weight, classes, yv):
    """Per-row class weights resolved on the host, for labels that cannot go
    to the device (strings, big ints): the twin of :func:`effective_mask`'s
    class-weight branch, with the same semantics."""
    classes = np.asarray(classes)
    yv = np.asarray(yv)
    if isinstance(class_weight, str):
        _check_balanced(class_weight)
        # counts over the full class inventory: a class absent from yv must
        # not shift the weight table
        uniq, counts_u = np.unique(yv, return_counts=True)
        counts = np.zeros(len(classes))
        counts[np.searchsorted(classes, uniq)] = counts_u
        cw = yv.shape[0] / (len(classes) * np.maximum(counts, 1.0))
    else:
        _check_class_weight_keys(class_weight, classes)
        cw = np.asarray([float(class_weight.get(c, 1.0)) for c in classes.tolist()])
    return cw[np.searchsorted(classes, yv)].astype(np.float32)


def svd_flip(u, v, u_based_decision: bool = True):
    """Deterministic SVD sign convention (reference: ``utils.py ::
    svd_flip``): each component's largest-|.| entry of ``u`` (columns) or
    ``v`` (rows) made positive.  Ties in ``argmax`` go to the first index,
    as in ``jnp.argmax``."""
    if u_based_decision:
        max_abs = torch.argmax(torch.abs(u), dim=0)
        signs = torch.sign(u[max_abs, torch.arange(u.shape[1], device=u.device)])
    else:
        max_abs = torch.argmax(torch.abs(v), dim=1)
        signs = torch.sign(v[torch.arange(v.shape[0], device=v.device), max_abs])
    return u * signs[None, :], v * signs[:, None]


def check_chunks(n_samples, n_features=None, chunks=None):
    """Rows per streamed block from a chunk spec (reference: ``utils.py ::
    check_chunks``): None (at most 16 blocks), an int, or a (rows, features)
    pair whose feature entry spans every column."""
    n_samples = int(n_samples)
    if n_samples <= 0:
        raise ValueError("n_samples must be positive")
    if chunks is None:
        return max(1, -(-n_samples // 16))
    if isinstance(chunks, numbers.Integral):
        chunks = int(chunks)
        if chunks <= 0:
            raise ValueError(f"chunks must be positive; got {chunks}")
        return chunks
    if isinstance(chunks, (tuple, list)) and len(chunks) == 2:
        rows, cols = chunks
        if n_features is not None and int(cols) != int(n_features):
            raise ValueError(
                f"column chunking is not supported; the feature chunk must span all "
                f"{n_features} columns, got {cols}")
        return check_chunks(n_samples, n_features, int(rows))
    raise ValueError(f"Unrecognized chunks: {chunks!r}")


def classes_f32_exact(classes) -> bool:
    """True when every class label survives a float32 round trip: the
    condition for comparing labels on the device."""
    classes = np.asarray(classes)
    return bool(np.issubdtype(classes.dtype, np.number)
                and np.array_equal(classes.astype(np.float32).astype(classes.dtype), classes))


def masked_device_accuracy(pred_idx, y_data, mask, classes) -> float:
    """Masked accuracy read as one scalar: ``pred_idx`` (padded n,) class
    indices and ``y_data`` (padded n,) label values on one device; a label
    outside ``classes`` is a miss.  Callers check :func:`classes_f32_exact`."""
    cls = torch.from_numpy(np.asarray(classes).astype(np.float32)).to(mask.device)
    hit = (cls[pred_idx] == y_data.to(torch.float32)).to(torch.float32) * mask
    return float(torch.sum(hit) / safe_denominator(torch.sum(mask)))


def check_max_iter(max_iter):
    """Reject an epoch budget below 1."""
    if max_iter < 1:
        raise ValueError(f"max_iter must be >= 1, got {max_iter}")


def copy_learned_attributes(from_estimator, to_estimator):
    """Copy the fitted (trailing-underscore, public) attributes across
    (reference: ``utils.py :: copy_learned_attributes``)."""
    for name, value in vars(from_estimator).items():
        if name.endswith("_") and not name.startswith("_"):
            setattr(to_estimator, name, value)
    return to_estimator


def check_random_state(random_state) -> np.random.RandomState:
    """A numpy ``RandomState`` from None, an int seed or a ``RandomState``
    (reference: ``utils.py :: check_random_state``)."""
    if random_state is None or isinstance(random_state, numbers.Integral):
        return np.random.RandomState(random_state)
    if isinstance(random_state, np.random.RandomState):
        return random_state
    raise ValueError(f"Cannot make RandomState from {random_state!r}")


@contextlib.contextmanager
def _timer(name: str, _logger=None, level=logging.INFO):
    """Log phase durations (reference: ``utils.py :: _timer``)."""
    _logger = _logger or logger
    start = time.perf_counter()
    _logger.log(level, "Starting %s", name)
    try:
        yield
    finally:
        _logger.log(level, "Finished %s in %.4fs", name,
                    time.perf_counter() - start)
