"""Classification metrics: the port of ``dask_ml_tpu/metrics/classification.py``
for torch tensors (reference: ``dask_ml/metrics/classification.py``).

Each metric is a masked reduction over the padded rows, with sample
weights.  Counts and prefix sums are taken in float64 on the device, where
the reference chunks its float32 sums and combines them in float64 on the
host (a float32 sum stops counting past 2^24); only class inventories and
the results are read back.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..core.sharded import ShardedRows
from .regression import _apply_weight, _device, _lengths


class UndefinedMetricWarning(UserWarning):
    """A metric is undefined on its input and scored 0 (scikit-learn's
    warning of the same name)."""


def _as_tensor(a, device):
    """Labels as a tensor on ``device``, keeping their numeric type."""
    if isinstance(a, ShardedRows):
        a = a.data
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return a.to(device)


def _align(y_true, y_pred):
    """(true, pred, mask) of one padded length on one device: a plain side
    is zero-padded up to a ShardedRows side's padded length."""
    n_t, pad_t = _lengths(y_true)
    n_p, pad_p = _lengths(y_pred)
    if n_t != n_p:
        raise ValueError(f"y_true and y_pred have different lengths: {n_t} vs {n_p}")
    padded = max(pad_t, pad_p)
    device = _device(y_pred, y_true)

    def to_padded(a):
        x = _as_tensor(a, device)
        if x.shape[0] < padded:
            x = torch.cat([x, x.new_zeros((padded - x.shape[0],) + tuple(x.shape[1:]))])
        return x

    if isinstance(y_true, ShardedRows) and pad_t == padded:
        mask = y_true.mask.to(device)
    elif isinstance(y_pred, ShardedRows) and pad_p == padded:
        mask = y_pred.mask.to(device)
    else:
        mask = torch.ones(padded, dtype=torch.float32, device=device)
    return to_padded(y_true), to_padded(y_pred), mask


def accuracy_score(y_true, y_pred, normalize: bool = True, sample_weight=None, compute=True):
    """Fraction (or weighted count) of correct predictions."""
    t, p, mask = _align(y_true, y_pred)
    w = _apply_weight(mask, sample_weight)
    hits = torch.sum((t == p).to(torch.float32) * w)
    result = hits / torch.sum(w) if normalize else hits
    return float(result) if compute else result


def _auto_eps(y_pred):
    """The machine epsilon of the input's floating type, read without moving
    its data; float64's for a non-float input."""
    a = y_pred.data if isinstance(y_pred, ShardedRows) else y_pred
    if isinstance(a, torch.Tensor):
        return float(torch.finfo(a.dtype if a.is_floating_point() else torch.float64).eps)
    dtype = np.asarray(a).dtype
    return float(np.finfo(dtype if np.issubdtype(dtype, np.floating) else np.float64).eps)


def log_loss(y_true, y_pred, eps="auto", normalize: bool = True, sample_weight=None, labels=None):
    """Negative log-likelihood of probabilistic predictions: ``y_pred`` is
    (n, k) probabilities or (n,) the positive class's.  ``eps="auto"``
    clips at the input's machine epsilon (float64's for a non-float
    input), computed in the input's floating type."""
    if eps == "auto":
        eps = _auto_eps(y_pred)
    t, p, mask = _align(y_true, y_pred)
    if not p.is_floating_point():
        p = p.to(torch.float64)
    w = _apply_weight(mask, sample_weight).to(p.dtype)
    p = torch.clamp(p, eps, 1.0 - eps)
    if p.ndim == 1:
        t = t.to(p.dtype)
        per = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))
    else:
        n_classes = p.shape[1]
        if labels is not None:
            labels = np.sort(np.asarray(labels))
            present = torch.unique(torch.where(mask > 0, t, t[0])).cpu().numpy()
            unseen = np.setdiff1d(present, labels)
            if unseen.size:
                raise ValueError(f"y_true contains labels not in `labels`: {unseen.tolist()}")
            t = torch.searchsorted(torch.from_numpy(labels).to(device=t.device, dtype=t.dtype),
                                   t.contiguous())
        # JAX's one_hot: a label outside [0, n_classes) is a row of zeros
        onehot = (t.to(torch.int64)[:, None]
                  == torch.arange(n_classes, device=t.device)).to(p.dtype)
        p = p / torch.sum(p, dim=1, keepdim=True)
        per = -torch.sum(onehot * torch.log(p), dim=1)
    total = torch.sum(per * w)
    return float(total / torch.sum(w)) if normalize else float(total)


def _class_inventory(t, p, mask, labels):
    """Sorted class values for the count-based metrics: ``labels`` as given
    (their order is ``average=None``'s output order), else the union of the
    real rows' true and predicted values (only the unique values are read)."""
    if labels is not None:
        return np.asarray(labels)
    fill = t[0]
    tv = torch.where(mask > 0, t, fill)
    pv = torch.where(mask > 0, p, fill.to(p.dtype))
    return np.union1d(torch.unique(tv).cpu().numpy(), torch.unique(pv).cpu().numpy())


def _class_index(v, classes, dtype):
    """(index into ``classes``, whether v is that class) for each row, with
    the classes in ``dtype`` (the true labels' type) and compared in the
    promoted type; a value outside ``classes`` is in no class."""
    k = len(classes)
    order = np.argsort(classes, kind="stable")
    common = torch.promote_types(dtype, v.dtype)
    sorted_cls = torch.from_numpy(np.asarray(classes)[order]).to(v.device, dtype).to(common)
    v = v.to(common).contiguous()
    pos = torch.clamp(torch.searchsorted(sorted_cls, v), 0, k - 1)
    return torch.from_numpy(order).to(v.device)[pos], sorted_cls[pos] == v


def _prf_counts(y_true, y_pred, sample_weight, labels):
    """Per-class (tp, predicted positives, true positives), weighted, in
    float64 on the device; each row counts once for its true and once for
    its predicted class (the reference's one-hot products)."""
    t, p, mask = _align(y_true, y_pred)
    w = _apply_weight(mask, sample_weight).to(torch.float64)
    classes = _class_inventory(t, p, mask, labels)
    k = len(classes)
    ti, t_in = _class_index(t, classes, t.dtype)
    pi, p_in = _class_index(p, classes, t.dtype)
    zeros = torch.zeros(k, dtype=torch.float64, device=t.device)
    tp = zeros.index_add(0, ti, w * (t_in & p_in & (ti == pi)))
    pred_pos = zeros.index_add(0, pi, w * p_in)
    true_pos = zeros.index_add(0, ti, w * t_in)
    sums = torch.stack([tp, pred_pos, true_pos]).cpu().numpy()
    return classes, sums[0], sums[1], sums[2]


def _prf(y_true, y_pred, *, average, sample_weight, labels, pos_label, beta=1.0):
    classes, tp, pp, tpos = _prf_counts(y_true, y_pred, sample_weight, labels)

    def safe(num, den):
        return np.where(den > 0, num / np.maximum(den, 1e-30), 0.0)

    prec = safe(tp, pp)
    rec = safe(tp, tpos)
    b2 = beta * beta
    f = safe((1 + b2) * prec * rec, b2 * prec + rec)
    if average == "binary":
        if len(classes) > 2:
            raise ValueError(
                "Target is multiclass but average='binary'; choose average from "
                "{'micro', 'macro', 'weighted', None} "
                f"(observed labels: {classes.tolist()})")
        where = np.flatnonzero(classes == pos_label)
        if where.size == 0:
            if labels is not None:
                raise ValueError(f"pos_label={pos_label!r} is not a valid label: "
                                 f"{classes.tolist()}")
            # scikit-learn's rule: an absent pos_label scores 0 with a warning
            warnings.warn(f"pos_label={pos_label!r} not in observed labels "
                          f"{classes.tolist()}; scores are 0.0", UndefinedMetricWarning,
                          stacklevel=3)
            return 0.0, 0.0, 0.0
        i = int(where[0])
        return float(prec[i]), float(rec[i]), float(f[i])
    if average == "macro":
        return float(prec.mean()), float(rec.mean()), float(f.mean())
    if average == "micro":
        P = safe(tp.sum(), pp.sum())
        R = safe(tp.sum(), tpos.sum())
        F = safe((1 + b2) * P * R, b2 * P + R)
        return float(P), float(R), float(F)
    if average == "weighted":
        wts = tpos / max(tpos.sum(), 1e-30)
        return float((prec * wts).sum()), float((rec * wts).sum()), float((f * wts).sum())
    if average is None:
        return prec, rec, f
    raise ValueError(f"Unsupported average: {average!r}")


def precision_score(y_true, y_pred, *, average="binary", pos_label=1, sample_weight=None,
                    labels=None):
    """tp / (tp + fp): binary, micro, macro, weighted or per class
    (``average=None``), as scikit-learn defines it."""
    return _prf(y_true, y_pred, average=average, sample_weight=sample_weight, labels=labels,
                pos_label=pos_label)[0]


def recall_score(y_true, y_pred, *, average="binary", pos_label=1, sample_weight=None,
                 labels=None):
    """tp / (tp + fn), as scikit-learn defines it."""
    return _prf(y_true, y_pred, average=average, sample_weight=sample_weight, labels=labels,
                pos_label=pos_label)[1]


def f1_score(y_true, y_pred, *, average="binary", pos_label=1, sample_weight=None, labels=None):
    """The harmonic mean of precision and recall, as scikit-learn defines it."""
    return _prf(y_true, y_pred, average=average, sample_weight=sample_weight, labels=labels,
                pos_label=pos_label)[2]


def roc_auc_score(y_true, y_score, sample_weight=None):
    """Binary ROC AUC by the rank (Mann–Whitney U) form: one sort and two
    binary searches, exact under score ties (a tied positive and negative
    pair counts one half) and sample weights; pad rows drop out through
    their zero weight.  AUC = Σ over positives of w·(W_neg below + W_neg
    tied / 2) / (W_pos·W_neg), the prefix sums and totals in float64 on the
    device, read as one pair."""
    t, s, mask = _align(y_true, y_score)
    w = _apply_weight(mask, sample_weight).to(torch.float64)
    classes = _class_inventory(t, t, mask, None)
    if len(classes) != 2:
        raise ValueError(f"roc_auc_score needs exactly 2 classes in y_true; got "
                         f"{classes.tolist()}")
    pos = (t == torch.tensor(classes[1], dtype=t.dtype, device=t.device)).to(torch.float64)
    # the scores' own floating type: a cast would tie scores that differ
    # below the narrower resolution
    if not s.is_floating_point():
        s = s.to(torch.float32)
    s = torch.where(mask > 0, s, torch.full_like(s, -float("inf")))  # pads first, weight 0
    order = torch.argsort(s)
    s_sorted = s[order]
    wneg = (w * (1.0 - pos))[order]
    # below + tied/2 of row j = (cum[lo_j] + cum[hi_j]) / 2, cum the exclusive
    # prefix sum of the negatives' weight in score order
    cum = torch.cat([wneg.new_zeros(1), torch.cumsum(wneg, dim=0)])
    lo = torch.searchsorted(s_sorted, s, side="left")
    hi = torch.searchsorted(s_sorted, s, side="right")
    wpos = w * pos
    num = torch.sum(wpos * 0.5 * (cum[lo] + cum[hi]))
    num, denom = torch.stack([num, torch.sum(wpos) * cum[-1]]).tolist()
    if denom <= 0:
        raise ValueError("Only one class present after weighting")
    return num / denom


def confusion_matrix(y_true, y_pred, *, labels=None, sample_weight=None, normalize=None):
    """C with C[i, j] the weight of the rows of true class i predicted as
    class j, summed in float64 on the device; int64 without weights."""
    t, p, mask = _align(y_true, y_pred)
    w = _apply_weight(mask, sample_weight).to(torch.float64)
    classes = _class_inventory(t, p, mask, labels)
    k = len(classes)
    ti, t_in = _class_index(t, classes, t.dtype)
    pi, p_in = _class_index(p, classes, t.dtype)
    flat = torch.zeros(k * k, dtype=torch.float64, device=t.device)
    cm = flat.index_add(0, ti * k + pi, w * (t_in & p_in)).reshape(k, k).cpu().numpy()
    if normalize == "true":
        denom = cm.sum(axis=1, keepdims=True)
    elif normalize == "pred":
        denom = cm.sum(axis=0, keepdims=True)
    elif normalize == "all":
        denom = np.asarray(cm.sum())
    elif normalize is None:
        denom = None
    else:
        raise ValueError(f"Unsupported normalize: {normalize!r}")
    if denom is not None:
        with np.errstate(divide="ignore", invalid="ignore"):
            cm = cm / denom
        # scikit-learn zero-fills the rows and columns with no support
        return np.nan_to_num(cm)
    if sample_weight is None:
        return cm.astype(np.int64)
    return cm


def balanced_accuracy_score(y_true, y_pred, *, sample_weight=None, adjusted=False):
    """The mean recall over the classes present in ``y_true`` (a class only
    predicted does not count, as in scikit-learn)."""
    _, tp, _, tpos = _prf_counts(y_true, y_pred, sample_weight, None)
    present = tpos > 0
    if not present.any():
        raise ValueError("y_true has no represented classes")
    score = float((tp[present] / tpos[present]).mean())
    if adjusted:
        chance = 1.0 / int(present.sum())
        score = (score - chance) / (1.0 - chance)
    return score
