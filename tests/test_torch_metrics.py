"""The port's classification and regression metrics and its scorers
(``dask_ml_tpu_torch/metrics/``) against the JAX reference's, on the CPU,
the same seeded numpy inputs, as plain arrays and as ``ShardedRows`` at 8
shards (the reference's on its 8 virtual CPU devices).

Tolerances.  The reference computes in float32 (JAX without x64); the port
keeps a float64 input in float64 (``log_loss``) and sums its counts and
``roc_auc_score``'s prefix sums in float64.  Counts, confusion matrices
and the precision/recall/F family: equal to the reference's float64 host
sums to rtol 1e-12 (integer and dyadic weights are exact in both);
``roc_auc_score`` with ties and weights: 1e-9 of the float64 answer (the
reference combines its float32 block sums in float64); ``log_loss``: rtol
1e-6 (float32 logs); the regression metrics: rtol 1e-5 (float32 sums in
another order).
"""

import warnings

import numpy as np
import pytest
import torch

from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu.linear_model import SGDClassifier as RefSGDClassifier
from dask_ml_tpu.linear_model import SGDRegressor as RefSGDRegressor
from dask_ml_tpu.metrics import classification as ref_cls
from dask_ml_tpu.metrics import regression as ref_reg
from dask_ml_tpu.metrics import scorer as ref_scorer
from dask_ml_tpu_torch import SGDClassifier, SGDRegressor, metrics
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.metrics import classification, regression, scorer

SCORER_NAMES = ("f1", "f1_macro", "f1_micro", "f1_weighted", "precision", "precision_macro",
                "recall", "recall_macro", "roc_auc", "balanced_accuracy",
                "neg_mean_squared_error", "neg_root_mean_squared_error",
                "neg_mean_absolute_error", "neg_log_loss", "accuracy", "r2")


@pytest.fixture(autouse=True)
def _cpu():
    mesh.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    mesh.set_device(None)
    mesh.set_n_shards(1)
    torch.set_num_threads(threads)


def _labels(seed, n=301, k=3):
    rng = np.random.RandomState(seed)
    t = rng.randint(0, k, n)
    p = np.where(rng.rand(n) < 0.7, t, rng.randint(0, k, n))
    w = rng.randint(1, 4, n).astype(np.float32) / 2.0
    return t, p, w


def _both(a, sharded):
    """(port input, reference input)."""
    if not sharded:
        return a, a
    with mesh.use_device("cpu", n_shards=8):
        return shard_rows(a), ref_shard_rows(a)


PRF_CASES = [(avg, k, weighted) for avg in ("binary", "micro", "macro", "weighted", None)
             for k in (2, 3) for weighted in (False, True) if not (avg == "binary" and k == 3)]


@pytest.mark.parametrize("sharded", [False, True])
@pytest.mark.parametrize("average,k,weighted", PRF_CASES)
def test_precision_recall_f1_match_the_reference(average, k, weighted, sharded):
    t, p, w = _labels(k + weighted, k=k)
    tp, tr = _both(t, sharded)
    pp, pr = _both(p, sharded)
    sw = w if weighted else None
    for name in ("precision_score", "recall_score", "f1_score"):
        got = getattr(metrics, name)(tp, pp, average=average, sample_weight=sw)
        want = getattr(ref_cls, name)(tr, pr, average=average, sample_weight=sw)
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_prf_labels_pos_label_and_zero_division():
    t, p, _ = _labels(11, k=3)
    kw = dict(average=None, labels=[2, 0, 5])  # the caller's order, a label never seen
    np.testing.assert_allclose(metrics.f1_score(t, p, **kw), ref_cls.f1_score(t, p, **kw),
                               rtol=1e-12)
    tb, pb = t % 2 + 1, p % 2 + 1  # labels {1, 2}
    for pos in (1, 2):
        assert metrics.recall_score(tb, pb, pos_label=pos) == pytest.approx(
            ref_cls.recall_score(tb, pb, pos_label=pos), rel=1e-12)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert metrics.precision_score(tb, pb, pos_label=7) == 0.0
    assert any(issubclass(c.category, classification.UndefinedMetricWarning) for c in caught)
    with pytest.raises(ValueError, match="not a valid label"):
        metrics.precision_score(tb, pb, pos_label=7, labels=[1, 2])
    with pytest.raises(ValueError, match="multiclass"):
        metrics.f1_score(t, p)
    with pytest.raises(ValueError, match="Unsupported average"):
        metrics.f1_score(t, p, average="samples")
    zero = np.zeros(10, np.int64)
    assert metrics.precision_score(zero, zero, average="macro") == ref_cls.precision_score(
        zero, zero, average="macro")


@pytest.mark.parametrize("normalize", [None, "true", "pred", "all"])
@pytest.mark.parametrize("weighted", [False, True])
def test_confusion_matrix_and_balanced_accuracy_match_the_reference(normalize, weighted):
    t, p, w = _labels(3 + weighted, k=4)
    sw = w if weighted else None
    tp, tr = _both(t, True)
    got = metrics.confusion_matrix(tp, p, sample_weight=sw, normalize=normalize)
    want = ref_cls.confusion_matrix(tr, p, sample_weight=sw, normalize=normalize)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-12)
    lab = [3, 1]
    np.testing.assert_allclose(metrics.confusion_matrix(t, p, labels=lab, sample_weight=sw),
                               ref_cls.confusion_matrix(t, p, labels=lab, sample_weight=sw))
    for adjusted in (False, True):
        assert metrics.balanced_accuracy_score(tp, p, sample_weight=sw, adjusted=adjusted) == \
            pytest.approx(ref_cls.balanced_accuracy_score(tr, p, sample_weight=sw,
                                                          adjusted=adjusted), rel=1e-12)


def _auc64(t, s, w):
    """ROC AUC in float64 by the pair count: ties count one half."""
    pos, neg = t == t.max(), t != t.max()
    sp, sn, wp, wn = s[pos][:, None], s[neg][None, :], w[pos][:, None], w[neg][None, :]
    num = np.sum(wp * wn * ((sp > sn) + 0.5 * (sp == sn)))
    return num / (w[pos].sum() * w[neg].sum())


@pytest.mark.parametrize("score_dtype,weighted,sharded", [
    (dtype, weighted, False) for dtype in (np.float32, np.float64, np.int64)
    for weighted in (False, True)] + [(np.float32, True, True)])
def test_roc_auc_under_ties_and_weights(score_dtype, weighted, sharded):
    rng = np.random.RandomState(5)
    n = 997
    t = rng.randint(0, 2, n) * 3 + 2  # labels {2, 5}
    s = np.round(rng.standard_normal(n) + 0.8 * (t == 5), 1).astype(score_dtype)  # many ties
    if score_dtype == np.int64:
        s = rng.randint(0, 5, n) + (t == 5)
    w = (rng.randint(1, 5, n) / 4.0).astype(np.float32) if weighted else np.ones(n, np.float32)
    tp, tr = _both(t, sharded)
    got = metrics.roc_auc_score(tp, s, sample_weight=w if weighted else None)
    want = _auc64(t, s.astype(np.float64), w.astype(np.float64))
    assert abs(got - want) <= 1e-9
    ref = ref_cls.roc_auc_score(tr, s, sample_weight=w if weighted else None)
    assert abs(got - ref) <= 1e-6
    with pytest.raises(ValueError, match="2 classes"):
        metrics.roc_auc_score(np.arange(n) % 3, s)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", ["binary", "multi", "labels"])
def test_log_loss_clips_at_the_input_epsilon(dtype, shape):
    rng = np.random.RandomState(7)
    n = 211
    if shape == "binary":
        t = rng.randint(0, 2, n)
        p = rng.rand(n).astype(dtype)
        p[:5] = 0.0  # clipped at eps from below (p = 1 would be NaN in the float32 reference)
        kw = {}
    else:
        t = rng.randint(0, 3, n)
        p = rng.dirichlet(np.ones(3), n).astype(dtype)
        p[:4] = np.eye(3, dtype=dtype)[[0, 1, 2, 0]]  # exact 0s and 1s
        kw = {}
        if shape == "labels":
            t = t * 10 + 5
            kw = dict(labels=[5, 15, 25])
    w = rng.rand(n).astype(np.float32)
    for sw in (None, w):
        got = metrics.log_loss(t, p, sample_weight=sw, **kw)
        want = ref_cls.log_loss(t, p, sample_weight=sw, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    eps = np.finfo(dtype).eps
    one = np.array([1], np.int64)
    np.testing.assert_allclose(metrics.log_loss(one, np.zeros(1, dtype)), -np.log(eps),
                               rtol=1e-6)
    if shape == "labels":
        with pytest.raises(ValueError, match="not in `labels`"):
            metrics.log_loss(t + 1, p, labels=[5, 15, 25])


REGRESSION = ("mean_squared_error", "mean_absolute_error", "mean_squared_log_error",
              "mean_absolute_percentage_error", "median_absolute_error",
              "explained_variance_score", "r2_score")


# r2_score and mean_squared_log_error take one output in both packages; a
# padded ShardedRows target for three of the metrics
REGRESSION_CASES = [(name, outputs, False) for name in REGRESSION for outputs in (1, 3)
                    if outputs == 1 or name not in ("r2_score", "mean_squared_log_error")] + [
    (name, 1, True) for name in ("mean_squared_error", "median_absolute_error", "r2_score")]


@pytest.mark.parametrize("name,outputs,sharded", REGRESSION_CASES)
def test_regression_metrics_match_the_reference(name, outputs, sharded):
    rng = np.random.RandomState(len(name) + outputs)
    n = 333
    shape = (n,) if outputs == 1 else (n, outputs)
    t = rng.rand(*shape).astype(np.float32) * 3
    t.flat[:3] = 0.0  # zero targets: the percentage error's eps
    p = (t + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    p = np.abs(p)
    tp, tr = _both(t, sharded)
    w = rng.rand(n).astype(np.float32)
    for sw in ((None,) if name == "median_absolute_error" else (None, w)):
        got = getattr(regression, name)(tp, p, sample_weight=sw)
        want = float(getattr(ref_reg, name)(tr, p, sample_weight=sw))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    if name == "mean_squared_error":
        np.testing.assert_allclose(regression.mean_squared_error(tp, p, squared=False),
                                   float(ref_reg.mean_squared_error(tr, p, squared=False)),
                                   rtol=1e-5)
    if name == "median_absolute_error":
        with pytest.raises(NotImplementedError, match="sample_weight"):
            regression.median_absolute_error(t, p, sample_weight=w)


@pytest.mark.parametrize("name", SCORER_NAMES)
def test_every_scorer_name_matches_the_reference(name):
    rng = np.random.RandomState(13)
    X = rng.standard_normal((400, 5)).astype(np.float32)
    w = rng.standard_normal(5)
    kw = dict(max_iter=5, tol=None, random_state=0)
    if name in ("r2",) or name.startswith("neg_m") or name.startswith("neg_r"):
        y = (X @ w + 0.1 * rng.standard_normal(400)).astype(np.float32)
        port = SGDRegressor(learning_rate="constant", eta0=0.05, **kw).fit(X, y)
        ref = RefSGDRegressor(learning_rate="constant", eta0=0.05, **kw).fit(X, y)
    else:
        y = (X @ w + 0.5 * rng.standard_normal(400) > 0).astype(np.int64)
        if name.endswith("macro") or name.endswith("weighted") or name.endswith("micro"):
            y = y + (X[:, 0] > 1.0)  # three classes
        port = SGDClassifier(loss="log_loss", **kw).fit(X, y)
        ref = RefSGDClassifier(loss="log_loss", **kw).fit(X, y)
    got = scorer.get_scorer(name)(port, X, y)
    want = float(ref_scorer.get_scorer(name)(ref, X, y))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    assert scorer.check_scoring(port, name) is scorer.SCORERS[name]
