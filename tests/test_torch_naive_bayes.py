"""The port's ``GaussianNB`` (``dask_ml_tpu_torch/naive_bayes.py``) and the
plain versions of K9 and K9b (``ops/naive_bayes.py``) against the JAX
reference on the CPU: the reference on the 8 virtual CPU devices, the port
at 8 logical shards, the same seeded numpy inputs (at most 2003 x 7).

Tolerances:
- ``theta_``, ``var_``, ``class_count_``, ``class_prior_`` and K9's plain
  version against ``_class_moments_fn``: rtol 1e-5 with an atol of 1e-6 of
  the array's largest |value| (float32 gemms in another order; a mean near
  0 has only that floor);
- predictions equal, except on rows whose two largest jll are within 1e-5
  of the largest |jll| (none occur at these seeds);
- K9b's plain version against ``_joint_log_likelihood``: rtol 1e-6 of the
  row's largest |jll| (float32 sums over the features in another order);
  ``predict_proba`` to atol 1e-5 (a jll difference δ moves a probability
  by at most δ/4);
- a ``partial_fit`` stream against ``fit`` and against the reference's
  stream: the rtol above.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import dask_ml_tpu.naive_bayes as rnb
from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu.impute import SimpleImputer as RefImputer
from sklearn.pipeline import make_pipeline as ref_make_pipeline
from dask_ml_tpu.preprocessing import QuantileTransformer as RefQT
from dask_ml_tpu_torch import (
    GaussianNB, QuantileTransformer, SimpleImputer, gaussian_nb_from_reference, make_pipeline)
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.ops import naive_bayes as nbops

RTOL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    mesh.set_device("cpu")
    mesh.set_n_shards(8)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    mesh.set_device(None)
    mesh.set_n_shards(1)
    torch.set_num_threads(threads)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _close(got, want, rtol=RTOL):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * np.abs(want).max())


def _classes(seed=0, n=2003, d=6, k=3):
    rng = np.random.RandomState(seed)
    means = rng.standard_normal((k, d)) * 2
    y = rng.randint(0, k, n)
    x = (means[y] + rng.standard_normal((n, d)) * rng.uniform(0.5, 2, d)).astype(np.float32)
    return x, y


def _assert_fitted(port, ref):
    np.testing.assert_array_equal(port.classes_, ref.classes_)
    for a in ("theta_", "var_", "class_count_", "class_prior_", "_m2"):
        _close(getattr(port, a), getattr(ref, a))
    assert port._max_var == pytest.approx(ref._max_var, rel=RTOL)


def _assert_predictions(port, ref, x):
    jll = np.asarray(ref._joint_log_likelihood(jnp.asarray(x)))
    top = np.sort(jll, axis=1)
    tie = (top[:, -1] - top[:, -2]) < 1e-5 * np.abs(jll).max()
    differ = port.predict(x) != np.asarray(ref.predict(x))
    assert not (differ & ~tie).any()
    np.testing.assert_allclose(_np(port.predict_proba(x)), np.asarray(ref.predict_proba(x)),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("k", [2, 3, 7])
def test_fit_matches_reference(k):
    x, y = _classes(k, k=k)
    port, ref = GaussianNB().fit(x, y), rnb.GaussianNB().fit(x, y)
    _assert_fitted(port, ref)
    _assert_predictions(port, ref, x)
    assert port.score(x, y) == pytest.approx(float(ref.score(x, y)), abs=1e-6)
    log_p = _np(port.predict_log_proba(x))
    np.testing.assert_array_equal(log_p, _np(torch.log(port.predict_proba(x))))
    live = np.asarray(ref.predict_proba(x)) > 1e-6  # log amplifies an underflowing tail
    np.testing.assert_allclose(log_p[live], np.asarray(ref.predict_log_proba(x))[live],
                               atol=1e-4, rtol=0)


def test_fractional_sample_weight_matches_reference():
    x, y = _classes(10)
    w = np.random.RandomState(10).uniform(0.1, 3.0, x.shape[0]).astype(np.float32)
    w[::9] = 0.0
    port = GaussianNB().fit(x, y, sample_weight=w)
    ref = rnb.GaussianNB().fit(x, y, sample_weight=w)
    _assert_fitted(port, ref)
    _assert_predictions(port, ref, x)
    unweighted = GaussianNB().fit(x, y)
    assert not np.allclose(_np(unweighted.theta_), _np(port.theta_), rtol=1e-4)


def test_partial_fit_stream_equals_fit_and_the_reference_stream():
    x, y = _classes(11, n=1999)
    whole = GaussianNB().fit(x, y)
    port, ref = GaussianNB(), rnb.GaussianNB()
    for s in range(0, x.shape[0], 600):
        port.partial_fit(x[s:s + 600], y[s:s + 600], classes=[0, 1, 2])
        ref.partial_fit(x[s:s + 600], y[s:s + 600], classes=[0, 1, 2])
    _assert_fitted(port, ref)
    for a in ("theta_", "var_", "class_count_"):
        _close(getattr(port, a), getattr(whole, a))
    with pytest.raises(ValueError, match="not the same"):
        port.partial_fit(x[:10], y[:10], classes=[0, 1])
    with pytest.raises(ValueError, match="classes must be passed"):
        GaussianNB().partial_fit(x, y)


def test_priors_strings_and_unknown_labels():
    x, y = _classes(12, k=2)
    port = GaussianNB(priors=[0.3, 0.7]).fit(x, y)
    ref = rnb.GaussianNB(priors=[0.3, 0.7]).fit(x, y)
    _assert_fitted(port, ref)
    np.testing.assert_array_equal(port.predict(x), np.asarray(ref.predict(x)))
    # string classes (the reference predicts none: its classes go through jnp)
    names = np.array(["no", "yes"])[y]
    port = GaussianNB(priors=[0.3, 0.7]).fit(x, names)
    np.testing.assert_array_equal(port.classes_, ["no", "yes"])
    for a in ("theta_", "var_", "class_count_", "class_prior_"):
        _close(getattr(port, a), getattr(ref, a))
    np.testing.assert_array_equal(port.predict(x), np.array(["no", "yes"])[
        np.asarray(ref.predict(x))])
    assert port.score(x, names) == pytest.approx(float(ref.score(x, y)), abs=1e-6)
    with pytest.raises(ValueError, match="not in classes_"):
        port.partial_fit(x[:4], np.array(["no", "yes", "maybe", "no"]))
    with pytest.raises(ValueError, match="different lengths"):
        port.partial_fit(x[:4], names[:3])


def test_tensor_labels_stay_on_their_device():
    x, y = _classes(13)
    on_host = GaussianNB().fit(x, y)
    port = GaussianNB().fit(torch.from_numpy(x), torch.from_numpy(y))
    for a in ("theta_", "var_", "class_count_"):
        np.testing.assert_array_equal(_np(getattr(port, a)), _np(getattr(on_host, a)))
    assert port.score(torch.from_numpy(x), torch.from_numpy(y)) == pytest.approx(
        on_host.score(x, y), abs=1e-12)
    with pytest.raises(ValueError, match="not in classes_"):
        port.partial_fit(torch.from_numpy(x[:3]), torch.tensor([0, 1, 5]))


def test_sharded_input_and_weighted_score():
    x, y = _classes(14, n=1001)
    port = GaussianNB().fit(shard_rows(x), y)
    ref = rnb.GaussianNB().fit(ref_shard_rows(x), y)
    _assert_fitted(port, ref)
    assert port.predict(shard_rows(x)).shape == (1001,)
    w = np.random.RandomState(14).uniform(0, 1, 1001)
    assert port.score(x, y, sample_weight=w) == pytest.approx(
        float(ref.score(x, y, sample_weight=w)), abs=1e-5)


@pytest.mark.parametrize("k", [1, 3, 9])
def test_k9_plain_version_matches_reference(k):
    x, y = _classes(20 + k, n=1003, d=7, k=k)
    X = shard_rows(x)
    w = np.zeros(X.padded, np.float32)
    w[:1003] = np.random.RandomState(k).uniform(0, 2, 1003)
    labels = np.zeros(X.padded, np.int32)
    labels[:1003] = y
    counts, means, var = nbops.class_moments(X.data, torch.from_numpy(labels),
                                             torch.from_numpy(w), k)
    onehot = jnp.asarray(np.eye(k, dtype=np.float32)[labels])
    rc, rm, rv = rnb._class_moments_fn(jnp.asarray(X.data.numpy()), jnp.asarray(w), onehot)
    for got, want in ((counts, rc), (means, rm), (var, rv)):
        _close(got, want)


def test_k9_counts_a_label_outside_the_classes_nowhere():
    x = torch.randn(50, 3)
    labels = torch.randint(0, 2, (50,), dtype=torch.int32)
    labels[:5] = 7
    w = torch.ones(50)
    counts, _, _ = nbops.class_moments(x, labels, w, 2)
    assert float(counts.sum()) == 45.0


@pytest.mark.parametrize("k", [2, 10])
def test_k9b_plain_version_matches_reference(k):
    x, y = _classes(30 + k, n=777, k=k)
    ref = rnb.GaussianNB().fit(x, y)
    theta, var, prior = (torch.tensor(np.asarray(getattr(ref, a)))
                         for a in ("theta_", "var_", "class_prior_"))
    got = _np(nbops.gaussian_jll(torch.from_numpy(x), theta, var, prior))
    want = np.asarray(ref._joint_log_likelihood(jnp.asarray(x)))
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert (np.abs(got - want) <= 1e-6 * scale).all()
    pred = _np(nbops.gaussian_jll(torch.from_numpy(x), theta, var, prior, predict=True))
    np.testing.assert_array_equal(pred, np.argmax(got, axis=1))


def test_k9b_first_maximum_wins_a_tie():
    x = torch.zeros(4, 2)
    theta = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.0, 0.0]])
    var = torch.ones(3, 2)
    prior = torch.tensor([0.25, 0.25, 0.25])
    theta[2] = 5.0
    assert _np(nbops.gaussian_jll(x, theta, var, prior, predict=True)).tolist() == [0, 0, 0, 0]


def test_wrappers_check_their_inputs():
    x = torch.randn(10, 3)
    with pytest.raises(TypeError):
        nbops.class_moments(x.double(), torch.zeros(10, dtype=torch.int32), torch.ones(10), 2)
    with pytest.raises(TypeError):
        nbops.class_moments(x, torch.zeros(10, dtype=torch.int64), torch.ones(10), 2)
    with pytest.raises(ValueError):
        nbops.gaussian_jll(x, torch.zeros(2, 4), torch.ones(2, 4), torch.ones(2))


def test_converted_model_predicts_and_goes_on_as_the_reference():
    x, y = _classes(40)
    ref = rnb.GaussianNB().partial_fit(x[:1000], y[:1000], classes=[0, 1, 2])
    arrays = {a: np.asarray(getattr(ref, a)) for a in (
        "theta_", "var_", "class_count_", "class_prior_", "classes_", "_m2", "n_features_in_")}
    arrays["_max_var"] = ref._max_var
    port = gaussian_nb_from_reference(arrays)
    np.testing.assert_array_equal(port.predict(x), np.asarray(ref.predict(x)))
    port.partial_fit(x[1000:], y[1000:])
    ref.partial_fit(x[1000:], y[1000:])
    _assert_fitted(port, ref)
    with pytest.raises(ValueError, match="missing"):
        gaussian_nb_from_reference({"theta_": arrays["theta_"]})


def test_the_pipeline_of_the_card_run_matches_reference():
    rng = np.random.RandomState(50)
    x, y = _classes(50, n=1500, d=5, k=2)
    x[rng.rand(*x.shape) < 0.01] = np.nan
    port = make_pipeline(SimpleImputer(), QuantileTransformer(output_distribution="normal"),
                         GaussianNB()).fit(x, y)
    ref = ref_make_pipeline(RefImputer(), RefQT(output_distribution="normal"),
                            rnb.GaussianNB()).fit(x, y)
    nb_p, nb_r = port.steps[-1][1], ref.steps[-1][1]
    np.testing.assert_allclose(_np(nb_p.theta_), np.asarray(nb_r.theta_), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(nb_p.var_), np.asarray(nb_r.var_), atol=1e-5, rtol=1e-4)
    agree = np.mean(port.predict(x) == np.asarray(ref.predict(x)))
    assert agree >= 0.999
    assert port.score(x, y) == pytest.approx(float(ref.score(x, y)), abs=1e-3)
