"""The port's preprocessing (``dask_ml_tpu_torch/preprocessing/``: the
scalers, the quantiles and their sketch through K12's plain version, the
transforms, ``LabelEncoder`` and ``BlockTransformer``) against the JAX
reference on the CPU: the reference on the 8 virtual CPU devices of the
tier-1 conftest, the port at 8 logical shards, the same seeded numpy
inputs (at most 3001 x 7).

Tolerances:
- the scalers' statistics (``mean_``, ``var_``, ``scale_``, ``center_``,
  the min/max) and their transforms: rtol 1e-5 with an atol of 1e-6 of the
  array's largest |value| (float32 sums in another order; a mean near 0
  has only that absolute floor);
- exact quantiles (``RobustScaler``'s, ``QuantileTransformer``'s below the
  row threshold, ``_masked_quantiles(method="exact")``): rtol 1e-6 (the same
  sort and the same interpolation formula as ``jnp.nanquantile``);
- the histogram sketch, both threshold knobs set low: each value within
  its last pass's bin width of the order statistic it targets (rank
  ceil(p·n)) plus 1e-6 of its size, and to rtol 1e-6 of the reference's
  sketch evaluated op by op (``jax.disable_jit``).  The jitted reference is
  not the yardstick there: XLA's compiled program rounds the windows'
  edges otherwise, and on a 3-column input with an outlier column its
  median lands 7 of the last pass's bin widths from the order statistic it
  targets, where its own op-by-op evaluation, and the port, land within
  one (``test_sketch_holds_the_semantics_where_the_jitted_reference_parts``);
- K12's plain version against the reference's bin formula and
  ``bucket_sum``: equal counts;
- ``QuantileTransformer``'s transforms on the same quantiles: the uniform
  map to atol 1e-6 (the same ``jnp.interp`` rules, a tied run mapping to
  its last reference exactly), the normal map to atol 1e-5 of a value (its
  ppf is ``torch.special.ndtri``, not JAX's);
- ``Normalizer``, ``PolynomialFeatures``, ``MaxAbsScaler``: rtol 1e-6;
- ``LabelEncoder``, feature names, ``BlockTransformer``: equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import dask_ml_tpu.preprocessing as rp
from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu.ops.scatter import bucket_sum as ref_bucket_sum
from dask_ml_tpu.preprocessing import data as ref_data
import dask_ml_tpu_torch.preprocessing as pp
from dask_ml_tpu_torch import (
    max_abs_scaler_from_reference, min_max_scaler_from_reference,
    quantile_transformer_from_reference, robust_scaler_from_reference,
    standard_scaler_from_reference)
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.core.sharded import ShardedRows
from dask_ml_tpu_torch.ops import histogram
from dask_ml_tpu_torch.preprocessing import data

RTOL = 1e-5
QRTOL = 1e-6
PROBS = np.array([0.0, 0.01, 0.1, 0.25, 0.5, 0.75, 0.9, 0.999, 1.0], np.float32)


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
    if isinstance(a, ShardedRows):
        a = a.unpad()
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    if hasattr(a, "data") and hasattr(a, "n_samples") and hasattr(a, "mask"):
        return np.asarray(a.data)[: a.n_samples]
    return np.asarray(a)


def _close(got, want, rtol=RTOL):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    atol = 1e-6 * max(float(np.abs(want).max()), 1e-30) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _data(seed=0, n=3001, d=6, offset=2.0):
    rng = np.random.RandomState(seed)
    scale = rng.uniform(0.5, 3.0, d).astype(np.float32)
    return (rng.standard_normal((n, d)).astype(np.float32) * scale + offset).astype(np.float32)


def _outlier_data(seed=1, n=3001):
    """A bulk column, an outlier column (one value 1e9) and a constant one."""
    x = _data(seed, n, 3)
    x[n // 3, 1] = 1e9
    x[:, 2] = 3.0
    return x


def test_all_names_the_references():
    assert pp.__all__ == rp.__all__
    for name in pp.__all__:
        assert hasattr(pp, name)


@pytest.mark.parametrize("with_mean,with_std", [(True, True), (False, True), (True, False)])
def test_standard_scaler_matches_reference(with_mean, with_std):
    x = _data()
    port = pp.StandardScaler(with_mean=with_mean, with_std=with_std).fit(x)
    ref = rp.StandardScaler(with_mean=with_mean, with_std=with_std).fit(x)
    for a in ("mean_", "var_", "scale_"):
        if getattr(ref, a) is None:
            assert getattr(port, a) is None
        else:
            _close(getattr(port, a), getattr(ref, a))
    assert port.n_samples_seen_ == ref.n_samples_seen_
    _close(port.transform(x), ref.transform(x))
    _close(port.inverse_transform(port.transform(x)), x)


def test_standard_scaler_partial_fit_stream_equals_fit():
    x = _data(2, n=2501)
    whole = pp.StandardScaler().fit(x)
    stream, ref = pp.StandardScaler(), rp.StandardScaler()
    for s in range(0, x.shape[0], 700):
        stream.partial_fit(x[s:s + 700])
        ref.partial_fit(x[s:s + 700])
    assert stream.n_samples_seen_ == whole.n_samples_seen_ == x.shape[0]
    for a in ("mean_", "var_", "scale_"):
        _close(getattr(stream, a), getattr(whole, a))
        _close(getattr(stream, a), getattr(ref, a))


def test_scalers_keep_a_constant_feature():
    x = _data(3)
    x[:, 1] = 7.0
    for name in ("StandardScaler", "MinMaxScaler", "MaxAbsScaler", "RobustScaler"):
        port, ref = getattr(pp, name)().fit(x), getattr(rp, name)().fit(x)
        out = _np(port.transform(x))
        assert np.isfinite(out).all(), name
        _close(out, ref.transform(x))


@pytest.mark.parametrize("feature_range", [(0, 1), (-2, 3)])
def test_min_max_scaler_matches_reference(feature_range):
    x = _data(4)
    port = pp.MinMaxScaler(feature_range=feature_range).fit(x)
    ref = rp.MinMaxScaler(feature_range=feature_range).fit(x)
    for a in ("data_min_", "data_max_", "data_range_", "scale_", "min_"):
        _close(getattr(port, a), getattr(ref, a))
    _close(port.transform(x), ref.transform(x))
    _close(port.inverse_transform(port.transform(x)), x)


def test_min_max_and_max_abs_partial_fit_streams_equal_fit():
    x = _data(5, n=2003, offset=-1.0)
    for name, attrs in (("MinMaxScaler", ("data_min_", "data_max_", "scale_", "min_")),
                        ("MaxAbsScaler", ("max_abs_", "scale_"))):
        whole, stream = getattr(pp, name)().fit(x), getattr(pp, name)()
        for s in range(0, x.shape[0], 500):
            stream.partial_fit(x[s:s + 500])
        assert stream.n_samples_seen_ == x.shape[0]
        for a in attrs:
            np.testing.assert_array_equal(_np(getattr(stream, a)), _np(getattr(whole, a)))


def test_padding_does_not_leak_into_the_statistics():
    x = _data(6, n=1001, offset=50.0)  # padded to 1008 rows of zeros
    X = shard_rows(x)
    assert X.padded > X.n_samples
    for name, attr in (("MinMaxScaler", "data_min_"), ("MaxAbsScaler", "max_abs_"),
                       ("StandardScaler", "mean_"), ("RobustScaler", "center_")):
        port, ref = getattr(pp, name)().fit(X), getattr(rp, name)().fit(ref_shard_rows(x))
        _close(getattr(port, attr), getattr(ref, attr), rtol=QRTOL)


def test_max_abs_scaler_matches_reference():
    x = _data(7, offset=-0.5)
    port, ref = pp.MaxAbsScaler().fit(x), rp.MaxAbsScaler().fit(x)
    _close(port.max_abs_, ref.max_abs_, rtol=QRTOL)
    _close(port.transform(x), ref.transform(x), rtol=QRTOL)
    _close(port.inverse_transform(port.transform(x)), x)


def test_integer_input_is_cast_to_float():
    x = np.arange(60, dtype=np.int64).reshape(20, 3)
    port, ref = pp.MinMaxScaler().fit(x), rp.MinMaxScaler().fit(x)
    assert port.transform(x).dtype == torch.float32
    _close(port.transform(x), ref.transform(x))


def test_sharded_in_sharded_out():
    x = _data(8, n=1001)
    X = shard_rows(x)
    for name in ("StandardScaler", "MinMaxScaler", "MaxAbsScaler", "RobustScaler",
                 "QuantileTransformer", "Normalizer"):
        out = getattr(pp, name)().fit(X).transform(X)
        assert isinstance(out, ShardedRows) and out.n_samples == 1001, name
        _close(out, getattr(rp, name)().fit(x).transform(x))


@pytest.mark.parametrize("qrange", [(25.0, 75.0), (10.0, 90.0)])
def test_robust_scaler_exact_matches_reference(qrange):
    x = _data(9)
    port, ref = pp.RobustScaler(quantile_range=qrange).fit(x), rp.RobustScaler(
        quantile_range=qrange).fit(x)
    _close(port.center_, ref.center_, rtol=QRTOL)
    _close(port.scale_, ref.scale_, rtol=QRTOL)
    _close(port.transform(x), ref.transform(x))
    _close(port.inverse_transform(port.transform(x)), x)
    with pytest.raises(ValueError):
        pp.RobustScaler(quantile_range=(80.0, 20.0)).fit(x)


def test_exact_quantiles_match_reference_and_numpy():
    x = _data(10, n=2001)
    X, Xr = shard_rows(x), ref_shard_rows(x)
    got = data._masked_quantiles(X.data, X.mask, PROBS, "exact")
    want = ref_data._masked_quantiles(Xr.data, Xr.mask, jnp.asarray(PROBS), "exact")
    _close(got, want, rtol=QRTOL)
    np.testing.assert_allclose(_np(got), np.quantile(x, PROBS, axis=0), rtol=QRTOL)


def test_nanquantile_is_jnp_nanquantile_without_torch_s_row_limit(monkeypatch):
    rng = np.random.RandomState(11)
    x = rng.standard_normal((1000, 4)).astype(np.float32)
    x[rng.rand(1000, 4) < 0.2] = np.nan
    x[:, 3] = np.nan  # an all-NaN column
    x[:10, 3] = np.arange(10)  # ... but for an even count
    monkeypatch.setattr(torch, "nanquantile", None)  # the port must not need it
    got = data._nanquantile(torch.from_numpy(x), PROBS)
    want = jnp.nanquantile(jnp.asarray(x), jnp.asarray(PROBS), axis=0)
    _close(got, want, rtol=QRTOL)
    assert float(data._nanquantile(torch.from_numpy(x[:, 3:]), [0.5])[0, 0]) == 4.5


def test_k12_plain_version_counts_as_the_reference_formula():
    x = _outlier_data(12)
    X = shard_rows(x)
    mask = X.mask.clone()
    mask[::7] = 0.0
    lo = torch.where(mask[:, None] > 0, X.data, float("inf")).amin(0)
    hi = torch.where(mask[:, None] > 0, X.data, -float("inf")).amax(0)
    for lo_f, hi_f in ((lo, hi), (lo + 0.2 * (hi - lo), lo + 0.3 * (hi - lo))):
        width = torch.clamp_min(hi_f - lo_f, 1e-30)
        counts, below = histogram.hist_pass_counts(X.data, mask, lo_f, hi_f, width)
        xj, mj = jnp.asarray(X.data.numpy()), jnp.asarray(mask.numpy())
        loj, hij, wj = (jnp.asarray(t.numpy()) for t in (lo_f, hi_f, width))
        idx = jnp.clip(((xj - loj) / wj * 4096).astype(jnp.int32), 0, 4095)
        inside = mj[:, None] * (xj >= loj) * (xj <= hij)
        feat = jnp.arange(3, dtype=jnp.int32)[None, :] * 4096
        want = ref_bucket_sum(inside.ravel(), (feat + idx).ravel(), num_segments=3 * 4096,
                              strategy="segsum").reshape(3, 4096)
        np.testing.assert_array_equal(_np(counts), np.asarray(want))
        np.testing.assert_array_equal(_np(below),
                                      np.asarray(jnp.sum(mj[:, None] * (xj < loj), axis=0)))


def test_k12_wrapper_runs_its_plain_version_on_cpu_and_checks_its_inputs():
    x = torch.from_numpy(_data(13, n=101, d=2))
    mask = torch.ones(101)
    lo, hi = x.amin(0), x.amax(0)
    before = histogram.hist_pass_counts.launches
    counts, below = histogram.hist_pass_counts(x, mask, lo, hi, hi - lo)
    assert histogram.hist_pass_counts.launches == before  # the plain version, no launch
    assert tuple(counts.shape) == (2, 4096) and float(counts.sum()) == 202.0
    assert float(below.sum()) == 0.0
    with pytest.raises(TypeError):
        histogram.hist_pass_counts(x.double(), mask, lo, hi, hi - lo)
    with pytest.raises(ValueError):
        histogram.hist_pass_counts(x, mask[:-1], lo, hi, hi - lo)


def _order_statistic(col, p):
    """The value the sketch targets: rank ceil(p·n) (1-based) of the sorted
    column."""
    s = np.sort(col)
    k = int(np.ceil(np.float32(p) * np.float32(s.size)))
    return s[min(max(k, 1), s.size) - 1]


def _ref_sketch(x, probs):
    """The reference's sketch evaluated op by op (no XLA compilation)."""
    Xr = ref_shard_rows(x)
    with jax.disable_jit():
        return np.asarray(ref_data._hist_quantiles(Xr.data, Xr.mask, jnp.asarray(probs)))


def _hold_sketch(x, probs):
    """The port's sketch within its last bin width of each order statistic
    and to rtol 1e-6 of the reference's op-by-op sketch."""
    X = shard_rows(x)
    vals, binw = data._hist_quantiles(X.data, X.mask, probs, with_width=True)
    vals, binw = _np(vals), _np(binw)
    for j in range(x.shape[1]):
        for i, p in enumerate(probs):
            want = (x[:, j].min() if p == 0 else x[:, j].max() if p == 1
                    else _order_statistic(x[:, j], p))
            slack = binw[j] + 1e-6 * abs(float(want))
            assert abs(vals[i, j] - want) <= slack, (i, j, vals[i, j], want, binw[j])
    _close(vals, _ref_sketch(x, probs), rtol=QRTOL)
    return vals


@pytest.mark.parametrize("seed", [0, 1])
def test_sketch_holds_the_order_statistics_and_the_reference(seed):
    x = _outlier_data(20 + seed)
    vals = _hold_sketch(x, PROBS)
    assert (vals[:, 2] == 3.0).all()  # the constant column
    assert vals[-1, 1] == 1e9 and vals[0, 1] == x[:, 1].min()


def test_sketch_holds_the_semantics_where_the_jitted_reference_parts():
    x = _outlier_data(23)
    probs = np.array([0.25, 0.5, 0.75], np.float32)
    vals = _hold_sketch(x, probs)
    Xr = ref_shard_rows(x)
    jitted = np.asarray(ref_data._hist_quantiles(Xr.data, Xr.mask, jnp.asarray(probs)))
    median = _order_statistic(x[:, 1], 0.5)
    # the compiled reference's median of the outlier column is 7.8e-3 off,
    # about 7 of the last pass's 1.06e-3-wide bins; the port's is within one
    assert abs(jitted[1, 1] - median) > 5e-3
    assert abs(vals[1, 1] - median) < 1.1e-3


def test_sketch_ignores_padded_and_masked_rows():
    x = _data(22, n=1001, offset=100.0)
    X = shard_rows(x)
    vals = _np(data._hist_quantiles(X.data, X.mask, PROBS))
    assert vals.min() > 50.0  # the zero pad rows never count
    mask = X.mask.clone()
    mask[:500] = 0.0
    vals = _np(data._hist_quantiles(X.data, mask, [0.0, 1.0]))
    np.testing.assert_array_equal(vals[0], x[500:].min(0))


def test_threshold_knob_switches_to_the_sketch(monkeypatch):
    x = _outlier_data(23)
    calls = []
    real = histogram.hist_pass_counts_ref
    monkeypatch.setattr(histogram, "hist_pass_counts_ref",
                        lambda *a: calls.append(1) or real(*a))
    pp.RobustScaler().fit(x)
    assert not calls  # 3001 rows: exact
    monkeypatch.setenv("DASK_ML_TPU_TORCH_EXACT_QUANTILE_MAX_ROWS", "100")
    monkeypatch.setenv("DASK_ML_TPU_EXACT_QUANTILE_MAX_ROWS", "100")
    port = pp.RobustScaler().fit(x)
    with jax.disable_jit():
        ref = rp.RobustScaler().fit(x)
    assert len(calls) == 4  # one min/max, then 1 + 3 histogram passes
    _close(port.center_, ref.center_, rtol=QRTOL)
    _close(port.scale_, ref.scale_, rtol=QRTOL)


def test_quantile_transformer_sketch_path_matches_reference(monkeypatch):
    monkeypatch.setenv("DASK_ML_TPU_TORCH_EXACT_QUANTILE_MAX_ROWS", "100")
    monkeypatch.setenv("DASK_ML_TPU_EXACT_QUANTILE_MAX_ROWS", "100")
    x = _outlier_data(24)
    port = pp.QuantileTransformer(n_quantiles=50).fit(x)
    with jax.disable_jit():
        ref = rp.QuantileTransformer(n_quantiles=50).fit(x)
    _close(port.quantiles_, ref.quantiles_, rtol=QRTOL)
    _hold_sketch(x, _np(port.references_))


@pytest.mark.parametrize("n_quantiles", [1000, 37, 10])
def test_quantile_transformer_exact_matches_reference(n_quantiles):
    x = _data(25, n=2001)
    port = pp.QuantileTransformer(n_quantiles=n_quantiles).fit(x)
    ref = rp.QuantileTransformer(n_quantiles=n_quantiles).fit(x)
    assert port.n_quantiles_ == ref.n_quantiles_ == min(n_quantiles, 2001)
    np.testing.assert_array_equal(_np(port.references_), np.asarray(ref.references_))
    _close(port.quantiles_, ref.quantiles_, rtol=QRTOL)


@pytest.mark.parametrize("dist", ["uniform", "normal"])
def test_quantile_transformer_maps_as_the_reference(dist):
    x = _data(26, n=1501)
    ref = rp.QuantileTransformer(n_quantiles=200, output_distribution=dist).fit(x)
    port = quantile_transformer_from_reference(
        {k: np.asarray(getattr(ref, k)) for k in ("quantiles_", "references_", "n_quantiles_",
                                                  "n_features_in_")},
        output_distribution=dist)
    probe = np.concatenate([x, x.min(0, keepdims=True) - 1, x.max(0, keepdims=True) + 1])
    atol = 1e-6 if dist == "uniform" else 1e-5
    np.testing.assert_allclose(_np(port.transform(probe)), np.asarray(ref.transform(probe)),
                               atol=atol, rtol=0)
    back = np.asarray(ref.transform(x))
    np.testing.assert_allclose(_np(port.inverse_transform(back)),
                               np.asarray(ref.inverse_transform(back)), rtol=1e-5, atol=1e-5)


def test_quantile_transformer_ties_map_to_the_last_reference_of_their_run():
    rng = np.random.RandomState(27)
    x = rng.randint(0, 5, (800, 2)).astype(np.float32)  # long runs of tied quantiles
    port = pp.QuantileTransformer(n_quantiles=100).fit(x)
    ref = rp.QuantileTransformer(n_quantiles=100).fit(x)
    np.testing.assert_array_equal(_np(port.quantiles_), np.asarray(ref.quantiles_))
    got, want = _np(port.transform(x)), np.asarray(ref.transform(x))
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    q, refs = np.asarray(ref.quantiles_)[:, 0], np.asarray(ref.references_)
    for v in range(4):  # below the top run, a value maps to the last of its run
        run = np.flatnonzero(q == v)
        assert run.size > 1 and (got[x[:, 0] == v, 0] == refs[run[-1]]).all()


def test_interp_cols_is_jnp_interp():
    rng = np.random.RandomState(28)
    xp = np.sort(rng.standard_normal((40, 3)), axis=0).astype(np.float32)
    xp[10:15, 1] = xp[10, 1]  # a tied run
    fp = np.sort(rng.uniform(0, 1, (40, 3)), axis=0).astype(np.float32)
    x = np.concatenate([rng.standard_normal((300, 3)) * 2, xp]).astype(np.float32)
    got = _np(data._interp_cols(torch.from_numpy(x), torch.from_numpy(xp), torch.from_numpy(fp)))
    for j in range(3):
        want = np.asarray(jnp.interp(jnp.asarray(x[:, j]), jnp.asarray(xp[:, j]),
                                     jnp.asarray(fp[:, j])))
        np.testing.assert_allclose(got[:, j], want, atol=1e-7, rtol=0)


def test_quantile_transformer_rejects_a_bad_distribution():
    with pytest.raises(ValueError):
        pp.QuantileTransformer(output_distribution="cauchy").fit(_data())


@pytest.mark.parametrize("norm", ["l1", "l2", "max"])
def test_normalizer_matches_reference(norm):
    x = _data(29, offset=0.0)
    x[3] = 0.0
    port, ref = pp.Normalizer(norm=norm).fit(x), rp.Normalizer(norm=norm).fit(x)
    assert port.n_features_in_ == ref.n_features_in_
    got = _np(port.transform(x))
    np.testing.assert_allclose(got, np.asarray(ref.transform(x)), rtol=QRTOL, atol=1e-7)
    assert not got[3].any()
    with pytest.raises(ValueError):
        pp.Normalizer(norm="l3").fit(x)


@pytest.mark.parametrize("degree,interaction_only,include_bias",
                         [(2, False, True), (3, False, False), (3, True, True)])
def test_polynomial_features_match_reference(degree, interaction_only, include_bias):
    x = _data(30, n=200, d=4, offset=0.5)
    kw = dict(degree=degree, interaction_only=interaction_only, include_bias=include_bias)
    port, ref = pp.PolynomialFeatures(**kw).fit(x), rp.PolynomialFeatures(**kw).fit(x)
    assert port.combinations_ == ref.combinations_
    np.testing.assert_array_equal(port.powers_, ref.powers_)
    np.testing.assert_array_equal(port.get_feature_names_out(), ref.get_feature_names_out())
    np.testing.assert_allclose(_np(port.transform(x)), np.asarray(ref.transform(x)), rtol=QRTOL)
    with pytest.raises(ValueError):
        port.transform(x[:, :3])


def test_polynomial_features_keep_a_dataframe():
    pd = pytest.importorskip("pandas")
    df = pd.DataFrame(_data(31, n=50, d=2), columns=["a", "b"], index=np.arange(50) * 2)
    port = pp.PolynomialFeatures(preserve_dataframe=True).fit(df)
    ref = rp.PolynomialFeatures(preserve_dataframe=True).fit(df)
    got, want = port.transform(df), ref.transform(df)
    assert list(got.columns) == list(want.columns) and (got.index == df.index).all()
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy(), rtol=QRTOL)


def test_one_to_one_feature_names_match_reference():
    x = _data(32, n=100, d=3)
    for name in ("StandardScaler", "MinMaxScaler", "MaxAbsScaler", "RobustScaler",
                 "QuantileTransformer", "Normalizer"):
        port, ref = getattr(pp, name)().fit(x), getattr(rp, name)().fit(x)
        np.testing.assert_array_equal(port.get_feature_names_out(), ref.get_feature_names_out())
        names = ["a", "b", "c"]
        np.testing.assert_array_equal(port.get_feature_names_out(names),
                                      ref.get_feature_names_out(names))
        with pytest.raises(ValueError):
            port.get_feature_names_out(["a"])


def test_label_encoder_matches_reference():
    y = np.array([3, 1, 7, 1, 3, 3, 9])
    port, ref = pp.LabelEncoder().fit(y), rp.LabelEncoder().fit(y)
    np.testing.assert_array_equal(port.classes_, ref.classes_)
    np.testing.assert_array_equal(_np(port.transform(y)), np.asarray(ref.transform(y)))
    np.testing.assert_array_equal(port.inverse_transform(port.transform(y)), y)
    ys = shard_rows(y.astype(np.float32))
    out = port.transform(ys)
    assert isinstance(out, ShardedRows)
    np.testing.assert_array_equal(_np(out), np.asarray(ref.transform(y)))
    with pytest.raises(ValueError, match="unseen"):
        port.transform(np.array([1, 4]))
    with pytest.raises(ValueError, match="unseen"):
        port.transform(shard_rows(np.array([1.0, 4.0], np.float32)))
    with pytest.raises(ValueError):
        port.inverse_transform(np.array([0, 9]))
    with pytest.raises(ValueError):
        pp.LabelEncoder().fit(np.ones((2, 2)))


def test_label_encoder_strings():
    y = np.array(["b", "a", "c", "a"])
    port, ref = pp.LabelEncoder(), rp.LabelEncoder()
    np.testing.assert_array_equal(_np(port.fit_transform(y)), np.asarray(ref.fit_transform(y)))
    np.testing.assert_array_equal(port.inverse_transform(np.array([2, 0])), ["c", "a"])


def test_block_transformer_hands_func_a_tensor():
    x = _data(33, n=101, d=3)
    seen = []

    def func(t, scale=1.0):
        seen.append(type(t))
        return t * scale

    bt = pp.BlockTransformer(func, scale=2.0).fit(x)
    np.testing.assert_allclose(_np(bt.transform(x)), 2 * x, rtol=QRTOL)
    X = shard_rows(x)
    out = bt.transform(X)
    assert isinstance(out, ShardedRows) and out.n_samples == 101
    np.testing.assert_allclose(_np(out), 2 * x, rtol=QRTOL)
    assert seen == [torch.Tensor, torch.Tensor]
    with pytest.raises(ValueError):
        pp.BlockTransformer(lambda t: t[:5]).transform(X)
    with pytest.raises(ValueError):
        pp.BlockTransformer(lambda t: t, validate=True).transform(np.ones(3))


def test_converted_scalers_transform_as_the_reference():
    x = _data(34)
    cases = (
        (rp.StandardScaler(), standard_scaler_from_reference,
         ("mean_", "var_", "scale_", "n_samples_seen_", "n_features_in_", "_pf_mean", "_pf_m2")),
        (rp.MinMaxScaler(), min_max_scaler_from_reference,
         ("data_min_", "data_max_", "data_range_", "scale_", "min_", "n_samples_seen_",
          "n_features_in_")),
        (rp.MaxAbsScaler(), max_abs_scaler_from_reference,
         ("max_abs_", "scale_", "n_samples_seen_", "n_features_in_")),
        (rp.RobustScaler(), robust_scaler_from_reference,
         ("center_", "scale_", "n_features_in_")),
    )
    for ref, convert, names in cases:
        ref.fit(x)
        port = convert({k: np.asarray(getattr(ref, k)) for k in names})
        _close(port.transform(x), ref.transform(x))
        _close(port.inverse_transform(port.transform(x)), x)
    ref = rp.StandardScaler().fit(x[:1000])
    port = standard_scaler_from_reference(
        {k: np.asarray(getattr(ref, k)) for k in cases[0][2]})
    port.partial_fit(x[1000:])
    ref.partial_fit(x[1000:])
    _close(port.mean_, ref.mean_)
    _close(port.var_, ref.var_)
    with pytest.raises(ValueError, match="missing"):
        standard_scaler_from_reference({"mean_": np.zeros(3)})


def test_env_knob_default_is_four_million(monkeypatch):
    monkeypatch.delenv("DASK_ML_TPU_TORCH_EXACT_QUANTILE_MAX_ROWS", raising=False)
    assert data._approx_rows_threshold() == 4_000_000
    monkeypatch.setenv("DASK_ML_TPU_TORCH_EXACT_QUANTILE_MAX_ROWS", "17")
    assert data._approx_rows_threshold() == 17
