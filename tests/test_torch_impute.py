"""The port's ``SimpleImputer`` against the JAX reference on the CPU, with
the same seeded numpy inputs (at most 1001 x 5), the reference on the 8
virtual CPU devices, the port at 8 logical shards.

Tolerances: medians and modes are exact (the same sort and the same
interpolation at 0.5; the same run-length mode); means to rtol 1e-6 (a
float32 sum in another order); the constant fill, the indicator columns
and ``inverse_transform`` exact.
"""

import numpy as np
import pytest
import torch

import dask_ml_tpu.impute as ri
from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu_torch import SimpleImputer, simple_imputer_from_reference
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.core.sharded import ShardedRows
from dask_ml_tpu_torch.impute import _column_modes


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
        return a.cpu().numpy()
    if hasattr(a, "n_samples") and hasattr(a, "mask"):
        return np.asarray(a.data)[: a.n_samples]
    return np.asarray(a)


def _missing(seed=0, n=1001, d=5, rounded=False):
    rng = np.random.RandomState(seed)
    x = (rng.standard_normal((n, d)) * 3 + 1).astype(np.float32)
    if rounded:
        x = np.round(x)
    x[rng.rand(n, d) < 0.15] = np.nan
    return x


@pytest.mark.parametrize("strategy", ["mean", "median", "most_frequent"])
@pytest.mark.parametrize("rounded", [False, True])
def test_statistics_match_reference(strategy, rounded):
    x = _missing(1, rounded=rounded)
    port = SimpleImputer(strategy=strategy).fit(x)
    ref = ri.SimpleImputer(strategy=strategy).fit(x)
    if strategy == "mean":
        np.testing.assert_allclose(_np(port.statistics_), np.asarray(ref.statistics_), rtol=1e-6)
    else:
        np.testing.assert_array_equal(_np(port.statistics_), np.asarray(ref.statistics_))
    got = _np(port.transform(x))
    assert not np.isnan(got).any()
    np.testing.assert_allclose(got, np.asarray(ref.transform(x)), rtol=1e-6)


def test_median_of_an_even_count_averages_the_middle_pair():
    x = np.array([[1.0], [2.0], [3.0], [4.0], [np.nan]], np.float32)
    port = SimpleImputer(strategy="median").fit(x)
    assert float(port.statistics_[0]) == 2.5  # torch.nanmedian would give 2.0
    assert float(ri.SimpleImputer(strategy="median").fit(x).statistics_[0]) == 2.5


def test_mode_ties_go_to_the_smallest_value_and_never_to_nan():
    x = np.array([[5, 1], [5, 1], [2, np.nan], [2, np.nan], [9, np.nan], [np.nan, 3]],
                 np.float32)
    port, ref = SimpleImputer(strategy="most_frequent").fit(x), ri.SimpleImputer(
        strategy="most_frequent").fit(x)
    np.testing.assert_array_equal(_np(port.statistics_), [2.0, 1.0])
    np.testing.assert_array_equal(_np(port.statistics_), np.asarray(ref.statistics_))
    modes = _np(_column_modes(torch.tensor([[np.nan], [np.nan]], dtype=torch.float32)))
    assert np.isnan(modes).all()


def test_padding_never_counts():
    x = _missing(2, n=1001, rounded=True) + 40  # padded with zeros to 1008 rows
    for strategy in ("mean", "median", "most_frequent"):
        port = SimpleImputer(strategy=strategy).fit(shard_rows(x))
        ref = ri.SimpleImputer(strategy=strategy).fit(ref_shard_rows(x))
        np.testing.assert_allclose(_np(port.statistics_), np.asarray(ref.statistics_), rtol=1e-6)
        assert (_np(port.statistics_) > 20).all()


def test_constant_and_a_non_nan_missing_value():
    x = _missing(3, rounded=True)
    x = np.where(np.isnan(x), -1.0, x).astype(np.float32)
    for kw in (dict(strategy="constant", fill_value=7.5, missing_values=-1.0),
               dict(strategy="median", missing_values=-1.0)):
        port, ref = SimpleImputer(**kw).fit(x), ri.SimpleImputer(**kw).fit(x)
        np.testing.assert_array_equal(_np(port.statistics_), np.asarray(ref.statistics_))
        np.testing.assert_array_equal(_np(port.transform(x)), np.asarray(ref.transform(x)))
    with pytest.raises(ValueError, match="fill_value"):
        SimpleImputer(strategy="constant").fit(x)
    with pytest.raises(ValueError):
        SimpleImputer(strategy="max").fit(x)


@pytest.mark.parametrize("strategy", ["mean", "constant"])
def test_add_indicator_matches_reference(strategy):
    x = _missing(4)
    x[:, 2] = np.nan_to_num(x[:, 2])  # a column with nothing missing
    kw = dict(strategy=strategy, add_indicator=True, fill_value=0.0)
    port, ref = SimpleImputer(**kw).fit(x), ri.SimpleImputer(**kw).fit(x)
    np.testing.assert_array_equal(port.indicator_features_, ref.indicator_features_)
    assert 2 not in port.indicator_features_
    out = _np(port.transform(x))
    np.testing.assert_allclose(out, np.asarray(ref.transform(x)), rtol=1e-6)
    assert out.shape == (x.shape[0], 5 + 4)
    np.testing.assert_array_equal(port.get_feature_names_out(), ref.get_feature_names_out())
    back = _np(port.inverse_transform(out))
    np.testing.assert_array_equal(np.isnan(back), np.isnan(x))
    np.testing.assert_array_equal(back, np.asarray(ref.inverse_transform(out)))
    with pytest.raises(ValueError, match="expects"):
        port.inverse_transform(out[:, :6])
    with pytest.raises(ValueError, match="add_indicator"):
        SimpleImputer().fit(x).inverse_transform(out)


def test_sharded_in_sharded_out():
    x = _missing(5, n=1001)
    port = SimpleImputer(add_indicator=True).fit(shard_rows(x))
    out = port.transform(shard_rows(x))
    assert isinstance(out, ShardedRows) and out.n_samples == 1001
    back = port.inverse_transform(out)
    assert isinstance(back, ShardedRows)
    np.testing.assert_array_equal(np.isnan(_np(back)), np.isnan(x))


def test_a_column_with_nothing_observed_raises():
    x = _missing(6, n=50)
    x[:, 1] = np.nan
    for strategy in ("mean", "median", "most_frequent"):
        with pytest.raises(ValueError, match="no observed values"):
            SimpleImputer(strategy=strategy).fit(x)


def test_converted_imputer_transforms_as_the_reference():
    x = _missing(7)
    ref = ri.SimpleImputer(strategy="median", add_indicator=True).fit(x)
    port = simple_imputer_from_reference(
        {"statistics_": np.asarray(ref.statistics_), "n_features_in_": ref.n_features_in_,
         "indicator_features_": ref.indicator_features_}, add_indicator=True)
    np.testing.assert_array_equal(_np(port.transform(x)), np.asarray(ref.transform(x)))
    np.testing.assert_array_equal(port.get_feature_names_out(), ref.get_feature_names_out())
