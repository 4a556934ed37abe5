"""The port's encoders (``OneHotEncoder``, ``OrdinalEncoder``) and the
DataFrame transformers (``Categorizer``, ``DummyEncoder``) against the JAX
reference on the CPU, with the same seeded numpy inputs (at most 500 x 4):
arrays of integers, floats with NaN and strings; unknown categories under
``handle_unknown="ignore"`` and ``"error"``; every ``drop``; ShardedRows
in and out; DataFrames.  Every output is held to be equal: inventories and
codes are exact, one-hot blocks are 0/1.
"""

import sys

import numpy as np
import pandas as pd
import pytest
import torch

import dask_ml_tpu.preprocessing as rp
from dask_ml_tpu.core import shard_rows as ref_shard_rows
import dask_ml_tpu_torch.preprocessing as pp
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.core.sharded import ShardedRows
from dask_ml_tpu_torch.preprocessing import _encoders


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


def _ints(seed=0, n=500, d=3, k=5):
    return np.random.RandomState(seed).randint(0, k, (n, d))


def _floats_with_nan(seed=1, n=400):
    x = _ints(seed, n, 2, 6).astype(np.float64) * 0.5
    x[::11, 0] = np.nan
    return x


def _strings(seed=2, n=300):
    words = np.array(["red", "green", "blue", "cyan"], dtype=object)
    x = words[np.random.RandomState(seed).randint(0, 4, (n, 2))]
    x[::17, 1] = None
    return x


@pytest.mark.parametrize("make", [_ints, _floats_with_nan, _strings])
def test_one_hot_matches_reference(make):
    x = make()
    port = pp.OneHotEncoder(handle_unknown="ignore").fit(x)
    ref = rp.OneHotEncoder(handle_unknown="ignore").fit(x)
    assert len(port.categories_) == len(ref.categories_)
    for a, b in zip(port.categories_, ref.categories_):
        np.testing.assert_array_equal(a, b)
    got, want = _np(port.transform(x)), np.asarray(ref.transform(x))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.get_feature_names_out(), ref.get_feature_names_out())


def test_one_hot_unknown_values():
    x = _ints(3)
    port, ref = pp.OneHotEncoder(handle_unknown="ignore").fit(x), rp.OneHotEncoder(
        handle_unknown="ignore").fit(x)
    probe = np.array([[0, 9, 4], [7, 1, 2]])
    got = _np(port.transform(probe))
    np.testing.assert_array_equal(got, np.asarray(ref.transform(probe)))
    assert got[0, 5:10].sum() == 0  # feature 1's unknown 9 is a row of zeros
    strict = pp.OneHotEncoder().fit(x)
    with pytest.raises(ValueError, match="unknown"):
        strict.transform(probe)
    with pytest.raises(ValueError):
        pp.OneHotEncoder(handle_unknown="bogus").fit(x)


@pytest.mark.parametrize("drop", ["first", "if_binary", "array"])
def test_one_hot_drop_matches_reference(drop):
    x = _ints(4, d=3, k=4)
    x[:, 2] = x[:, 2] % 2  # a binary feature
    spec = np.array([2, 0, 1]) if drop == "array" else drop
    port, ref = pp.OneHotEncoder(drop=spec).fit(x), rp.OneHotEncoder(drop=spec).fit(x)
    np.testing.assert_array_equal(port.drop_idx_, ref.drop_idx_)
    got = _np(port.transform(x))
    np.testing.assert_array_equal(got, np.asarray(ref.transform(x)))
    np.testing.assert_array_equal(port.inverse_transform(got), ref.inverse_transform(got))
    np.testing.assert_array_equal(port.inverse_transform(got), x)
    np.testing.assert_array_equal(port.get_feature_names_out(), ref.get_feature_names_out())
    with pytest.raises(ValueError):
        pp.OneHotEncoder(drop=np.array([9, 0, 1])).fit(x)


def test_one_hot_given_categories_keep_their_order():
    x = _ints(5, d=1, k=3)
    cats = [np.array([2, 0, 1])]
    port, ref = pp.OneHotEncoder(categories=cats).fit(x), rp.OneHotEncoder(categories=cats).fit(x)
    np.testing.assert_array_equal(_np(port.transform(x)), np.asarray(ref.transform(x)))


def test_one_hot_sharded_in_sharded_out_and_sparse():
    x = _ints(6, n=301)
    port = pp.OneHotEncoder().fit(shard_rows(x))
    out = port.transform(shard_rows(x))
    assert isinstance(out, ShardedRows) and out.n_samples == 301 and out.padded == 304
    ref = rp.OneHotEncoder().fit(ref_shard_rows(x))
    np.testing.assert_array_equal(_np(out), _np(ref.transform(ref_shard_rows(x))))
    sparse = pp.OneHotEncoder(sparse_output=True).fit(x).transform(x)
    np.testing.assert_array_equal(sparse.toarray(), _np(port.transform(x)))


def test_one_hot_dataframes_match_reference():
    df = pd.DataFrame({"a": pd.Categorical(["x", "y", "x", "z"]), "b": [1, 2, 2, 1]})
    port, ref = pp.OneHotEncoder().fit(df), rp.OneHotEncoder().fit(df)
    pd.testing.assert_frame_equal(port.transform(df), ref.transform(df))
    np.testing.assert_array_equal(port.get_feature_names_out(), ref.get_feature_names_out())
    with pytest.raises(ValueError):
        port.transform(df[["b", "a"]])
    with pytest.raises(ValueError):
        pp.OneHotEncoder().fit(_ints()).transform(df)


def test_one_hot_inverse_transform_matches_reference():
    x = _strings(7)
    x[x == None] = "red"  # noqa: E711 (an object array's missing entries)
    port, ref = pp.OneHotEncoder().fit(x), rp.OneHotEncoder().fit(x)
    oh = _np(port.transform(x))
    np.testing.assert_array_equal(port.inverse_transform(oh), ref.inverse_transform(oh))
    np.testing.assert_array_equal(port.inverse_transform(oh), x)


@pytest.mark.parametrize("make", [_ints, _floats_with_nan, _strings])
def test_encode_column_is_pandas_codes(make):
    x = make()
    for j in range(x.shape[1]):
        cats = _encoders._column_categories(x[:, j])
        codes, known = _encoders._encode_column(cats, x[:, j])
        want = np.asarray(pd.Categorical(x[:, j], categories=cats).codes)
        np.testing.assert_array_equal(codes, want)
        assert codes.dtype == want.dtype
        np.testing.assert_array_equal(known, want >= 0)


def test_ordinal_encoder_arrays_match_reference():
    x = _ints(8)
    port, ref = pp.OrdinalEncoder().fit(x), rp.OrdinalEncoder().fit(x)
    got = _np(port.transform(x))
    np.testing.assert_array_equal(got, np.asarray(ref.transform(x)))
    np.testing.assert_array_equal(port.inverse_transform(got), x)
    np.testing.assert_array_equal(port.get_feature_names_out(), ref.get_feature_names_out())
    np.testing.assert_array_equal(port.get_feature_names_out(["a", "b", "c"]), ["a", "b", "c"])
    with pytest.raises(ValueError):
        port.get_feature_names_out(["a"])
    with pytest.raises(ValueError, match="unknown"):
        port.transform(np.array([[0, 0, 99]]))
    out = port.transform(shard_rows(x))
    assert isinstance(out, ShardedRows)
    np.testing.assert_array_equal(_np(out), got)


def test_ordinal_encoder_strings_match_reference():
    x = _strings(9)
    x[x == None] = "blue"  # noqa: E711
    port, ref = pp.OrdinalEncoder().fit(x), rp.OrdinalEncoder().fit(x)
    got = _np(port.transform(x))
    np.testing.assert_array_equal(got, np.asarray(ref.transform(x)))
    np.testing.assert_array_equal(port.inverse_transform(got), ref.inverse_transform(got))


def test_ordinal_encoder_dataframes_match_reference():
    df = pd.DataFrame({"a": ["u", "v", "u", "w"], "b": [1.0, 2.0, 3.0, 4.0],
                       "c": pd.Categorical(["p", "q", "p", "p"])})
    port, ref = pp.OrdinalEncoder().fit(df), rp.OrdinalEncoder().fit(df)
    got, want = port.transform(df), ref.transform(df)
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(port.inverse_transform(got), ref.inverse_transform(want))
    np.testing.assert_array_equal(port.get_feature_names_out(), ref.get_feature_names_out())


def test_categorizer_and_dummy_encoder_match_reference():
    df = pd.DataFrame({"a": ["x", "y", "x", None, "z"], "b": [1, 2, 3, 4, 5],
                       "c": pd.Categorical(["p", "q", "p", "q", "p"])})
    port, ref = pp.Categorizer().fit(df), rp.Categorizer().fit(df)
    assert list(port.categories_) == list(ref.categories_)
    cat_p, cat_r = port.transform(df), ref.transform(df)
    pd.testing.assert_frame_equal(cat_p, cat_r)
    for drop_first in (False, True):
        dp = pp.DummyEncoder(drop_first=drop_first).fit(cat_p)
        dr = rp.DummyEncoder(drop_first=drop_first).fit(cat_r)
        pd.testing.assert_frame_equal(dp.transform(cat_p), dr.transform(cat_r))
        pd.testing.assert_frame_equal(dp.inverse_transform(dp.transform(cat_p)),
                                      dr.inverse_transform(dr.transform(cat_r)))
    with pytest.raises(TypeError):
        pp.Categorizer().fit(np.ones((2, 2)))
    with pytest.raises(ValueError, match="Categorizer"):
        pp.DummyEncoder(columns=["b"]).fit(df)


def test_dataframe_transformers_say_so_without_pandas(monkeypatch):
    monkeypatch.setitem(sys.modules, "pandas", None)  # an import of pandas now fails
    with pytest.raises(ImportError, match="pandas"):
        pp.Categorizer().fit(np.ones((2, 2)))
    with pytest.raises(ImportError, match="pandas"):
        pp.DummyEncoder().fit(np.ones((2, 2)))
    x = _ints(10)  # arrays still encode
    np.testing.assert_array_equal(_np(pp.OrdinalEncoder().fit(x).transform(x)), x)
