"""The port's sharded datasets (``dask_ml_tpu_torch/data/``) against the JAX
reference's ``dask_ml_tpu/data/`` on the CPU: the columnar format and the
manifest read and written both ways, the Threefry shuffle, the merged
block stream at 1 and 4 readers, the converters, and a failing reader.

Tolerance: none.  Files written by both packages from the same arrays are
byte-equal, every block read back equals the reference's, and the keys,
permutations and plans are bit-equal (to ``jax.random.fold_in`` too).
"""

import os
import threading

import jax
import numpy as np
import pytest

from dask_ml_tpu import data as ref_data
from dask_ml_tpu.data import shuffle as ref_shuffle
from dask_ml_tpu_torch import data
from dask_ml_tpu_torch.data import format as dformat
from dask_ml_tpu_torch.data import readers as dreaders
from dask_ml_tpu_torch.data import shuffle


def _xy(n=2300, d=6, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    y = (X[:, 0] + 0.1 * rng.standard_normal(n) > 0).astype(np.int32)
    return X, y


def _drain(stream):
    with stream as st:
        return [tuple(None if a is None else np.array(a) for a in blk) for blk in st]


def _assert_blocks_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if a is None or b is None:
                assert a is None and b is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def _reader_threads():
    return [t for t in threading.enumerate() if t.name == dreaders.READER_THREAD_NAME]


@pytest.mark.parametrize("compression", ["zlib", "none"])
def test_datasets_are_byte_equal_and_read_both_ways(tmp_path, compression):
    X, y = _xy()
    kw = dict(shards=3, block_rows=256, compression=compression)
    m = data.write_dataset(str(tmp_path / "port"), X, y, **kw)
    mr = ref_data.write_dataset(str(tmp_path / "ref"), X, y, **kw)
    assert m.to_json() == mr.to_json()
    for name in [data.MANIFEST_NAME] + [s.path for s in m.shards]:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()
    # each package reads the other's dataset
    for mine, theirs, src in ((data, ref_data, "ref"), (ref_data, data, "port")):
        loaded = mine.DatasetManifest.load(str(tmp_path / src))
        loaded.validate()
        assert loaded.to_json() == theirs.DatasetManifest.load(str(tmp_path / src)).to_json()
        for i in range(loaded.n_shards):
            with loaded.open_shard(i) as r, \
                    theirs.DatasetManifest.load(str(tmp_path / src)).open_shard(i) as rr:
                assert r.n_blocks == rr.n_blocks and r.block_rows == rr.block_rows == 256
                _assert_blocks_equal([r.read_block(b) for b in range(r.n_blocks)],
                                     [rr.read_block(b) for b in range(rr.n_blocks)])


def test_the_format_validates_like_the_reference(tmp_path):
    with pytest.raises(ValueError, match="not a rung"):
        dformat.ColumnarWriter(str(tmp_path / "x"), [dformat.ColumnSpec("X", "float32", (3,))],
                               block_rows=300)
    with pytest.raises(ValueError, match="whitelist"):
        dformat.ColumnSpec("X", "float16")
    X, y = _xy(600)
    m = data.write_dataset(str(tmp_path / "ds"), X, y, shards=1, block_rows=256)
    path = m.shard_path(0)
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[:-5])  # a torn write
    for mod in (dformat, ref_data.format):
        with pytest.raises(ValueError, match="tail magic"):
            mod.ColumnarReader(path)


def test_manifest_for_host_and_a_bad_manifest(tmp_path):
    X, y = _xy()
    m = data.write_dataset(str(tmp_path / "ds"), X, y, shards=5, block_rows=256)
    mr = ref_data.DatasetManifest.load(str(tmp_path / "ds"))
    for index in range(2):
        assert m.for_host(index, 2).to_json() == mr.for_host(index, 2).to_json()
    assert m.for_host().to_json() == m.to_json()  # no process group: host 0 of 1
    with pytest.raises(ValueError):
        m.for_host(2, 2)
    doc = (tmp_path / "ds" / data.MANIFEST_NAME).read_text().replace(
        '"rows": 2300', '"rows": 2301')
    (tmp_path / "ds" / data.MANIFEST_NAME).write_text(doc)
    with pytest.raises(ValueError, match="declares"):
        data.DatasetManifest.load(str(tmp_path / "ds"))


@pytest.mark.parametrize("seed", [0, 1, 42, 123456789, 2**40 + 5])
def test_the_shuffle_is_bit_equal_to_the_reference(seed):
    key = shuffle.key_from_seed(seed)
    np.testing.assert_array_equal(key, ref_shuffle.key_from_seed(seed))
    # jax without x64 keeps a seed's low 32 bits: held to jax below 2^31
    jax_key = jax.random.PRNGKey(seed) if seed < 2**31 else None
    if jax_key is not None:
        np.testing.assert_array_equal(key, np.asarray(jax_key))
    for d in (0, 1, 7, 1000, 2**31 - 1, shuffle.SHARD_ORDER_SALT):
        got = shuffle.fold_in(key, d)
        np.testing.assert_array_equal(got, ref_shuffle.fold_in(key, d))
        if jax_key is not None:
            np.testing.assert_array_equal(got, np.asarray(jax.random.fold_in(jax_key, d)))
        for n in (0, 1, 17, 300):
            np.testing.assert_array_equal(shuffle.permutation(got, n),
                                          ref_shuffle.permutation(got, n))
    blocks = [3, 1, 0, 7, 2]
    for epoch in range(4):
        p = shuffle.epoch_plan(seed, epoch, blocks)
        q = ref_shuffle.epoch_plan(seed, epoch, blocks)
        assert p.shard_order == q.shard_order and p.starts == q.starts
        assert list(p.order()) == list(q.order())
        assert p.locate(p.n_blocks - 1) == q.locate(q.n_blocks - 1)
    assert list(shuffle.epoch_plan(0, 0, blocks, shuffle=False).order()) == \
        list(ref_shuffle.epoch_plan(0, 0, blocks, shuffle=False).order())
    np.testing.assert_array_equal(shuffle.as_key(np.asarray(key, np.int64)), key)
    with pytest.raises(TypeError, match="key_data"):
        shuffle.as_key(np.zeros(2, np.float32))


@pytest.mark.parametrize("readers", [1, 4])
def test_the_merged_stream_is_the_reference_sequence(tmp_path, readers):
    X, y = _xy()
    data.write_dataset(str(tmp_path / "ds"), X, y, shards=4, block_rows=256)
    kw = dict(key=11, epochs=2)
    ds = data.ShardedDataset(str(tmp_path / "ds"), readers=readers, queue_blocks=2, **kw)
    got = _drain(ds.iter_blocks())
    want = _drain(ref_data.ShardedDataset(str(tmp_path / "ds"), readers=2, **kw).iter_blocks())
    _assert_blocks_equal(got, want)
    assert len(got) == 2 * ds.n_blocks
    assert sum(b[0].shape[0] for b in got) == 2 * X.shape[0]
    # a resumed stream replays the suffix, across the epoch boundary too
    for k in (3, ds.n_blocks + 1):
        _assert_blocks_equal(_drain(ds.iter_blocks(start=k)), got[k:])
    _assert_blocks_equal(_drain(ds.iter_blocks(epoch=1)), got[ds.n_blocks:])
    assert not _reader_threads()


def test_a_failing_reader_surfaces_on_the_consumer(tmp_path, monkeypatch):
    X, y = _xy()
    data.write_dataset(str(tmp_path / "ds"), X, y, shards=4, block_rows=256)
    real, seen = dformat.ColumnarReader.read_block, []

    def failing(self, i):
        seen.append(i)
        if len(seen) == 5:
            raise OSError(5, "disk gone", self.path)
        return real(self, i)

    monkeypatch.setattr(dformat.ColumnarReader, "read_block", failing)
    ds = data.ShardedDataset(str(tmp_path / "ds"), key=0, readers=4)
    with pytest.raises(data.ReaderFault, match="disk gone") as err:
        _drain(ds.iter_blocks())
    assert isinstance(err.value.__cause__, OSError)
    assert err.value.shard in range(4) and err.value.seq is not None
    assert not _reader_threads()
    # a reader that ends without reporting is reported too
    monkeypatch.setattr(dreaders._DatasetStream, "_reader", lambda self, rid: None)
    with pytest.raises(data.ReaderFault, match="without reporting"):
        _drain(data.ShardedDataset(str(tmp_path / "ds"), readers=2).iter_blocks())
    assert not _reader_threads()


def test_knobs_and_the_unported_budget(monkeypatch, tmp_path):
    monkeypatch.setenv(data.READERS_ENV, "3")
    monkeypatch.setenv(data.QUEUE_ENV, "")
    assert data.resolve_readers() == 3 and data.resolve_queue_blocks(readers=3) == 6
    monkeypatch.setenv(data.QUEUE_ENV, "five")
    with pytest.raises(ValueError, match="DASK_ML_TPU_TORCH_DATA_QUEUE"):
        data.resolve_queue_blocks()
    with pytest.raises(ValueError, match=">= 1"):
        data.resolve_readers(0)
    X, y = _xy(600)
    data.write_dataset(str(tmp_path / "ds"), X, y, shards=1, block_rows=256)
    with pytest.raises(NotImplementedError, match=r"\[port-planes\]"):
        data.ShardedDataset(str(tmp_path / "ds"), budget=object())


def test_the_converters_equal_the_reference(tmp_path):
    rng = np.random.RandomState(4)
    M = np.round(rng.standard_normal((700, 5)), 4).astype(np.float32)
    M[:, 2] = rng.randint(0, 3, 700)
    csv = tmp_path / "m.csv"
    np.savetxt(csv, M, delimiter=",", fmt="%.4f")
    binf = tmp_path / "m.f32"
    M.tofile(binf)
    kw = dict(label_col=2, shards=2, block_rows=256)
    from dask_ml_tpu import io as ref_io
    from dask_ml_tpu_torch import io

    for name, port_fn, ref_fn in (
            ("csv", lambda o: io.to_columnar(str(csv), o, **kw),
             lambda o: ref_io.to_columnar(str(csv), o, **kw)),
            ("bin", lambda o: io.to_columnar(str(binf), o, n_features=5, **kw),
             lambda o: ref_io.to_columnar(str(binf), o, n_features=5, **kw))):
        m = port_fn(str(tmp_path / f"p_{name}"))
        mr = ref_fn(str(tmp_path / f"r_{name}"))
        assert m.to_json() == mr.to_json() and m.rows == 700
        for s in m.shards:
            assert (tmp_path / f"p_{name}" / s.path).read_bytes() == \
                (tmp_path / f"r_{name}" / s.path).read_bytes()
        blocks = _drain(io.stream_dataset(str(tmp_path / f"p_{name}"), shuffle=False,
                                          readers=1).iter_blocks())
        np.testing.assert_array_equal(np.concatenate([b[1] for b in blocks]),
                                      np.concatenate([M[a:a + 256, 2] for a in
                                                      (0, 512, 256)]).astype(np.int32))
    slabs = (M[a:a + 100] for a in range(0, 700, 100))
    m = data.convert_blocks(str(tmp_path / "cb"), slabs, n_features=5, shards=2,
                            block_rows=256)
    assert m.rows == 700 and [c.name for c in m.columns] == ["X"]
    assert not os.path.exists(tmp_path / "cb" / "shard-00002.dmltc")
