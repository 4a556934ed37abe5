"""The port's host IO (``dask_ml_tpu_torch/io.py``, its copy of the native
loader) against the JAX reference's ``dask_ml_tpu/io.py`` on the same
temporary files, on the CPU.

Tolerance: none; every array read by the port equals the reference's
(``assert_array_equal``: same values, dtype float32, same shape).
"""

import os

import numpy as np
import pytest

from dask_ml_tpu import io as ref_io
from dask_ml_tpu_torch import io


@pytest.fixture(scope="module")
def csv_file(tmp_path_factory):
    rng = np.random.RandomState(0)
    X = np.round(rng.normal(size=(537, 6)).astype(np.float32), 5)
    p = tmp_path_factory.mktemp("tio") / "data.csv"
    np.savetxt(p, X, delimiter=",", fmt="%.5f", header="a,b,c,d,e,f", comments="")
    return str(p), X


@pytest.fixture(scope="module")
def bin_file(tmp_path_factory):
    X = np.random.RandomState(1).standard_normal((1003, 7)).astype(np.float32)
    p = tmp_path_factory.mktemp("tio") / "data.f32"
    X.tofile(p)
    return str(p), X


def test_the_loader_builds_into_the_ignored_build_directory():
    lib = io._load()
    path = io._library_path()
    assert os.path.dirname(path) == io.BUILD_DIR
    assert os.path.basename(io.BUILD_DIR) == "_build" and os.path.exists(path)
    assert os.path.basename(path).startswith("libloader_") and path.endswith(".so")
    assert lib is io._load()  # built once, then kept
    src = os.path.join(os.path.dirname(io.__file__), "native", "loader.cpp")
    ref_src = os.path.join(os.path.dirname(ref_io.__file__), "native", "loader.cpp")
    assert open(src, "rb").read() == open(ref_src, "rb").read()


def test_read_csv_and_dims_equal_the_reference(csv_file):
    p, X = csv_file
    assert io.csv_dims(p, has_header=True) == ref_io.csv_dims(p, has_header=True) == X.shape
    got = io.read_csv(p, has_header=True, n_threads=3)
    want = ref_io.read_csv(p, has_header=True, n_threads=3)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, X, rtol=1e-5)


@pytest.mark.parametrize("block_rows", [1, 100, 537, 1000])
def test_stream_csv_blocks_equal_the_reference(csv_file, block_rows):
    p, _ = csv_file
    got = list(io.stream_csv_blocks(p, block_rows, has_header=True, n_threads=2))
    want = list(ref_io.stream_csv_blocks(p, block_rows, has_header=True, n_threads=2))
    assert [b.shape for b in got] == [b.shape for b in want]
    assert got[-1].shape[0] == 537 - (len(got) - 1) * block_rows  # the ragged last block
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_read_binary_equals_the_reference_and_reads_into_lent_buffers(bin_file):
    from dask_ml_tpu_torch.pipeline import Stager, reading_for

    p, X = bin_file
    got = io.read_binary(p, (10, 7), offset_bytes=4 * 7 * 5)
    np.testing.assert_array_equal(got, ref_io.read_binary(p, (10, 7), offset_bytes=4 * 7 * 5))
    np.testing.assert_array_equal(got, X[5:15])
    stager = Stager("cpu", 2)
    with reading_for(stager):  # as on a prefetch worker: into the stream's buffers
        lent = io.read_binary(p, (10, 7), offset_bytes=4 * 7 * 5)
        assert lent is stager._sources[0][1]
        np.testing.assert_array_equal(lent, X[5:15])
        del lent
        again = io.read_binary(p, (10, 7))
        assert again is stager._sources[0][1]  # nobody held it: lent again
        np.testing.assert_array_equal(again, X[:10])


@pytest.mark.parametrize("block_rows, n_rows, offset", [(256, None, 0), (1003, None, 0),
                                                        (100, 450, 28), (5000, None, 0)])
def test_stream_binary_blocks_equal_the_reference(bin_file, block_rows, n_rows, offset):
    p, _ = bin_file
    kw = dict(n_rows=n_rows, offset_bytes=offset)
    got = list(io.stream_binary_blocks(p, block_rows, 7, **kw))
    want = list(ref_io.stream_binary_blocks(p, block_rows, 7, **kw))
    assert [b.shape for b in got] == [b.shape for b in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_a_truncated_binary_file_raises_when_the_stream_is_made(tmp_path):
    p = tmp_path / "short.f32"
    np.zeros((10, 4), np.float32).tofile(p)
    with open(p, "ab") as fh:
        fh.write(b"\0\0")  # a trailing partial row: ignored
    assert sum(b.shape[0] for b in io.stream_binary_blocks(str(p), 3, 4)) == 10
    for mod in (io, ref_io):
        with pytest.raises(ValueError, match="truncated"):
            mod.stream_binary_blocks(str(p), 3, 4, n_rows=11)  # before any block
    with pytest.raises(OSError):
        io.stream_binary_blocks(str(tmp_path / "missing.f32"), 3, 4)


def test_bad_inputs_raise_like_the_reference(tmp_path, csv_file):
    p = tmp_path / "bad.csv"
    p.write_text("1.0,2.0\nfoo,bar\n")
    for mod in (io, ref_io):
        with pytest.raises(OSError):
            mod.read_csv(str(p))
        with pytest.raises(ValueError, match="block_rows"):
            list(mod.stream_csv_blocks(csv_file[0], 0))


def test_retries_reread_a_block_after_an_oserror(monkeypatch, bin_file):
    p, X = bin_file
    real, calls = io.read_binary, []

    def flaky(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise OSError(5, "transient", p)
        return real(*args, **kwargs)

    monkeypatch.setattr(io, "read_binary", flaky)
    blocks = list(io.stream_binary_blocks(p, 400, 7, retries=1, retry_backoff=0.0))
    np.testing.assert_array_equal(np.concatenate(blocks), X)
    assert len(calls) == 4  # 3 blocks, the second read twice
    calls.clear()
    with pytest.raises(OSError, match="transient"):
        list(io.stream_binary_blocks(p, 400, 7, retries=0))


def test_stream_text_lines_equal_the_reference(tmp_path):
    p = tmp_path / "t.txt"
    p.write_text("".join(f"line {i}\n" for i in range(23)))
    assert list(io.stream_text_lines(str(p), 5)) == list(ref_io.stream_text_lines(str(p), 5))


def test_read_csv_sharded_places_the_rows_on_the_device(csv_file):
    from dask_ml_tpu_torch.core import mesh

    mesh.set_device("cpu")
    try:
        sx = io.read_csv_sharded(csv_file[0], has_header=True)
    finally:
        mesh.set_device(None)
    assert sx.n_samples == 537
    np.testing.assert_array_equal(sx.unpad().numpy(), io.read_csv(csv_file[0], has_header=True))
