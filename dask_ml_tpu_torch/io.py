"""Host IO: the port of ``dask_ml_tpu/io.py``.

Numeric CSV and raw little-endian float32 files are read by the native
loader (``native/loader.cpp``, host-only C++ with a C interface, a copy of
the reference's), built with ``g++`` at first use into the git-ignored
``_build/`` beside the package, named by the hash of its source, and bound
with ``ctypes``.  The generators stream row blocks into ``_partial.fit``,
``wrappers.Incremental`` and ``pipeline.stream_partial_fit``; a sharded
columnar dataset (:mod:`.data`) is the parallel-reader successor.

``retries`` re-attempts a read or a block on an ``OSError`` with
exponential backoff, inside ``retry_deadline_s``; a shared fault budget
(``retry_budget=``) is not ported yet and raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

from .pipeline.staging import host_empty

__all__ = [
    "csv_dims",
    "read_csv",
    "read_binary",
    "stream_csv_blocks",
    "stream_binary_blocks",
    "read_csv_sharded",
    "stream_text_lines",
    "stream_dataset",
    "to_columnar",
]

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "native", "loader.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_lib = None


def _library_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libloader_{digest}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("the native loader needs g++ on PATH") from e
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"native loader build failed:\n{e.stderr}") from e
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing


def _load():
    """The loaded native loader, built at first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _library_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.dmlt_csv_dims.argtypes = [ctypes.c_char_p, ctypes.c_int, i64p, i64p]
        lib.dmlt_csv_dims.restype = ctypes.c_int
        lib.dmlt_csv_read_f32.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
                                          ctypes.c_int64, ctypes.c_int64, f32p, ctypes.c_int]
        lib.dmlt_csv_read_f32.restype = ctypes.c_int
        lib.dmlt_bin_read_f32.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                          f32p]
        lib.dmlt_bin_read_f32.restype = ctypes.c_int
        lib.dmlt_stream_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int64,
                                         ctypes.c_int, ctypes.c_int, i64p, i64p,
                                         ctypes.POINTER(ctypes.c_int)]
        lib.dmlt_stream_open.restype = ctypes.c_void_p
        lib.dmlt_stream_next.argtypes = [ctypes.c_void_p, f32p, i64p]
        lib.dmlt_stream_next.restype = ctypes.c_int
        lib.dmlt_stream_close.argtypes = [ctypes.c_void_p]
        lib.dmlt_stream_close.restype = None
        _lib = lib
        return lib


def _check(rc: int, path: str) -> None:
    if rc != 0:
        raise OSError(-rc, os.strerror(-rc) if -rc < 200 else "parse error", path)


def _no_budget(retry_budget) -> None:
    if retry_budget is not None:
        raise NotImplementedError(
            "retry_budget= (a shared FaultBudget) is not ported yet (ROADMAP: [port-planes] "
            "resilience/)")


def _retry(fn, *args, retries=0, backoff=0.1, deadline=120.0):
    """``fn(*args)``, re-attempted up to ``retries`` times on an ``OSError``
    with backoff ``backoff * 2**attempt``; a retry that would end past
    ``deadline`` seconds from the first attempt is not made."""
    t0 = time.monotonic()
    for attempt in range(int(retries) + 1):
        try:
            return fn(*args)
        except OSError:
            wait = float(backoff) * 2 ** attempt
            if attempt == int(retries) or (
                    deadline is not None and time.monotonic() - t0 + wait > deadline):
                raise
            time.sleep(wait)


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def csv_dims(path: str, *, has_header: bool = False) -> tuple[int, int]:
    """(rows, cols) of a numeric CSV, the header excluded."""
    lib = _load()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    _check(lib.dmlt_csv_dims(path.encode(), int(has_header), ctypes.byref(rows),
                             ctypes.byref(cols)), path)
    return rows.value, cols.value


def read_csv(path: str, *, has_header: bool = False, n_threads: int | None = None,
             retries: int = 0, retry_backoff: float = 0.1,
             retry_deadline_s: float | None = 120.0, retry_budget=None) -> np.ndarray:
    """A numeric CSV as a float32 ``(rows, cols)`` array, one parser thread a
    row range."""
    _no_budget(retry_budget)

    def _parse():
        lib = _load()
        rows, cols = csv_dims(path, has_header=has_header)
        out = np.empty((rows, cols), dtype=np.float32)
        nt = n_threads or min(32, os.cpu_count() or 1)
        _check(lib.dmlt_csv_read_f32(path.encode(), int(has_header), 0, rows, cols, _f32p(out),
                                     int(nt)), path)
        return out

    return _retry(_parse, retries=retries, backoff=retry_backoff, deadline=retry_deadline_s)


def read_binary(path: str, shape: tuple[int, ...], *, offset_bytes: int = 0) -> np.ndarray:
    """Raw little-endian float32 of ``shape`` from ``offset_bytes`` on.  On a
    prefetch worker the array is a page-locked buffer of its stream
    (:func:`~.pipeline.staging.host_empty`), which then goes to the device
    with no host copy."""
    lib = _load()
    out = host_empty(shape, np.float32)
    _check(lib.dmlt_bin_read_f32(path.encode(), int(offset_bytes), int(out.size), _f32p(out)),
           path)
    return out


def stream_csv_blocks(path: str, block_rows: int, *, has_header: bool = False,
                      n_threads: int | None = None, prefetch: int = 2, retries: int = 0,
                      retry_backoff: float = 0.1, retry_deadline_s: float | None = 120.0,
                      retry_budget=None):
    """Float32 row blocks of at most ``block_rows`` from a numeric CSV,
    through the native windowed session: the file moves through a ~32 MB
    window and is never resident whole, while a C++ worker parses
    ``prefetch`` blocks ahead.  ``retries`` re-attempts a block's fetch; the
    session keeps its position, so a failed attempt skips no rows."""
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    _no_budget(retry_budget)
    lib = _load()
    n_threads = n_threads or min(8, os.cpu_count() or 1)
    rows, cols, err = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int()
    handle = lib.dmlt_stream_open(path.encode(), int(has_header), int(block_rows),
                                  int(n_threads), int(max(prefetch, 1)), ctypes.byref(rows),
                                  ctypes.byref(cols), ctypes.byref(err))
    if not handle:
        _check(err.value, path)
    try:
        c = cols.value
        got = ctypes.c_int64()

        def _next_block():
            # a buffer a block (page-locked on a prefetch worker), filled by the
            # native copy and yielded trimmed: no second copy in Python
            buf = host_empty((block_rows, max(c, 1)), np.float32)
            _check(lib.dmlt_stream_next(handle, _f32p(buf), ctypes.byref(got)), path)
            return buf

        while True:
            buf = _retry(_next_block, retries=retries, backoff=retry_backoff,
                         deadline=retry_deadline_s)
            if got.value == 0:
                break
            yield buf[: got.value]
    finally:
        lib.dmlt_stream_close(handle)


def stream_binary_blocks(path: str, block_rows: int, n_features: int, *,
                         n_rows: int | None = None, offset_bytes: int = 0, retries: int = 0,
                         retry_backoff: float = 0.1, retry_deadline_s: float | None = 120.0,
                         retry_budget=None):
    """Float32 row blocks of at most ``block_rows`` from a raw little-endian
    float32 file.  ``n_rows`` defaults to every complete row after
    ``offset_bytes`` (a trailing partial row is ignored).  The extent is
    checked when this is called, not at the first block: a truncated file
    fails before any block is trained on.  Reads are offset-addressed, so a
    retried block skips no rows."""
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    if n_features < 1:
        raise ValueError(f"n_features must be >= 1, got {n_features}")
    if offset_bytes < 0:
        raise ValueError(f"offset_bytes must be >= 0, got {offset_bytes}")
    _no_budget(retry_budget)
    row_bytes = 4 * int(n_features)
    try:
        total = os.path.getsize(path)
    except OSError as e:
        raise OSError(e.errno or 2, e.strerror or "stat failed", path)
    if n_rows is None:
        n_rows = max(total - int(offset_bytes), 0) // row_bytes
    n_rows = int(n_rows)
    need = int(offset_bytes) + n_rows * row_bytes
    if need > total:
        raise ValueError(
            f"{path}: {n_rows} rows x {n_features} float32 features at offset {offset_bytes} "
            f"needs {need} bytes, file has {total} — truncated file or wrong shape")

    def _blocks():
        def _read_block(lo, rows):
            return read_binary(path, (rows, int(n_features)),
                               offset_bytes=int(offset_bytes) + lo * row_bytes)

        for lo in range(0, n_rows, int(block_rows)):
            rows = min(int(block_rows), n_rows - lo)
            yield _retry(_read_block, lo, rows, retries=retries, backoff=retry_backoff,
                         deadline=retry_deadline_s)

    return _blocks()


def stream_text_lines(path: str, block_lines: int = 10_000, *, retries: int = 0,
                      retry_backoff: float = 0.1, retry_deadline_s: float | None = 120.0,
                      retry_budget=None):
    """Lists of at most ``block_lines`` lines (newlines stripped), the file
    read incrementally.  Reads are byte-offset-addressed: a retried block
    reopens, seeks to its start and reads the same lines again."""
    if block_lines < 1:
        raise ValueError(f"block_lines must be >= 1, got {block_lines}")
    _no_budget(retry_budget)
    state: dict = {"pos": 0, "f": None}

    def _read_block():
        f = state["f"]
        if f is None or f.closed:
            f = state["f"] = open(path, "r", encoding="utf-8")
        f.seek(state["pos"])
        # readline, not iteration: read-ahead would make tell() illegal
        block: list[str] = []
        while len(block) < block_lines:
            line = f.readline()
            if not line:
                break
            block.append(line.rstrip("\n"))
        state["pos"] = f.tell()
        return block

    try:
        while True:
            block = _retry(_read_block, retries=retries, backoff=retry_backoff,
                           deadline=retry_deadline_s)
            if not block:
                break
            yield block
    finally:
        if state["f"] is not None and not state["f"].closed:
            state["f"].close()


def read_csv_sharded(path: str, *, has_header: bool = False, device=None, retries: int = 0,
                     retry_backoff: float = 0.1):
    """A CSV parsed and placed as a padded ``ShardedRows`` on ``device``
    (default: the active one)."""
    from .core.sharded import shard_rows

    return shard_rows(read_csv(path, has_header=has_header, retries=retries,
                               retry_backoff=retry_backoff), device=device)


#: file suffixes ``to_columnar`` reads as raw float32 (anything else is CSV)
_BINARY_SUFFIXES = (".bin", ".raw", ".f32")


def to_columnar(path: str, out_dir: str, *, source: str = "auto", n_features: int | None = None,
                has_header: bool = False, label_col: int | None = None, shards: int = 4,
                block_rows: int = 4096, compression: str = "zlib"):
    """A CSV or raw float32 file converted into a sharded columnar dataset
    (:mod:`.data`) in one streaming pass; ``label_col`` becomes the target
    ``y``.  Returns the :class:`~.data.DatasetManifest`."""
    from . import data as _data

    if source == "auto":
        source = "binary" if path.lower().endswith(_BINARY_SUFFIXES) else "csv"
    if source == "csv":
        return _data.convert_csv(path, out_dir, has_header=has_header, label_col=label_col,
                                 shards=shards, block_rows=block_rows, compression=compression)
    if source == "binary":
        if n_features is None:
            raise ValueError("to_columnar needs n_features for a raw binary source")
        return _data.convert_binary(path, out_dir, n_features=int(n_features),
                                    label_col=label_col, shards=shards, block_rows=block_rows,
                                    compression=compression)
    raise ValueError(f"source must be 'auto', 'csv', or 'binary', got {source!r}")


def stream_dataset(path, **kwargs):
    """A sharded columnar dataset (a manifest, its path or its directory) as
    a :class:`~.data.ShardedDataset`: feed it to ``_partial.fit``,
    ``wrappers.Incremental`` or ``pipeline.stream_partial_fit``."""
    from .data import ShardedDataset

    return ShardedDataset(path, **kwargs)
