"""Sharded datasets: the port of ``dask_ml_tpu/data/``.

A dataset is a directory of bucket-aligned columnar shard files and a
manifest; a fit streams it through parallel reader threads merged into one
deterministic, key-shuffled block sequence:

* :mod:`.format`: the columnar block format (column payloads, optional
  zlib, a JSON footer index), byte-compatible with the reference's;
* :mod:`.manifest`: the shard ledger and the per-host split;
* :mod:`.shuffle`: the per-epoch order as key-derived permutations (a
  numpy Threefry equal to ``jax.random.fold_in``);
* :mod:`.readers`: ``DASK_ML_TPU_TORCH_DATA_READERS`` reader threads
  feeding a reorder window of ``DASK_ML_TPU_TORCH_DATA_QUEUE`` blocks.

Quick start::

    from dask_ml_tpu_torch import data

    data.write_dataset("ds/", X, y, shards=8)        # or data.convert_csv
    ds = data.ShardedDataset("ds/", key=0, epochs=2, readers=4)
    Incremental(SGDClassifier()).fit(ds)             # or stream_partial_fit
"""

from __future__ import annotations

import os

import numpy as np

from .format import (ColumnSpec, ColumnarReader, ColumnarWriter,
                     write_columnar)
from .manifest import MANIFEST_NAME, DatasetManifest, ShardInfo
from .readers import (QUEUE_ENV, READER_THREAD_NAME, READERS_ENV, ReaderFault,
                      ShardedDataset, resolve_queue_blocks, resolve_readers)
from .shuffle import as_key, epoch_plan, fold_in, key_from_seed, permutation

__all__ = [
    "ColumnSpec",
    "ColumnarReader",
    "ColumnarWriter",
    "DatasetManifest",
    "ShardInfo",
    "ShardedDataset",
    "ReaderFault",
    "MANIFEST_NAME",
    "READERS_ENV",
    "QUEUE_ENV",
    "READER_THREAD_NAME",
    "resolve_readers",
    "resolve_queue_blocks",
    "as_key",
    "key_from_seed",
    "fold_in",
    "permutation",
    "epoch_plan",
    "write_columnar",
    "write_dataset",
    "convert_csv",
    "convert_binary",
    "convert_blocks",
]

_DEFAULT_BLOCK_ROWS = 4096  # an `auto` ladder rung: pad-free by default


class _ShardSet:
    """Round-robin block router over K shard writers: complete blocks
    rotate across shards (balanced without knowing the total row count
    up front — the one-pass streaming-converter requirement)."""

    def __init__(self, out_dir: str, columns, shards: int,
                 block_rows: int, compression: str, policy=None):
        shards = int(shards)
        if shards < 1:
            raise ValueError(f"shards must be >= 1, got {shards}")
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.names = [f"shard-{i:05d}.dmltc" for i in range(shards)]
        self.writers = [
            ColumnarWriter(os.path.join(out_dir, n), columns,
                           block_rows=block_rows,
                           compression=compression, policy=policy)
            for n in self.names
        ]
        self.block_rows = self.writers[0].block_rows
        self._turn = 0
        self._pend: list[np.ndarray] | None = None

    def append(self, *cols) -> None:
        cols = [np.asarray(c) for c in cols]
        if self._pend is not None:
            cols = [np.concatenate([p, c])
                    for p, c in zip(self._pend, cols)]
            self._pend = None
        n = cols[0].shape[0]
        lo = 0
        while n - lo >= self.block_rows:
            hi = lo + self.block_rows
            self.writers[self._turn].append(*(c[lo:hi] for c in cols))
            self._turn = (self._turn + 1) % len(self.writers)
            lo = hi
        if lo < n:
            self._pend = [c[lo:] for c in cols]

    def finish(self) -> DatasetManifest:
        if self._pend is not None:
            self.writers[self._turn].append(*self._pend)
            self._pend = None
        infos = []
        for name, w in zip(self.names, self.writers):
            w.close()
            infos.append(ShardInfo(name, w.rows, w.n_blocks))
        m = DatasetManifest(
            self.writers[0].columns,
            [s for s in infos if s.blocks],  # drop empty shards
            block_rows=self.block_rows, base_dir=self.out_dir,
            compression=self.writers[0].compression)
        for s in infos:
            if not s.blocks:
                os.unlink(os.path.join(self.out_dir, s.path))
        m.save(self.out_dir)
        return m


def _xy_columns(n_features: int, label: bool, label_dtype: str):
    cols = [ColumnSpec("X", "float32", (int(n_features),))]
    if label:
        cols.append(ColumnSpec("y", label_dtype))
    return cols


def write_dataset(out_dir: str, X, y=None, *, shards: int = 4,
                  block_rows: int = _DEFAULT_BLOCK_ROWS,
                  compression: str = "zlib",
                  policy=None) -> DatasetManifest:
    """Write in-memory arrays as a sharded columnar dataset (for tests and
    benchmarks; out-of-core sources use the converters below)."""
    X = np.ascontiguousarray(X, dtype=np.float32)
    cols = _xy_columns(X.shape[1], y is not None,
                       str(np.asarray(y).dtype) if y is not None
                       else "int32")
    ss = _ShardSet(out_dir, cols, shards, block_rows, compression,
                   policy=policy)
    ss.append(*((X, np.asarray(y)) if y is not None else (X,)))
    return ss.finish()


def convert_blocks(out_dir: str, blocks, *, n_features: int,
                   shards: int = 4,
                   block_rows: int = _DEFAULT_BLOCK_ROWS,
                   label_col: int | None = None,
                   label_dtype: str = "int32",
                   compression: str = "zlib",
                   policy=None) -> DatasetManifest:
    """Convert any iterator of row slabs (each ``(rows, n_features)``,
    or ``(rows, n_features + 1)`` when ``label_col`` is set) into a
    sharded columnar dataset — one streaming pass, bounded memory.

    ``label_col`` names the column to split off as the target ``y``
    (negative indices allowed); the remaining columns become ``X``."""
    d = int(n_features) - (0 if label_col is None else 1)
    if d < 1:
        raise ValueError(
            f"converting {n_features} columns with label_col="
            f"{label_col} leaves {d} feature column(s)")
    cols = _xy_columns(d, label_col is not None, label_dtype)
    ss = _ShardSet(out_dir, cols, shards, block_rows, compression,
                   policy=policy)
    for slab in blocks:
        slab = np.asarray(slab)
        if slab.ndim != 2 or slab.shape[1] != int(n_features):
            raise ValueError(
                f"converter slab shape {slab.shape} != "
                f"(rows, {n_features})")
        if label_col is None:
            ss.append(np.ascontiguousarray(slab, dtype=np.float32))
        else:
            # split the label off BEFORE the float32 feature cast:
            # integer id-like labels above 2**24 would silently lose
            # precision through a float32 round-trip
            lc = label_col % slab.shape[1]
            y = slab[:, lc].astype(label_dtype)
            Xs = np.ascontiguousarray(
                np.delete(slab, lc, axis=1), dtype=np.float32)
            ss.append(Xs, y)
    return ss.finish()


def convert_csv(path: str, out_dir: str, *, has_header: bool = False,
                csv_block_rows: int = 65536, **kwargs) -> DatasetManifest:
    """Convert a numeric CSV (through the native windowed parser,
    ``io.stream_csv_blocks``: the file is never resident whole) into a
    sharded columnar dataset.  Keyword args as :func:`convert_blocks`."""
    from .. import io as _io

    first = None
    for blk in _io.stream_csv_blocks(path, 1, has_header=has_header):
        first = blk
        break
    if first is None:
        raise ValueError(f"{path}: empty CSV, nothing to convert")
    n_features = first.shape[1]
    return convert_blocks(
        out_dir,
        _io.stream_csv_blocks(path, int(csv_block_rows),
                              has_header=has_header),
        n_features=n_features, **kwargs)


def convert_binary(path: str, out_dir: str, *, n_features: int,
                   offset_bytes: int = 0, bin_block_rows: int = 65536,
                   **kwargs) -> DatasetManifest:
    """Convert a raw little-endian float32 file
    (``io.stream_binary_blocks``) into a sharded columnar dataset."""
    from .. import io as _io

    return convert_blocks(
        out_dir,
        _io.stream_binary_blocks(path, int(bin_block_rows),
                                 int(n_features),
                                 offset_bytes=offset_bytes),
        n_features=int(n_features), **kwargs)
