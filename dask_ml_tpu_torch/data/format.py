"""The columnar block format: the port of ``dask_ml_tpu/data/format.py``,
byte-compatible with it in both directions.

A file is ``DMLTCOL1``, then a sequence of blocks holding the same columns
(e.g. ``X`` float32[d] and ``y`` int32), each stored column-contiguous
and optionally zlib-compressed, then a JSON footer indexing the blocks
(offset, byte length, rows) and a fixed tail (footer offset, footer
length, ``DMLTCOLF``).  Every block but possibly the last holds exactly
``block_rows`` rows, and the writer refuses a ``block_rows`` that is not a
rung of the bucket ladder (``programs/bucket.py``), so streamed blocks
reach the step already bucket-sized.  A reader validates the whole index
at open: a truncated shard fails there, not in the middle of an epoch.
``ColumnarReader.read_block`` uses ``os.pread`` on one shared descriptor,
so reader threads need no lock.  Numpy and the standard library only.
"""

from __future__ import annotations

import json
import os
import zlib

import numpy as np

__all__ = [
    "MAGIC",
    "TAIL_MAGIC",
    "ColumnSpec",
    "ColumnarWriter",
    "ColumnarReader",
    "write_columnar",
]

MAGIC = b"DMLTCOL1"
TAIL_MAGIC = b"DMLTCOLF"
_TAIL_LEN = 8 + 8 + len(TAIL_MAGIC)  # u64 footer offset, u64 len, magic
_VERSION = 1

#: dtypes a column may declare — little-endian fixed-width only (the
#: format is a wire format; platform-dependent widths would make shards
#: non-portable between writer and reader hosts)
_DTYPES = ("float32", "float64", "int32", "int64", "uint32", "uint8")


class ColumnSpec:
    """One column's schema: ``name``, ``dtype`` (from the fixed-width
    whitelist), and ``shape`` — the per-row trailing shape (``()`` for a
    scalar column like targets, ``(d,)`` for feature rows)."""

    __slots__ = ("name", "dtype", "shape")

    def __init__(self, name: str, dtype: str, shape=()):
        dtype = str(np.dtype(dtype))
        if dtype not in _DTYPES:
            raise ValueError(
                f"column {name!r}: dtype {dtype!r} not in the format's "
                f"fixed-width whitelist {_DTYPES}")
        self.name = str(name)
        self.dtype = dtype
        self.shape = tuple(int(s) for s in shape)
        if any(s < 1 for s in self.shape):
            raise ValueError(
                f"column {name!r}: trailing shape {self.shape} must be "
                f"positive")

    def row_items(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def row_bytes(self) -> int:
        return self.row_items() * np.dtype(self.dtype).itemsize

    def to_json(self) -> dict:
        return {"name": self.name, "dtype": self.dtype,
                "shape": list(self.shape)}

    @classmethod
    def from_json(cls, d: dict) -> "ColumnSpec":
        return cls(d["name"], d["dtype"], tuple(d.get("shape", ())))

    def __repr__(self):
        return (f"ColumnSpec({self.name!r}, {self.dtype!r}, "
                f"shape={self.shape})")


def _check_block_rows(block_rows: int, policy) -> int:
    """``block_rows`` must be a bucket rung so streamed blocks take the
    ``pad_block`` no-op fast path — the format's whole hot-path point."""
    from ..programs import bucket as _bucket

    block_rows = int(block_rows)
    if block_rows < 1:
        raise ValueError(f"block_rows must be >= 1, got {block_rows}")
    pol = _bucket.resolve_policy(policy)
    if pol.kind != "off" and pol.bucket(block_rows) != block_rows:
        raise ValueError(
            f"block_rows={block_rows} is not a rung of the bucket "
            f"ladder ({pol!r}): blocks would pad every dispatch.  Use a "
            f"ladder size (e.g. {pol.bucket(block_rows)}) or pass "
            f"policy='off' deliberately.")
    return block_rows


class ColumnarWriter:
    """Streaming writer: feed rows in arbitrary-sized slabs; blocks of
    exactly ``block_rows`` rows are emitted as they fill (one possibly-
    short tail block at ``close()``).  One pass, bounded memory (at most
    one block per column buffered)."""

    def __init__(self, path: str, columns, *, block_rows: int,
                 compression: str = "zlib", policy=None):
        if compression not in ("zlib", "none"):
            raise ValueError(
                f"compression must be 'zlib' or 'none', got "
                f"{compression!r}")
        self.path = str(path)
        self.columns = [c if isinstance(c, ColumnSpec)
                        else ColumnSpec.from_json(c) for c in columns]
        if not self.columns:
            raise ValueError("a columnar file needs at least one column")
        self.block_rows = _check_block_rows(block_rows, policy)
        self.compression = compression
        self._pending: list[list[np.ndarray]] = [[] for _ in self.columns]
        self._pending_rows = 0
        self._blocks: list[list[int]] = []  # [offset, nbytes, rows]
        self._rows = 0
        self._f = open(self.path, "wb")
        self._f.write(MAGIC)
        self._closed = False

    # -- feeding -------------------------------------------------------
    def append(self, *cols) -> None:
        """Append a slab of rows (one array per column, equal leading
        length; trailing shapes must match the schema)."""
        if self._closed:
            raise ValueError("writer is closed")
        if len(cols) != len(self.columns):
            raise ValueError(
                f"append got {len(cols)} columns, schema has "
                f"{len(self.columns)}")
        n = None
        slabs = []
        for spec, col in zip(self.columns, cols):
            a = np.ascontiguousarray(col, dtype=spec.dtype)
            if a.shape[1:] != spec.shape:
                raise ValueError(
                    f"column {spec.name!r}: trailing shape {a.shape[1:]} "
                    f"!= schema {spec.shape}")
            if n is None:
                n = a.shape[0]
            elif a.shape[0] != n:
                raise ValueError(
                    f"column {spec.name!r}: {a.shape[0]} rows, previous "
                    f"columns had {n}")
            slabs.append(a)
        if not n:
            return
        for buf, a in zip(self._pending, slabs):
            buf.append(a)
        self._pending_rows += n
        while self._pending_rows >= self.block_rows:
            self._emit(self.block_rows)

    def _emit(self, rows: int) -> None:
        take = [[] for _ in self.columns]
        left = rows
        # slice `rows` rows off the front of each column's pending slabs
        for ci, buf in enumerate(self._pending):
            need = rows
            while need:
                a = buf[0]
                if a.shape[0] <= need:
                    take[ci].append(buf.pop(0))
                    need -= a.shape[0]
                else:
                    take[ci].append(a[:need])
                    buf[0] = a[need:]
                    need = 0
        self._pending_rows -= left
        payload = b"".join(
            np.ascontiguousarray(np.concatenate(parts)
                                 if len(parts) > 1 else parts[0]).tobytes()
            for parts in take)
        if self.compression == "zlib":
            payload = zlib.compress(payload, 1)
        offset = self._f.tell()
        self._f.write(payload)
        self._blocks.append([offset, len(payload), rows])
        self._rows += rows

    # -- finishing -----------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        try:
            if self._pending_rows:
                self._emit(self._pending_rows)  # the (short) tail block
            footer = {
                "version": _VERSION,
                "block_rows": self.block_rows,
                "rows": self._rows,
                "compression": self.compression,
                "columns": [c.to_json() for c in self.columns],
                "blocks": self._blocks,
            }
            raw = json.dumps(footer, separators=(",", ":")).encode()
            off = self._f.tell()
            self._f.write(raw)
            self._f.write(off.to_bytes(8, "little"))
            self._f.write(len(raw).to_bytes(8, "little"))
            self._f.write(TAIL_MAGIC)
        finally:
            self._closed = True
            self._f.close()

    @property
    def rows(self) -> int:
        return self._rows + self._pending_rows

    @property
    def n_blocks(self) -> int:
        return len(self._blocks)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # an exception mid-write leaves a torn file: remove it rather
        # than leave a shard that fails validation at the next open
        if exc and exc[0] is not None:
            self._closed = True
            self._f.close()
            try:
                os.unlink(self.path)
            except OSError:
                pass
            return False
        self.close()
        return False


def write_columnar(path: str, columns, slabs, *, block_rows: int,
                   compression: str = "zlib", policy=None) -> int:
    """One-shot writer: drain an iterable of per-column slab tuples into
    ``path``.  Returns the row count."""
    with ColumnarWriter(path, columns, block_rows=block_rows,
                        compression=compression, policy=policy) as w:
        for slab in slabs:
            w.append(*(slab if isinstance(slab, tuple) else (slab,)))
        rows = w.rows
    return rows


class ColumnarReader:
    """Random-access block reader over one columnar shard file.

    Validates the WHOLE index at open (magic, footer extent, block
    extents, row-count sum) so corruption is an ``open`` failure, never
    a mid-epoch surprise.  ``read_block(i)`` is thread-safe without a
    lock: one shared fd, ``os.pread`` only."""

    def __init__(self, path: str):
        self.path = str(path)
        self._fd = os.open(self.path, os.O_RDONLY)
        try:
            size = os.fstat(self._fd).st_size
            if size < len(MAGIC) + _TAIL_LEN:
                raise ValueError(f"{path}: too short to be a columnar "
                                 f"shard ({size} bytes)")
            if os.pread(self._fd, len(MAGIC), 0) != MAGIC:
                raise ValueError(f"{path}: bad magic (not a "
                                 f"dask-ml-tpu columnar shard)")
            tail = os.pread(self._fd, _TAIL_LEN, size - _TAIL_LEN)
            if tail[16:] != TAIL_MAGIC:
                raise ValueError(f"{path}: bad tail magic (truncated or "
                                 f"torn write)")
            foff = int.from_bytes(tail[:8], "little")
            flen = int.from_bytes(tail[8:16], "little")
            if not (len(MAGIC) <= foff and
                    foff + flen == size - _TAIL_LEN):
                raise ValueError(f"{path}: footer extent "
                                 f"[{foff}, {foff + flen}) inconsistent "
                                 f"with file size {size}")
            footer = json.loads(os.pread(self._fd, flen, foff))
            if footer.get("version", 0) > _VERSION:
                raise ValueError(
                    f"{path}: format version {footer['version']} newer "
                    f"than this reader ({_VERSION})")
            self.block_rows = int(footer["block_rows"])
            self.rows = int(footer["rows"])
            self.compression = footer["compression"]
            self.columns = [ColumnSpec.from_json(c)
                            for c in footer["columns"]]
            self.blocks = [tuple(int(v) for v in b)
                           for b in footer["blocks"]]
            got = 0
            for off, nbytes, rows in self.blocks:
                if not (len(MAGIC) <= off and off + nbytes <= foff):
                    raise ValueError(
                        f"{path}: block extent [{off}, {off + nbytes}) "
                        f"outside the data region")
                if not 0 < rows <= self.block_rows:
                    raise ValueError(
                        f"{path}: block row count {rows} outside "
                        f"(0, {self.block_rows}]")
                got += rows
            if got != self.rows:
                raise ValueError(
                    f"{path}: block rows sum to {got}, footer declares "
                    f"{self.rows}")
        except Exception:
            os.close(self._fd)
            self._fd = -1
            raise

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)

    def read_block(self, i: int) -> tuple:
        """Decode block ``i`` into one numpy array per column (host
        memory, freshly owned — safe to hand across threads)."""
        off, nbytes, rows = self.blocks[int(i)]
        raw = os.pread(self._fd, nbytes, off)
        if len(raw) != nbytes:
            raise OSError(
                f"{self.path}: short read of block {i} "
                f"({len(raw)}/{nbytes} bytes)")
        if self.compression == "zlib":
            raw = zlib.decompress(raw)
        want = rows * sum(c.row_bytes() for c in self.columns)
        if len(raw) != want:
            raise ValueError(
                f"{self.path}: block {i} decodes to {len(raw)} bytes, "
                f"schema needs {want}")
        out = []
        pos = 0
        for c in self.columns:
            nb = rows * c.row_bytes()
            a = np.frombuffer(raw, dtype=c.dtype, count=rows * c.row_items(),
                              offset=pos).reshape((rows,) + c.shape)
            # frombuffer views are read-only over `raw`; copy so the
            # block owns its memory (and padding/donation downstream
            # may mutate freely)
            out.append(a.copy())
            pos += nb
        return tuple(out)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __repr__(self):
        return (f"ColumnarReader({self.path!r}, rows={self.rows}, "
                f"blocks={self.n_blocks}, block_rows={self.block_rows})")
