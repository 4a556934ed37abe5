"""The dataset manifest: the port of ``dask_ml_tpu/data/manifest.py``.

A sharded dataset is its manifest: a JSON document naming the shard files
(paths relative to the manifest, so a dataset directory moves as one
unit), their row and block counts, the shared column schema and the block
geometry.  Visit order, reader assignment and resume position derive from
the manifest and a key (:mod:`.shuffle`).  ``for_host(index, count)``:
shard ``i`` belongs to host ``i % count``; the defaults read the
``torch.distributed`` rank and world size when a process group is up, and
are (0, 1) otherwise.
"""

from __future__ import annotations

import json
import os

from .format import ColumnSpec, ColumnarReader

__all__ = ["MANIFEST_NAME", "ShardInfo", "DatasetManifest"]

#: the manifest's conventional filename inside a dataset directory
MANIFEST_NAME = "manifest.json"

_VERSION = 1
_FORMAT = "dmlt-columnar-1"


def _process_topology() -> tuple[int, int]:
    """(rank, world size) of the ``torch.distributed`` group, else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _atomic_write_json(path: str, payload) -> None:
    """``payload`` as indented, key-sorted JSON with a final newline, written
    to a temporary file and moved over ``path``: a crash mid-write leaves
    the old file whole."""
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, path)
    except OSError:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class ShardInfo:
    """One shard file's ledger row: relative ``path``, ``rows``,
    ``blocks``."""

    __slots__ = ("path", "rows", "blocks")

    def __init__(self, path: str, rows: int, blocks: int):
        self.path = str(path)
        self.rows = int(rows)
        self.blocks = int(blocks)

    def to_json(self) -> dict:
        return {"path": self.path, "rows": self.rows,
                "blocks": self.blocks}

    @classmethod
    def from_json(cls, d: dict) -> "ShardInfo":
        return cls(d["path"], d["rows"], d["blocks"])

    def __repr__(self):
        return (f"ShardInfo({self.path!r}, rows={self.rows}, "
                f"blocks={self.blocks})")


class DatasetManifest:
    """The sharded dataset's schema + shard ledger (see module doc)."""

    def __init__(self, columns, shards, *, block_rows: int,
                 base_dir: str = ".", compression: str = "zlib"):
        self.columns = [c if isinstance(c, ColumnSpec)
                        else ColumnSpec.from_json(c) for c in columns]
        self.shards = [s if isinstance(s, ShardInfo)
                       else ShardInfo.from_json(s) for s in shards]
        self.block_rows = int(block_rows)
        self.base_dir = str(base_dir)
        self.compression = str(compression)

    # -- derived -------------------------------------------------------
    @property
    def rows(self) -> int:
        return sum(s.rows for s in self.shards)

    @property
    def n_blocks(self) -> int:
        return sum(s.blocks for s in self.shards)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def blocks_per_shard(self) -> list[int]:
        return [s.blocks for s in self.shards]

    def shard_path(self, i: int) -> str:
        return os.path.join(self.base_dir, self.shards[i].path)

    def open_shard(self, i: int) -> ColumnarReader:
        return ColumnarReader(self.shard_path(i))

    def for_host(self, index: int | None = None,
                 count: int | None = None) -> "DatasetManifest":
        """The sub-manifest of shards this host owns (``i % count ==
        index``); the defaults are this process's ``torch.distributed``
        rank and world size, (0, 1) without a process group."""
        if index is None or count is None:
            rank, world = _process_topology()
            index = rank if index is None else int(index)
            count = world if count is None else int(count)
        index, count = int(index), int(count)
        if not 0 <= index < count:
            raise ValueError(
                f"host index {index} outside [0, {count})")
        return DatasetManifest(
            self.columns,
            [s for i, s in enumerate(self.shards) if i % count == index],
            block_rows=self.block_rows, base_dir=self.base_dir,
            compression=self.compression)

    # -- persistence ---------------------------------------------------
    def to_json(self) -> dict:
        return {
            "version": _VERSION,
            "format": _FORMAT,
            "block_rows": self.block_rows,
            "compression": self.compression,
            "rows": self.rows,
            "columns": [c.to_json() for c in self.columns],
            "shards": [s.to_json() for s in self.shards],
        }

    def save(self, path: str) -> str:
        """Write the manifest (``path`` may be the dataset directory —
        then ``manifest.json`` inside it).  Returns the file path."""
        if os.path.isdir(path):
            path = os.path.join(path, MANIFEST_NAME)
        _atomic_write_json(path, self.to_json())
        return path

    @classmethod
    def load(cls, path: str) -> "DatasetManifest":
        """Load from a manifest file or a dataset directory containing
        ``manifest.json``.  Shard paths resolve relative to the
        manifest's directory."""
        if os.path.isdir(path):
            path = os.path.join(path, MANIFEST_NAME)
        with open(path, encoding="utf-8") as fh:
            d = json.load(fh)
        if d.get("version", 0) > _VERSION:
            raise ValueError(
                f"{path}: manifest version {d['version']} newer than "
                f"this reader ({_VERSION})")
        if d.get("format") != _FORMAT:
            raise ValueError(
                f"{path}: unknown dataset format {d.get('format')!r} "
                f"(this reader understands {_FORMAT!r})")
        m = cls(d["columns"], d["shards"], block_rows=d["block_rows"],
                base_dir=os.path.dirname(os.path.abspath(path)),
                compression=d.get("compression", "zlib"))
        if m.rows != int(d["rows"]):
            raise ValueError(
                f"{path}: shard rows sum to {m.rows}, manifest declares "
                f"{d['rows']}")
        return m

    def validate(self) -> None:
        """Open every shard and check its footer against the ledger —
        the eager integrity pass ingest jobs run before spending an
        epoch on a torn dataset."""
        for i, s in enumerate(self.shards):
            with self.open_shard(i) as r:
                if (r.rows, r.n_blocks) != (s.rows, s.blocks):
                    raise ValueError(
                        f"{self.shard_path(i)}: footer says "
                        f"({r.rows} rows, {r.n_blocks} blocks), manifest "
                        f"says ({s.rows}, {s.blocks})")
                if r.block_rows != self.block_rows:
                    raise ValueError(
                        f"{self.shard_path(i)}: block_rows "
                        f"{r.block_rows} != manifest {self.block_rows}")

    def __repr__(self):
        return (f"DatasetManifest({self.n_shards} shards, "
                f"rows={self.rows}, blocks={self.n_blocks}, "
                f"block_rows={self.block_rows})")
