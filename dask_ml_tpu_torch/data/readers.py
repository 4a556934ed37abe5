"""The sharded dataset's runtime: the port of ``dask_ml_tpu/data/readers.py``.

A :class:`ShardedDataset` turns a manifest of columnar shards into one
deterministic block stream, read by ``DASK_ML_TPU_TORCH_DATA_READERS``
parallel threads and put back in order by a bounded reorder window:

* the order is a value: epoch ``e`` visits the blocks in
  :func:`~.shuffle.epoch_plan`'s order, so the stream is the same at every
  reader count and in every run;
* readers claim whole shards (``_claim``) in plan order and offer each
  decoded block at its sequence number (``_offer``); a reader more than
  ``DASK_ML_TPU_TORCH_DATA_QUEUE`` blocks ahead of the consumer waits, so
  host memory stays a few blocks;
* a reader's exception reaches the consumer with its shard and block, and
  a reader that dies without one is reported too; the stream then stops
  its readers.  The readers are host-only: they read and decode bytes and
  touch no device.

Not ported yet ([port-planes]): the supervisor heartbeat, the budgeted
reader restart with exactly-once replay, fault injection and the metrics.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from .manifest import DatasetManifest
from .shuffle import as_key, epoch_plan

__all__ = [
    "READERS_ENV",
    "QUEUE_ENV",
    "READER_THREAD_NAME",
    "resolve_readers",
    "resolve_queue_blocks",
    "ShardedDataset",
]

#: knob: parallel reader threads a dataset stream
READERS_ENV = "DASK_ML_TPU_TORCH_DATA_READERS"

#: knob: the reorder window in blocks (bounds host memory)
QUEUE_ENV = "DASK_ML_TPU_TORCH_DATA_QUEUE"

#: the reader threads' name
READER_THREAD_NAME = "dask-ml-tpu-torch-data-reader"

_DEFAULT_READERS = 4

#: how long a wait blocks before the consumer checks the readers again
_POLL_S = 0.05


def _resolve_int(env: str, default: int, what: str, value: int | None = None) -> int:
    if value is None:
        raw = os.environ.get(env, "").strip()
        if raw:
            try:
                value = int(raw)
            except ValueError:
                raise ValueError(f"{env} must be an integer, got {raw!r}") from None
        else:
            value = default
    value = int(value)
    if value < 1:
        raise ValueError(f"{what} must be >= 1, got {value}")
    return value


def resolve_readers(readers: int | None = None) -> int:
    """Reader threads: the argument, else ``DASK_ML_TPU_TORCH_DATA_READERS``,
    else 4."""
    return _resolve_int(READERS_ENV, _DEFAULT_READERS, "reader count", readers)


def resolve_queue_blocks(queue_blocks: int | None = None,
                         readers: int = _DEFAULT_READERS) -> int:
    """The reorder window in blocks: the argument, else
    ``DASK_ML_TPU_TORCH_DATA_QUEUE``, else 2 × readers."""
    return _resolve_int(QUEUE_ENV, 2 * int(readers), "queue window", queue_blocks)


class ReaderFault(RuntimeError):
    """A reader thread failed: ``shard``, ``seq`` (the block's position in
    the epoch's order, None when the shard could not be opened) and
    ``epoch``; the reader's exception is the ``__cause__``."""

    def __init__(self, msg, shard, seq, epoch):
        super().__init__(msg)
        self.shard, self.seq, self.epoch = shard, seq, epoch


class ShardedDataset:
    """A manifest of columnar shards as one deterministic, parallel-read
    block stream (see the module docstring).

    Args:
      source: a :class:`~.manifest.DatasetManifest`, or the path of one or
        of a dataset directory.
      key: the shuffle key, an int seed or a ``uint32[2]`` array; epoch
        ``e``'s order derives from ``fold_in(key, e)``.
      epochs: passes :meth:`iter_blocks` makes, each its own permutation.
      shuffle: False gives manifest shard order and file block order.
      readers, queue_blocks: see :func:`resolve_readers`,
        :func:`resolve_queue_blocks`.
      start: blocks of the stream to skip (a resumed fit's position).
      budget: a reader-restart budget; not ported yet, and anything but
        None raises.
    """

    def __init__(self, source, *, key=0, epochs: int = 1, shuffle: bool = True,
                 readers: int | None = None, queue_blocks: int | None = None, start: int = 0,
                 budget=None, label: str = "dataset"):
        if budget is not None:
            raise NotImplementedError(
                "budget= (budgeted reader restarts) is not ported yet (ROADMAP: [port-planes] "
                "resilience/)")
        self.manifest = source if isinstance(source, DatasetManifest) \
            else DatasetManifest.load(source)
        if self.manifest.n_shards < 1:
            raise ValueError("dataset has no shards")
        self.key = as_key(key)
        self.epochs = int(epochs)
        if self.epochs < 1:
            raise ValueError(f"epochs must be >= 1, got {self.epochs}")
        self.shuffle = bool(shuffle)
        self.readers = resolve_readers(readers)
        self.queue_blocks = resolve_queue_blocks(queue_blocks, self.readers)
        self.start = int(start)
        self.label = str(label)

    @property
    def rows(self) -> int:
        return self.manifest.rows

    @property
    def n_blocks(self) -> int:
        """Blocks an epoch."""
        return self.manifest.n_blocks

    def plan(self, epoch: int):
        """The epoch's visit order (:class:`~.shuffle.EpochPlan`)."""
        return epoch_plan(self.key, epoch, self.manifest.blocks_per_shard(),
                          shuffle=self.shuffle)

    def iter_blocks(self, epoch: int | None = None, start: int | None = None):
        """The merged stream: ``(X, y_or_None)`` for a dataset of one or two
        columns, the column tuple otherwise.  ``epoch=None`` streams all
        ``epochs`` passes back to back, an int that one pass.  ``start``
        skips the stream's first blocks (counted across epochs in the
        multi-epoch form)."""
        start = self.start if start is None else int(start)
        if epoch is not None:
            epoch_range = [int(epoch)]
        else:
            skip_epochs, start = divmod(start, max(self.n_blocks, 1))
            epoch_range = list(range(self.epochs))[skip_epochs:]
        return _DatasetStream(self, epoch_range, start)

    def __iter__(self):
        return self.iter_blocks()

    def __repr__(self):
        return (f"ShardedDataset({self.manifest!r}, epochs={self.epochs}, "
                f"readers={self.readers}, window={self.queue_blocks}, shuffle={self.shuffle})")


class _DatasetStream:
    """One live merged stream over a range of epochs: owns the current
    epoch's reader threads and the reorder buffer.  Readers offer ``(seq,
    block)`` and wait while ``seq >= next_seq + window``; the consumer takes
    blocks strictly at ``next_seq``.  All of it under one condition."""

    def __init__(self, ds: ShardedDataset, epoch_range, start: int):
        self._ds = ds
        self._epochs = list(epoch_range)
        self._first_start = max(int(start), 0)
        self._cond = threading.Condition()
        self._closed = False
        self._epoch_live = False
        self._threads: list = []
        self.blocks_delivered = 0
        self.rows_delivered = 0

    # -- epoch lifecycle ----------------------------------------------
    def _open_epoch(self, epoch: int, start: int) -> None:
        ds = self._ds
        self._plan = ds.plan(epoch)
        self._epoch = epoch
        self._next_seq = min(start, self._plan.n_blocks)
        self._end_seq = self._plan.n_blocks
        self._buffer: dict[int, tuple] = {}
        self._next_pos = 0  # the next unclaimed shard position in the plan
        self._finished: dict[int, bool] = {}
        self._faults: list[ReaderFault] = []
        self._epoch_live = True
        # readers past the shard count would never claim work
        n = max(min(ds.readers, len(self._plan.shard_order)), 1)
        self._threads = [threading.Thread(target=self._reader, args=(rid,), daemon=True,
                                          name=READER_THREAD_NAME) for rid in range(n)]
        for rid, t in enumerate(self._threads):
            self._finished[rid] = False
            t.start()

    def _close_epoch(self) -> None:
        if not self._epoch_live:
            return
        with self._cond:
            self._epoch_live = False
            self._cond.notify_all()
        for t in self._threads:
            t.join()  # a reader waits at most _POLL_S or one block read
        self._threads = []
        self._buffer = {}

    # -- reader side (host-only threads) ------------------------------
    def _claim(self) -> int | None:
        with self._cond:
            if not self._epoch_live or self._next_pos >= len(self._plan.shard_order):
                return None
            p = self._next_pos
            self._next_pos += 1
            return p

    def _offer(self, seq: int, block) -> bool:
        """Wait until ``seq`` fits the window, then buffer the block; False
        when the stream closed."""
        with self._cond:
            while self._epoch_live and seq >= self._next_seq + self._ds.queue_blocks:
                self._cond.wait(timeout=_POLL_S)
            if not self._epoch_live:
                return False
            if seq >= self._next_seq:
                self._buffer[seq] = block
                self._cond.notify_all()
            return True

    def _reader(self, rid: int) -> None:
        ds = self._ds
        shard = seq = None
        try:
            while True:
                pos = self._claim()
                if pos is None:
                    break
                shard = self._plan.shard_order[pos]
                seq = None
                order = self._plan.block_orders[shard]
                base = self._plan.starts[pos]
                with ds.manifest.open_shard(shard) as reader:
                    for j in range(len(order)):
                        seq = base + j
                        if seq < self._next_seq:
                            continue  # before a resumed stream's start
                        if not self._epoch_live:
                            return
                        if not self._offer(seq, reader.read_block(int(order[j]))):
                            return
            with self._cond:
                self._finished[rid] = True
                self._cond.notify_all()
        except BaseException as exc:  # handed to the consumer, which raises it
            fault = ReaderFault(
                f"dataset {ds.label!r} reader {rid} failed on shard {shard} "
                f"({ds.manifest.shard_path(shard) if shard is not None else '?'}), "
                f"block {seq} of epoch {self._epoch}: {type(exc).__name__}: {exc}",
                shard, seq, self._epoch)
            fault.__cause__ = exc
            with self._cond:
                self._faults.append(fault)
                self._cond.notify_all()

    # -- consumer side -------------------------------------------------
    def _check_readers(self) -> None:
        """Raise a reader's fault, or report a reader that died without one
        (run on the consumer, outside the condition)."""
        with self._cond:
            fault = self._faults[0] if self._faults else None
        if fault is None:
            for rid, t in enumerate(self._threads):
                if not t.is_alive() and not self._finished.get(rid, False):
                    with self._cond:
                        if self._faults:  # a report landed after the poll
                            fault = self._faults[0]
                            break
                    fault = ReaderFault(
                        f"dataset {self._ds.label!r} reader {rid} died without reporting "
                        f"(epoch {self._epoch})", None, None, self._epoch)
                    break
        if fault is not None:
            self.close()
            raise fault

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        while True:
            if not self._epoch_live:
                if not self._epochs:
                    self.close()
                    raise StopIteration
                epoch = self._epochs.pop(0)
                start, self._first_start = self._first_start, 0
                self._open_epoch(epoch, start)
            block = self._await_block()
            if block is not None:
                return block
            self._close_epoch()  # the epoch is drained: on to the next

    def _await_block(self):
        """The live epoch's next block in order, or None once it is drained."""
        while True:
            with self._cond:
                if self._next_seq >= self._end_seq:
                    return None
                block = self._buffer.pop(self._next_seq, None)
                if block is not None:
                    self._next_seq += 1
                    self._cond.notify_all()  # slide the window
                else:
                    self._cond.wait(timeout=_POLL_S)
            if block is None:
                self._check_readers()
                continue
            self.blocks_delivered += 1
            self.rows_delivered += int(np.shape(block[0])[0]) if len(block) else 0
            if len(block) == 1:
                return block[0], None
            if len(block) == 2:
                return block[0], block[1]
            return block

    def close(self) -> None:
        """Stop and join the readers and drop buffered blocks; idempotent."""
        if self._closed:
            return
        self._closed = True
        self._close_epoch()
        self._epochs = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
