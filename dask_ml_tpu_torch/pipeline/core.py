"""The host input pipeline: the port of ``dask_ml_tpu/pipeline/core.py``.

A streamed fit moves each block through three stages:

1. **parse**: the host reads or parses the next block (the native loader,
   a generator, a dataset's readers, a slice of an array);
2. **transfer**: the block is staged for the device (bucket pad and target
   encoding in numpy, the copy into page-locked memory and the device copy
   on a side stream, :mod:`.staging`);
3. **compute**: the consumer runs the step (``_pf_consume``: K4 for SGD).

With ``depth >= 1`` one host worker thread (``dask-ml-tpu-torch-prefetch``)
runs stages 1-2 for block *k+1* while the consumer runs stage 3 for block
*k*, through a queue of ``depth`` staged blocks.  The worker launches no
kernel: its only CUDA calls are the stager's copies and events.  Every
kernel is launched by the consumer thread, which orders it after its
block's copies through the block's event (:func:`.staging.ready`).

Blocks are consumed in source order at every depth, and staging computes
the same arrays the serial ``partial_fit`` does, so results are
bit-identical to ``depth=0``.  A parse or stage failure surfaces on the
consumer as the original exception with ``pipeline_block`` and
``pipeline_phase`` set (and a note saying so); a worker that dies without
reporting raises ``RuntimeError``.  Closing the stream joins the worker,
then closes the source (a dataset joins its readers).

Not ported yet: the elastic restart, the degraded-blocks policy and the
live depth override ([port-planes]), the sanitize regions
([port-analysis]), and ``UnitStream``, which only the concurrent search
orchestrator uses ([port-search]).
"""

from __future__ import annotations

import os
import threading
import time
from queue import Empty, Full, Queue

from ..core import mesh
from .staging import Stager, reading_for
from .stats import PipelineStats

__all__ = ["DEPTH_ENV", "PREFETCH_THREAD_NAME", "as_block_source", "resolve_depth",
           "prefetch_blocks", "stream_partial_fit"]

#: knob: the default prefetch depth (0 = serial)
DEPTH_ENV = "DASK_ML_TPU_TORCH_PREFETCH_DEPTH"

#: the staging worker's thread name
PREFETCH_THREAD_NAME = "dask-ml-tpu-torch-prefetch"

_DEFAULT_DEPTH = 2

_DONE = object()  # the source is exhausted

#: how long a queue wait blocks before the consumer checks the worker again
_POLL_S = 0.05


class _BlockFault(Exception):
    """One block's failure, with its position and phase (``parse``,
    ``stage`` or ``worker``)."""

    def __init__(self, blk: int, phase: str, exc: BaseException):
        super().__init__(f"block {blk} {phase} fault: {exc!r}")
        self.blk = int(blk)
        self.phase = phase
        self.exc = exc

    def surface(self) -> BaseException:
        """The original exception, marked with the block and the phase."""
        exc = self.exc
        exc.pipeline_block = self.blk
        exc.pipeline_phase = self.phase
        exc.add_note(f"in the input pipeline: block {self.blk}, phase {self.phase}")
        return exc


def resolve_depth(depth: int | None = None) -> int:
    """The prefetch depth: the argument, else ``DASK_ML_TPU_TORCH_PREFETCH_DEPTH``,
    else 2.  A value that is not an integer >= 0 raises."""
    if depth is None:
        raw = os.environ.get(DEPTH_ENV, "").strip()
        if raw:
            try:
                depth = int(raw)
            except ValueError:
                raise ValueError(f"{DEPTH_ENV} must be an integer, got {raw!r}") from None
        else:
            depth = _DEFAULT_DEPTH
    depth = int(depth)
    if depth < 0:
        raise ValueError(f"prefetch depth must be >= 0, got {depth}")
    return depth


def _parse_and_stage(src, stage, stats: PipelineStats, blk: int):
    """One step on either path (the depth-0 loop, the worker): the timed
    pull of the next item, then its timed staging.  Returns the staged item
    or ``_DONE``; a failure raises :class:`_BlockFault`."""
    t0 = time.perf_counter()
    try:
        item = next(src)
    except StopIteration:
        return _DONE
    except Exception as exc:
        raise _BlockFault(blk, "parse", exc) from exc
    finally:
        stats.parse_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        return stage(item)
    except Exception as exc:
        raise _BlockFault(blk, "stage", exc) from exc
    finally:
        stats.transfer_s += time.perf_counter() - t0


def _staged_iter(src, stage, depth: int, stats: PipelineStats, stager=None):
    """``stage(item)`` for each item of ``src`` in order, staged up to
    ``depth`` blocks ahead on a worker thread (inline at depth 0), whose
    readers fill ``stager``'s source buffers.  Closing the generator stops
    and joins the worker, even one waiting on a full queue."""
    blk = 0
    if depth <= 0:
        while True:
            try:
                staged = _parse_and_stage(src, stage, stats, blk)
            except _BlockFault as fault:
                raise fault.surface() from None
            if staged is _DONE:
                return
            blk += 1
            yield staged

    q: Queue = Queue(maxsize=depth)
    stop = threading.Event()
    scope = mesh.current_scope()  # the consumer's device scope, for the source

    def _put(msg) -> bool:
        while not stop.is_set():
            try:
                q.put(msg, timeout=_POLL_S)
                return True
            except Full:
                continue
        return False

    def _work():
        n = 0
        try:
            with mesh.adopt_scope(scope), reading_for(stager):
                while not stop.is_set():
                    try:
                        staged = _parse_and_stage(src, stage, stats, n)
                    except _BlockFault as fault:
                        _put(("fault", fault))
                        return
                    if staged is _DONE:
                        _put(("done",))
                        return
                    if not _put(("blk", staged)):
                        return  # the consumer closed the stream
                    n += 1
        except BaseException as exc:  # handed to the consumer, which raises it
            _put(("fault", _BlockFault(n, "worker", exc)))

    worker = threading.Thread(target=_work, daemon=True, name=PREFETCH_THREAD_NAME)
    worker.start()
    try:
        while True:
            t0 = time.perf_counter()
            try:
                msg = q.get(timeout=_POLL_S)
            except Empty:
                stats.stall_s += time.perf_counter() - t0
                if worker.is_alive():
                    continue
                try:  # the worker may have put its last message, then ended
                    msg = q.get_nowait()
                except Empty:
                    raise RuntimeError(
                        f"the prefetch worker ended without reporting at block {blk}") from None
            else:
                stats.stall_s += time.perf_counter() - t0
            if msg[0] == "done":
                return
            if msg[0] == "fault":
                raise msg[1].surface() from None
            blk += 1
            yield msg[1]
    finally:
        stop.set()
        while True:  # drop staged blocks, and free a worker waiting to put
            try:
                q.get_nowait()
            except Empty:
                break
        worker.join()


def as_block_source(blocks):
    """One block iterator from a stream source: a sharded dataset (the
    ``iter_blocks`` protocol) opens its merged stream here; anything else
    goes through ``iter()``."""
    if hasattr(blocks, "iter_blocks"):
        return blocks.iter_blocks()
    return iter(blocks)


def _close_source(src) -> None:
    """Close a source that holds threads or a frame (a dataset stream, a
    generator); plain iterators have no ``close``."""
    close = getattr(src, "close", None)
    if close is not None:
        close()


def _identity(x):
    return x


def prefetch_blocks(blocks, *, depth: int | None = None, stage=None, label: str = "stream"):
    """The items of ``blocks``, each through ``stage`` (default: as it is) on
    the worker thread, up to ``depth`` ahead; records a
    :class:`~.stats.PipelineStats` when the stream ends or is closed."""
    depth = resolve_depth(depth)
    stage = stage or _identity
    stats = PipelineStats(label=label, depth=depth, staged=stage is not _identity)
    src = as_block_source(blocks)
    feed = _staged_iter(src, stage, depth, stats)
    try:
        for staged in feed:
            t0 = time.perf_counter()
            yield staged
            stats.compute_s += time.perf_counter() - t0
            stats.blocks += 1
    finally:
        feed.close()
        _close_source(src)
        stats.finish()


def _supports_staging(model) -> bool:
    return hasattr(model, "_pf_stage") and hasattr(model, "_pf_consume")


def _stage_device(model):
    """The device a model's blocks are staged for: its own, else the active
    one (resolved on the consumer thread)."""
    device = getattr(model, "_device", None)
    return device() if callable(device) else mesh.get_device()


def _protocol_fns(model, kw: dict, staged_proto: bool, stager):
    """The (stage, consume) pair of a ``partial_fit`` stream: ``stage`` on
    the worker (``_pf_stage``, or the block as it is), ``consume`` on the
    consumer (``_pf_consume``, or plain ``partial_fit``).  A block that
    ``_pf_stage`` declines (None) rides along raw and takes serial
    ``partial_fit``, in its place in the order."""

    def _raw_consume(blk):
        bx, by = blk
        if by is None:
            model.partial_fit(bx, **kw)
        else:
            model.partial_fit(bx, by, **kw)

    if not staged_proto:
        return _identity, _raw_consume

    def _stage(blk):
        staged = model._pf_stage(blk[0], blk[1], stager=stager, **kw)
        return (blk if staged is None else None), staged

    def _consume(item):
        blk, staged = item
        if staged is None:
            _raw_consume(blk)
        else:
            model._pf_consume(staged)

    return _stage, _consume


def stream_partial_fit(model, blocks, *, depth: int | None = None,
                       fit_kwargs: dict | None = None, on_block=None,
                       label: str = "partial_fit_stream"):
    """Drive ``model.partial_fit`` over ``(X, y_or_None)`` blocks, with
    prefetch and early staging.

    With the staged protocol (``_pf_stage``/``_pf_consume``) and
    ``depth >= 1`` the worker stages each block ahead: block *k+1*'s parse,
    pad, encode and copy overlap block *k*'s step.  ``_pf_stage`` decides a
    block at a time; a block it declines (None: device-resident input,
    weights) takes plain ``partial_fit`` on the consumer, in source order.
    Other models get raw-block prefetch.  ``depth=0`` is the serial loop:
    ``partial_fit`` a block, no thread.  ``on_block(i, model)`` runs on the
    consumer after the ``i``-th block (1-based).  Returns ``model``."""
    kw = dict(fit_kwargs or {})
    depth = resolve_depth(depth)
    staged_proto = depth > 0 and _supports_staging(model)
    stats = PipelineStats(label=label, depth=depth, staged=staged_proto)
    # slots: depth queued + one being consumed + one being filled
    stager = Stager(_stage_device(model), depth + 2) if staged_proto else None
    _stage, _consume = _protocol_fns(model, kw, staged_proto, stager)
    src = as_block_source(blocks)
    feed = _staged_iter(src, _stage, depth, stats, stager)
    done = 0
    try:
        for item in feed:
            t0 = time.perf_counter()
            _consume(item)
            stats.compute_s += time.perf_counter() - t0
            stats.blocks += 1
            done += 1
            del item  # drop the staged tensors: device memory stays depth+1 blocks
            if on_block is not None:
                on_block(done, model)
        return model
    finally:
        feed.close()
        _close_source(src)
        if stager is not None:
            stats.host_buffers = stager.host_buffers
            stats.pinned_buffers = stager.pinned_buffers
        stats.finish()

