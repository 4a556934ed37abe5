"""Host-to-device staging for the prefetch worker: page-locked buffers and a
side stream.

A :class:`Stager` belongs to one stream.  On a CUDA device :meth:`Stager.put`
enqueues each host array's device copy with ``non_blocking=True`` on a
stream the stager owns, from page-locked memory, and records an event after
the copies.  An array a reader filled through :func:`host_empty` already
lies in one of the stager's page-locked source buffers and is copied from
there; any other array is first copied into a buffer from a ring of
``slots`` buffers a shape, and the worker waits, on the host, for that
buffer's last device copy to end before it refills it.  The stager's only
CUDA calls are page-locked allocations, copies and events: it launches no
kernel, so it may run on the worker thread.  The consumer calls
:func:`ready` before a kernel reads the block: its stream waits for the
event, and the tensors are recorded as used on it, so the caching allocator
does not hand their memory to another block while the kernel still reads
it.

On the CPU a put is a plain copy into fresh tensors, with no stream.
"""

from __future__ import annotations

import contextlib
import sys
import threading

import numpy as np
import torch

__all__ = ["Staged", "Stager", "host_empty", "reading_for", "ready"]

#: shapes a stager keeps rings for; a stream past it drops its oldest ring
#: (PyTorch holds a dropped page-locked buffer until its copies end)
_MAX_RINGS = 8

_local = threading.local()


def host_empty(shape, dtype=np.float32) -> np.ndarray:
    """An uninitialised host array for a reader to fill (``io.read_binary``,
    ``io.stream_csv_blocks``): on a prefetch worker staging for a stream
    (:func:`reading_for`), a source buffer of the stream's stager, so the
    block goes to the device with no host copy; elsewhere ``np.empty``."""
    stager = getattr(_local, "stager", None)
    return np.empty(shape, dtype) if stager is None else stager.host_empty(shape, dtype)


@contextlib.contextmanager
def reading_for(stager):
    """Let this thread's readers fill ``stager``'s source buffers (None: plain
    host memory) inside a ``with`` block."""
    outer = getattr(_local, "stager", None)
    _local.stager = stager
    try:
        yield
    finally:
        _local.stager = outer


class Staged:
    """A block's device tensors and the event recorded after their copies
    (None on the CPU).  Take the tensors through :func:`ready`."""

    __slots__ = ("tensors", "event")

    def __init__(self, tensors, event):
        self.tensors = tuple(tensors)
        self.event = event


def ready(staged):
    """The tensors of ``staged``, safe for the calling thread's current
    stream; anything but a :class:`Staged` comes back as it is."""
    if not isinstance(staged, Staged):
        return staged
    if staged.event is not None:
        stream = torch.cuda.current_stream(staged.tensors[0].device)
        stream.wait_event(staged.event)
        for t in staged.tensors:
            t.record_stream(stream)
    return staged.tensors


def _torch_dtype(dtype):
    return torch.from_numpy(np.empty(0, dtype)).dtype


class Stager:
    """Stages host arrays onto ``device`` for one stream (module docstring).
    ``host_buffers`` counts the page-locked buffers it allocated and
    ``pinned_buffers`` those that ``is_pinned()`` confirmed."""

    def __init__(self, device, slots: int):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.slots = max(int(slots), 2)
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._rings: dict = {}  # (shape, dtype) -> [next slot, [[buffer, event], ...]]
        # [buffer, its numpy view, the event after its last copy, the view's
        # reference count when only the stager holds it]
        self._sources: list = []
        self.host_buffers = 0
        self.pinned_buffers = 0

    def _alloc(self, shape, dtype):
        if self.stream is None:
            return torch.empty(shape, dtype=dtype)
        buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.host_buffers += 1
        self.pinned_buffers += int(buf.is_pinned())
        return buf

    def host_empty(self, shape, dtype) -> np.ndarray:
        """A source buffer of ``shape`` that nobody holds and no copy reads, or
        a new one, up to ``slots + 2`` of them; past that ``np.empty``."""
        shape, dtype = tuple(int(s) for s in shape), np.dtype(dtype)
        for src in self._sources:
            if (src[1].shape == shape and src[1].dtype == dtype
                    and sys.getrefcount(src[1]) == src[3]
                    and (src[2] is None or src[2].query())):
                return src[1]
        if len(self._sources) >= self.slots + 2:
            return np.empty(shape, dtype)
        buf = self._alloc(shape, _torch_dtype(dtype))
        self._sources.append([buf, buf.numpy(), None, 0])
        entry = self._sources[-1]
        entry[3] = sys.getrefcount(entry[1])
        return entry[1]

    def _source_of(self, a):
        """The source buffer ``a`` fills exactly, or None."""
        ptr = a.__array_interface__["data"][0]
        for src in self._sources:
            if src[1].ctypes.data == ptr and src[1].nbytes == a.nbytes and src[1].dtype == a.dtype:
                return src
        return None

    def _slot(self, shape, dtype):
        key = (shape, dtype)
        ring = self._rings.get(key)
        if ring is None:
            if len(self._rings) >= _MAX_RINGS:
                self._rings.pop(next(iter(self._rings)))
            ring = self._rings[key] = [0, []]
        i = ring[0]
        ring[0] = (i + 1) % self.slots
        if i == len(ring[1]):
            ring[1].append([self._alloc(shape, dtype), None])
        slot = ring[1][i]
        if slot[1] is not None:
            slot[1].synchronize()  # the buffer's last copy has ended: it is free
        return slot

    def put(self, arrays) -> Staged:
        """The host ``arrays`` staged on the device, in order."""
        arrays = [np.ascontiguousarray(a) for a in arrays]
        if self.stream is None:
            return Staged((torch.from_numpy(np.array(a, copy=True)) for a in arrays), None)
        bufs, used = [], []
        for a in arrays:
            src = self._source_of(a)
            if src is not None:  # read straight into page-locked memory
                bufs.append(src[0].view(a.shape))
                used.append((src, 2))
                continue
            slot = self._slot(tuple(a.shape), _torch_dtype(a.dtype))
            if a.flags.writeable:
                slot[0].copy_(torch.from_numpy(a))  # PyTorch's copy runs on its threads
            else:
                slot[0].numpy()[...] = a
            bufs.append(slot[0])
            used.append((slot, 1))
        with torch.cuda.stream(self.stream):
            out = [buf.to(self.device, non_blocking=True) for buf in bufs]
            event = torch.cuda.Event()
            event.record(self.stream)
        for entry, i in used:
            entry[i] = event
        return Staged(out, event)
