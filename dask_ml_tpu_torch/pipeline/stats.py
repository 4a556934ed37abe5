"""The input pipeline's timing books: the port of
``dask_ml_tpu/pipeline/stats.py``.

Every stream through :mod:`.core` records a :class:`PipelineStats`: the
host seconds spent pulling blocks from the source (**parse**), staging them
for the device (**transfer**: pad, encode, the copy into page-locked memory
and the enqueue of its device copy), and running the step (**compute**: the
consumer's call, which enqueues device work and returns), the seconds the
consumer waited on the prefetch queue (**stall**), the stream's **wall**
clock, and the **hidden** seconds (the stage sum the overlap took off the
wall clock).  With a staged stream it also counts the host buffers the
stager filled and how many of them were page-locked.  All are host clocks.
The last stream is kept whole and the process's sums beside it; the
prefetch worker writes parse and transfer, the consumer compute and stall,
so the fields need no lock.
"""

from __future__ import annotations

import threading
import time

__all__ = ["PipelineStats", "pipeline_report", "reset_pipeline_stats"]

_STAGES = ("parse_s", "transfer_s", "compute_s", "stall_s", "wall_s", "hidden_s")


class PipelineStats:
    """Stage-split timers of one block stream."""

    __slots__ = ("label", "depth", "staged", "blocks", "parse_s", "transfer_s", "compute_s",
                 "stall_s", "wall_s", "host_buffers", "pinned_buffers", "_t0")

    def __init__(self, label: str = "fit", depth: int = 0, staged: bool = False):
        self.label = label
        self.depth = int(depth)
        self.staged = bool(staged)
        self.blocks = 0
        self.parse_s = 0.0
        self.transfer_s = 0.0
        self.compute_s = 0.0
        self.stall_s = 0.0
        self.wall_s = 0.0
        self.host_buffers = 0
        self.pinned_buffers = 0
        self._t0 = time.perf_counter()

    @property
    def hidden_s(self) -> float:
        """The serial stage sum minus the wall clock, at least 0."""
        return max(self.parse_s + self.transfer_s + self.compute_s - self.wall_s, 0.0)

    def finish(self) -> "PipelineStats":
        self.wall_s = time.perf_counter() - self._t0
        _record(self)
        return self

    def as_dict(self) -> dict:
        out = {"label": self.label, "depth": self.depth, "staged": self.staged,
               "blocks": self.blocks}
        out.update({k: getattr(self, k) for k in _STAGES})
        out["host_buffers"] = self.host_buffers
        out["pinned_buffers"] = self.pinned_buffers
        return out


_LOCK = threading.Lock()
_LAST: PipelineStats | None = None
_CUM: dict = {}


def _record(stats: PipelineStats) -> None:
    global _LAST
    with _LOCK:
        _LAST = stats
        _CUM["streams"] = _CUM.get("streams", 0) + 1
        _CUM["blocks"] = _CUM.get("blocks", 0) + stats.blocks
        for k in _STAGES:
            _CUM[k] = _CUM.get(k, 0.0) + getattr(stats, k)


def pipeline_report() -> dict:
    """The last stream's split (:meth:`PipelineStats.as_dict`) with
    ``streams`` and ``cumulative`` (the process's sums and the bucket pad
    counts); ``{"streams": 0}`` before any stream."""
    from ..programs.bucket import counters_snapshot

    with _LOCK:
        if _LAST is None:
            return {"streams": 0}
        out = _LAST.as_dict()
        out["streams"] = _CUM["streams"]
        out["cumulative"] = dict(_CUM, bucket=counters_snapshot())
    return out


def reset_pipeline_stats() -> None:
    """Forget the last stream and the process's sums."""
    global _LAST
    with _LOCK:
        _LAST = None
        _CUM.clear()
