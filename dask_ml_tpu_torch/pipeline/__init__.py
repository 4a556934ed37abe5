"""The host input pipeline: prefetch on a worker thread, staging through
page-locked buffers on a side stream, and the stage-split timing books.
See :mod:`.core`, :mod:`.staging` and :mod:`.stats`."""

from .core import (DEPTH_ENV, PREFETCH_THREAD_NAME, as_block_source, prefetch_blocks,
                   resolve_depth, stream_partial_fit)
from .staging import Staged, Stager, host_empty, reading_for, ready
from .stats import PipelineStats, pipeline_report, reset_pipeline_stats

__all__ = ["DEPTH_ENV", "PREFETCH_THREAD_NAME", "PipelineStats", "Staged", "Stager",
           "as_block_source", "host_empty", "pipeline_report", "prefetch_blocks",
           "reading_for", "ready",
           "reset_pipeline_stats", "resolve_depth", "stream_partial_fit"]
