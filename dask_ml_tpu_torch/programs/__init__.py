"""Shape bucketing for streamed blocks (``programs/bucket.py``)."""

from .bucket import (
    BUCKET_ENV, DEFAULT_BUCKETS, BucketPolicy, bucket_rows, counters_snapshot, pad_block,
    resolve_policy)

__all__ = ["BUCKET_ENV", "DEFAULT_BUCKETS", "BucketPolicy", "bucket_rows", "counters_snapshot",
           "pad_block", "resolve_policy"]
