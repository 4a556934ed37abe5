"""Shape-bucketing policy: the port of ``dask_ml_tpu/programs/bucket.py``.

Streamed blocks are zero-padded up to one of a few row counts, with a
validity mask carrying correctness (pad rows weigh 0.0 in every masked
reduction).  The reference pads so that a ragged stream compiles few XLA
programs; the port keeps the same rungs so that both packages step on the
same padded shapes, and so that a later slice can capture one CUDA graph a
rung.

One knob, ``DASK_ML_TPU_TORCH_BUCKET``, read at call time:

* ``auto`` (default, and the empty string): :data:`DEFAULT_BUCKETS`;
  blocks beyond the top rung round up to a multiple of it.
* ``off``: no padding.
* ``pow2``: the next power of two.
* ``"256,4096,65536"``: an explicit ascending ladder.

An unparseable value raises.  :func:`pad_block` is pure numpy; its
``blocks`` / ``padded_blocks`` / ``pad_rows`` counts are read with
:func:`counters_snapshot`.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["BUCKET_ENV", "DEFAULT_BUCKETS", "BucketPolicy", "resolve_policy", "bucket_rows",
           "counters_snapshot", "pad_block"]

#: policy knob: how streamed block row counts map to padded shapes
BUCKET_ENV = "DASK_ML_TPU_TORCH_BUCKET"

#: the default ladder (the reference's ``DEFAULT_BUCKETS``)
DEFAULT_BUCKETS = (256, 1024, 4096, 16384, 65536)

_counts = {"blocks": 0, "padded_blocks": 0, "pad_rows": 0}


def counters_snapshot() -> dict:
    """The pad split so far: blocks seen, blocks padded, rows added."""
    return dict(_counts)


class BucketPolicy:
    """One resolved bucketing policy: ``kind`` ∈ off / pow2 / sizes."""

    __slots__ = ("kind", "sizes")

    def __init__(self, kind: str, sizes: tuple | None = None):
        self.kind = kind
        self.sizes = sizes

    def bucket(self, n: int) -> int:
        """The padded row count for a block of ``n`` real rows (an empty
        block stays empty under every policy)."""
        n = int(n)
        if n <= 0:
            return 0
        if self.kind == "off":
            return n
        if self.kind == "pow2":
            return 1 << (n - 1).bit_length()
        for b in self.sizes:
            if n <= b:
                return b
        top = self.sizes[-1]
        return ((n + top - 1) // top) * top

    def rungs(self, max_rows: int) -> tuple:
        """Every padded row count this policy gives blocks of 1..``max_rows``
        real rows, ascending; ``()`` under ``off``."""
        max_rows = int(max_rows)
        if max_rows <= 0 or self.kind == "off":
            return ()
        if self.kind == "pow2":
            out, b = [], 1
            while b < max_rows:
                out.append(b)
                b <<= 1
            out.append(b)
            return tuple(out)
        top = self.bucket(max_rows)
        out = [b for b in self.sizes if b < top]
        step = self.sizes[-1]
        b = out[-1] + step if out and out[-1] >= step else step
        while b < top:
            out.append(b)
            b += step
        out.append(top)
        return tuple(out)

    def __eq__(self, other):
        return (isinstance(other, BucketPolicy)
                and self.kind == other.kind and self.sizes == other.sizes)

    def __repr__(self):
        if self.kind == "sizes":
            return f"BucketPolicy(sizes={self.sizes})"
        return f"BucketPolicy({self.kind!r})"


_AUTO = BucketPolicy("sizes", DEFAULT_BUCKETS)
_OFF = BucketPolicy("off")
_POW2 = BucketPolicy("pow2")


def resolve_policy(policy: str | BucketPolicy | None = None) -> BucketPolicy:
    """The explicit ``policy``, else the ``DASK_ML_TPU_TORCH_BUCKET`` knob,
    else ``auto``; anything but off / pow2 / auto / a strictly ascending
    list of positive ints raises."""
    if isinstance(policy, BucketPolicy):
        return policy
    raw = policy if policy is not None else os.environ.get(BUCKET_ENV, "")
    raw = raw.strip().lower()
    if raw in ("", "auto", "default"):
        return _AUTO
    if raw == "off":
        return _OFF
    if raw == "pow2":
        return _POW2
    try:
        sizes = tuple(int(s) for s in raw.split(",") if s.strip())
    except ValueError:
        sizes = ()
    if not sizes or any(b <= 0 for b in sizes) or list(sizes) != sorted(set(sizes)):
        raise ValueError(
            f"{BUCKET_ENV} must be 'off', 'pow2', 'auto', or a strictly-ascending "
            f"comma-separated list of positive ints; got {raw!r}")
    return BucketPolicy("sizes", sizes)


def bucket_rows(n: int, policy: str | BucketPolicy | None = None) -> int:
    """The bucketed row count for ``n`` real rows under ``policy``."""
    return resolve_policy(policy).bucket(n)


def pad_block(X: np.ndarray, targets: np.ndarray | None = None,
              policy: str | BucketPolicy | None = None):
    """Zero-pad a host block's rows to the policy's bucket, with a validity
    mask: ``(X_padded, targets_padded_or_None, mask)``.  A block that is
    already bucket-sized comes back as it is, with a ones mask, and counts
    as unpadded."""
    n = X.shape[0]
    b = resolve_policy(policy).bucket(n)
    _counts["blocks"] += 1
    if b == n:
        return X, targets, np.ones(n, dtype=np.float32)
    _counts["padded_blocks"] += 1
    _counts["pad_rows"] += b - n
    mask = np.zeros(b, dtype=np.float32)
    mask[:n] = 1.0
    X = np.concatenate([X, np.zeros((b - n,) + X.shape[1:], X.dtype)])
    if targets is not None:
        targets = np.concatenate([targets, np.zeros((b - n,) + targets.shape[1:],
                                                    targets.dtype)])
    return X, targets, mask
