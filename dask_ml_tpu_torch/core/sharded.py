"""Padded, masked row collections: the port of ``dask_ml_tpu/core/sharded.py``.

The reference pads the sample axis to a multiple of its mesh's data-axis
size and marks real rows with a float mask; every reduction is
mask-weighted and results are sliced back to the true row count.  The
port keeps the same pad+mask contract on one device, padding to a
multiple of the logical shard count (``core.mesh.get_n_shards``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .mesh import get_device, get_n_shards

# Rows per pass of the chunked moments: at 100M x 50 an unchunked
# ``(x - anchor) * m`` would be a second and third 20 GB copy of x.
_CHUNK_ELEMS = 1 << 26


def pad_rows(x: np.ndarray, multiple: int):
    """Pad axis 0 of ``x`` up to a multiple; returns (padded, n_real)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad_width = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(np.asarray(x), pad_width), n


@dataclass(frozen=True)
class ShardedRows:
    """A 1- or 2-D tensor padded by rows to the logical shard count.

    Attributes:
      data: padded tensor, axis 0 divisible by the shard count.
      mask: float32 (padded_n,), 1.0 for real rows, 0.0 for padding; it
        doubles as the per-row weight once sample weights fold in.
      n_samples: true row count.
    """

    data: torch.Tensor
    mask: torch.Tensor
    n_samples: int

    @property
    def shape(self):
        return (self.n_samples,) + tuple(self.data.shape[1:])

    @property
    def padded(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    def unpad(self, x=None):
        """Slice a padded-rows result back to the true row count."""
        x = self.data if x is None else x
        return x[: self.n_samples]


def shard_rows(x, device=None, *, n_shards=None, dtype=None) -> ShardedRows:
    """Ingest rows as a padded, masked ``ShardedRows``.

    A torch tensor stays on its own device and is padded there, and only
    when its row count is not a multiple of ``n_shards``.  Host arrays go
    to ``device`` (default: the active device); float64 host input
    becomes float32, as the reference's arrays do without x64.
    """
    if isinstance(x, ShardedRows):
        return x
    n_shards = get_n_shards() if n_shards is None else int(n_shards)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if dtype is None and x.dtype == np.float64:
            dtype = torch.float32
        device = torch.device(device) if device is not None else get_device()
        x = np.ascontiguousarray(x)
        if not x.flags.writeable:  # torch.from_numpy wants a writable buffer
            x = x.copy()
        x = torch.from_numpy(x).to(device)
    if dtype is not None:
        x = x.to(dtype)
    n = x.shape[0]
    pad = (-n) % n_shards
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    mask = (torch.arange(n + pad, device=x.device) < n).to(torch.float32)
    return ShardedRows(data=x, mask=mask, n_samples=n)


def unshard(x) -> np.ndarray:
    """Bring a tensor (or the real rows of a ShardedRows) to host memory."""
    if isinstance(x, ShardedRows):
        x = x.unpad()
    return x.detach().cpu().numpy()


def _row_slices(x):
    row_elems = max(1, int(np.prod(x.shape[1:], dtype=np.int64)))
    step = max(1, _CHUNK_ELEMS // row_elems)
    for s in range(0, x.shape[0], step):
        yield slice(s, s + step)


def _weights(x, mask):
    return mask.reshape(mask.shape + (1,) * (x.ndim - 1)).to(x.dtype)


def masked_sum(x, mask):
    """Sum over rows counting only real (mask==1) rows."""
    return torch.sum(x * _weights(x, mask), dim=0)


def _masked_anchor(x, m):
    """A valid data value per feature to shift by, so the moments are
    taken at the data's spread scale and not its offset scale (the
    reference's anchor numerics: at offset 1e6 in f32 a raw-scale mean
    carries ~0.1 absolute error, which enters the variance squared)."""
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    anchor = None
    for s in _row_slices(x):
        part = torch.where(m[s] > 0, x[s], inf).amin(dim=0)
        anchor = part if anchor is None else torch.minimum(anchor, part)
    return torch.where(torch.isfinite(anchor), anchor, torch.zeros_like(anchor))


def _chunked_sum(fn, x):
    total = None
    for s in _row_slices(x):
        part = fn(s).sum(dim=0)
        total = part if total is None else total + part
    return total


def masked_mean(x, mask):
    m = _weights(x, mask)
    anchor = _masked_anchor(x, m)
    shifted = _chunked_sum(lambda s: (x[s] - anchor) * m[s], x)
    return anchor + shifted / torch.sum(m, dim=0)


def masked_var(x, mask, ddof=0):
    m = _weights(x, mask)
    count = torch.sum(m, dim=0)
    anchor = _masked_anchor(x, m)
    mean_s = _chunked_sum(lambda s: (x[s] - anchor) * m[s], x) / count
    sq = _chunked_sum(lambda s: (x[s] - anchor - mean_s) ** 2 * m[s], x)
    return sq / (count - ddof)
