"""K12: one pass of the refining histogram sketch of per-feature quantiles
(``hist_pass_counts``), the port of ``dask_ml_tpu/preprocessing/data.py ::
_hist_quantiles``'s ``hist_pass`` (its bin index and below sum, and the
``bucket_sum`` into d·4096 segments).  Its CUDA source is
``csrc/histogram.cu``: per-block uint32 counts in shared memory, added into
a global uint32 buffer with integer atomics, so the counts are exact and
the same in any order.

The wrapper runs its plain PyTorch version (``hist_pass_counts_ref``) on a
CPU tensor and launches the kernel on a CUDA tensor, or raises; it counts
its launches in ``hist_pass_counts.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .scatter import bucket_sum

BINS = 4096
_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("histogram")
        lib.hist_pass.argtypes = [_VP, _VP, _LL, _INT, _VP, _VP, _VP, _VP, _VP, _VP, _VP]
        lib.hist_pass.restype = _INT
        lib.histogram_error_string.argtypes = [_INT]
        lib.histogram_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def hist_pass_counts_ref(x, mask, lo, hi, width):
    """Plain version of K12, the reference's formula: ``(counts (d, 4096),
    below (d,))`` in float32, the rows weighted by ``mask``, the counts
    summed by ``bucket_sum`` (``index_add_`` at so many segments)."""
    n, d = x.shape
    lo_, hi_ = lo[None, :], hi[None, :]
    pos = (x - lo_) / width[None, :] * BINS
    idx = torch.clamp(pos.to(torch.int32), 0, BINS - 1)
    m = mask[:, None].to(x.dtype)
    inside = m * ((x >= lo_) & (x <= hi_)).to(x.dtype)
    below = torch.sum(m * (x < lo_).to(x.dtype), dim=0)
    seg = torch.arange(d, device=x.device, dtype=torch.int64)[None, :] * BINS + idx
    counts = bucket_sum(inside.reshape(-1), seg.reshape(-1), d * BINS)
    return counts.reshape(d, BINS), below


def _validate(x, mask, lo, hi, width):
    for name, t in (("x", x), ("mask", mask), ("lo", lo), ("hi", hi), ("width", width)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.ndim != 2 or x.shape[1] == 0:
        raise ValueError(f"x must be (n, d) with d >= 1, got {tuple(x.shape)}")
    n, d = x.shape
    if tuple(mask.shape) != (n,):
        raise ValueError(f"mask must be ({n},), got {tuple(mask.shape)}")
    for name, t in (("lo", lo), ("hi", hi), ("width", width)):
        if tuple(t.shape) != (d,):
            raise ValueError(f"{name} must be ({d},), got {tuple(t.shape)}")


def hist_pass_counts(x, mask, lo, hi, width):
    """One histogram pass over the window [lo_j, hi_j] of each feature:
    ``(counts (d, 4096), below (d,))`` in float32, where ``below_j`` counts
    the rows under lo_j and ``counts_j`` bins the rows inside by
    ``clip(int((x − lo_j) / width_j · 4096), 0, 4095)``.

    ``mask`` is the ingest mask, a 0/1 row flag: the kernel counts the rows
    where it is > 0.  Every caller passes that mask; the plain version
    weights by it, which is the same for 0 and 1.  ``width`` is the
    caller's ``max(hi − lo, 1e-30)``.  ``lo``, ``hi`` and ``width`` stay
    on the device: no host read."""
    _validate(x, mask, lo, hi, width)
    if x.device.type == "cpu":
        return hist_pass_counts_ref(x, mask, lo, hi, width)
    if x.device.type != "cuda":
        raise ValueError(f"hist_pass_counts runs on cuda or cpu, not {x.device}")
    x, mask = x.contiguous(), mask.contiguous()
    lo, hi, width = lo.contiguous(), hi.contiguous(), width.contiguous()
    n, d = x.shape
    lib = _load()
    with torch.cuda.device(x.device):
        scratch = torch.empty(d * (BINS + 1), dtype=torch.int32, device=x.device)
        counts = torch.empty(d, BINS, dtype=torch.float32, device=x.device)
        below = torch.empty(d, dtype=torch.float32, device=x.device)
        err = lib.hist_pass(x.data_ptr(), mask.data_ptr(), n, d, lo.data_ptr(), hi.data_ptr(),
                            width.data_ptr(), scratch.data_ptr(), counts.data_ptr(),
                            below.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"hist_pass: CUDA error {err} "
                           f"({lib.histogram_error_string(err).decode()})")
    hist_pass_counts.launches += 1
    return counts, below


hist_pass_counts.launches = 0
