"""The Lloyd kernels: K1a ``lloyd_assign_reduce`` and K1b ``lloyd_assign``.

They replace the body of ``dask_ml_tpu/cluster/k_means.py ::
_lloyd_step_fn`` (distances, argmin, masked inertia, per-cluster sums and
counts) and the distance/argmin of ``_assign_fn``, ``_phi_and_mind2`` /
``_valid_d2`` and the k-means‖ ``closest`` argmin.  The CUDA source is
``csrc/lloyd.cu``; it says what bounds the kernels on an H100 and what
their design does about it.

Each wrapper runs its plain PyTorch version (``*_ref``) on a CPU tensor,
and launches its kernel on a CUDA tensor, or raises.  Each counts its
launches in ``<wrapper>.launches``; ``lloyd_assign.last_k`` is the number
of centers its last launch computed.
"""

from __future__ import annotations

import ctypes

import torch

from ..metrics.pairwise import _sq_euclidean_hi
from . import _build
from .scatter import bucket_sum

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("lloyd")
        for plan in (lib.lloyd_plan, lib.assign_plan):
            plan.argtypes = [_LL, _INT, _INT, _VP]
            plan.restype = _INT
        lib.lloyd_assign_reduce.argtypes = [_VP, _VP, _VP, _LL, _INT, _INT,
                                            _VP, _VP, _VP, _VP]
        lib.lloyd_assign_reduce.restype = _INT
        lib.lloyd_assign.argtypes = [_VP, _VP, _VP, _INT, _VP, _LL, _INT, _INT,
                                     _VP, _VP, _VP, _VP, _VP, _VP]
        lib.lloyd_assign.restype = _INT
        lib.lloyd_error_string.argtypes = [_INT]
        lib.lloyd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(lib, err, what):
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} "
            f"({lib.lloyd_error_string(err).decode()})")


def _validate(x, mask, centers, cvalid=None):
    """Device, dtype, contiguity and shape checks the kernels rely on."""
    named = {"x": x, "mask": mask, "centers": centers}
    if cvalid is not None:
        named["cvalid"] = cvalid
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.ndim != 2 or centers.ndim != 2 or mask.ndim != 1:
        raise ValueError("x and centers must be 2-d, mask 1-d")
    n, d = x.shape
    k = centers.shape[0]
    if mask.shape[0] != n or centers.shape[1] != d:
        raise ValueError(
            f"shapes disagree: x {tuple(x.shape)}, mask {tuple(mask.shape)}, "
            f"centers {tuple(centers.shape)}")
    if cvalid is not None and tuple(cvalid.shape) != (k,):
        raise ValueError(f"cvalid must be ({k},), got {tuple(cvalid.shape)}")
    if n == 0 or d == 0 or k == 0:
        raise ValueError("x, centers must be non-empty")
    if k * d >= 2**31:
        raise ValueError(f"k*d = {k * d} is past the kernels' 32-bit center index")
    return n, d, k


def _plan(lib, name, words, n, d, k, device):
    """The launch's plan (``words`` int64s from ``lib.<name>``, made once)
    and the scratch it needs (its last word, in floats)."""
    plan = (ctypes.c_longlong * words)()
    _check(lib, getattr(lib, name)(n, d, k, plan), name)
    return plan, torch.empty(plan[words - 1], dtype=torch.float32, device=device)


def _compact(centers, cvalid):
    """``(slot, centers[slot])``: the valid candidate slots in slot order,
    so that a tie still goes to the first of them, or ``(None, centers)``
    without ``cvalid``.  Finding the slots syncs with the device once."""
    if cvalid is None:
        return None, centers
    if tuple(cvalid.shape) != (centers.shape[0],):
        raise ValueError(f"cvalid must be ({centers.shape[0]},), got {tuple(cvalid.shape)}")
    slot = torch.nonzero(cvalid > 0)[:, 0]
    if slot.numel() == 0:
        raise ValueError("cvalid marks no candidate slot valid: there is no nearest center")
    return slot, centers[slot]


def _valid_d2(x, centers, cvalid):
    """Distances with invalid candidate slots selected out to +inf (never
    pushed out by adding a sentinel)."""
    d2 = _sq_euclidean_hi(x, centers)
    if cvalid is None:
        return d2
    return torch.where(cvalid[None, :] > 0, d2,
                       torch.tensor(float("inf"), dtype=d2.dtype, device=d2.device))


def lloyd_assign_ref(x, mask, centers, cvalid=None):
    """Plain version of K1b: (labels int64 (n,), min_d2 (n,), inertia ())."""
    d2 = _valid_d2(x, centers, cvalid)
    labels = torch.argmin(d2, dim=1)  # first index among ties
    min_d2 = torch.gather(d2, 1, labels[:, None])[:, 0]
    return labels, min_d2, torch.sum(min_d2 * mask)


def lloyd_assign_reduce_ref(x, mask, centers):
    """Plain version of K1a: (sums (k,d), counts (k,), inertia ())."""
    k = centers.shape[0]
    labels, _, inertia = lloyd_assign_ref(x, mask, centers)
    sums = bucket_sum(x * mask[:, None], labels, k)
    counts = bucket_sum(mask, labels, k)
    return sums, counts, inertia


def lloyd_assign_reduce(x, mask, centers):
    """One Lloyd round's reduce: per-cluster weighted sums Σ mask·x, counts
    Σ mask and the masked inertia Σ mask·min d², fused over one read of x.

    ``x`` (n, d), ``mask`` (n,), ``centers`` (k, d), all float32.
    """
    if x.device.type == "cpu":
        return lloyd_assign_reduce_ref(x, mask, centers)
    n, d, k = _validate(x, mask, centers)
    if x.device.type != "cuda":
        raise ValueError(f"lloyd_assign_reduce runs on cuda or cpu, not {x.device}")
    lib = _load()
    with torch.cuda.device(x.device):
        out = torch.empty(k * d + k + 1, dtype=torch.float32, device=x.device)
        plan, scratch = _plan(lib, "lloyd_plan", 8, n, d, k, x.device)
        err = lib.lloyd_assign_reduce(
            x.data_ptr(), mask.data_ptr(), centers.data_ptr(), n, d, k,
            plan, scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "lloyd_assign_reduce")
    lloyd_assign_reduce.launches += 1
    return out[: k * d].view(k, d), out[k * d: k * d + k], out[-1]


def lloyd_assign(x, mask, centers, cvalid=None):
    """Nearest center of every row: (labels int64 (n,), min_d2 (n,),
    inertia ()), with min_d2 unweighted and inertia = Σ mask·min_d2.
    ``cvalid`` (k,) marks the valid candidate slots: only those are
    computed, and labels index the full slot list.
    """
    if x.device.type == "cpu":
        slot, valid = _compact(centers, cvalid)
        labels, min_d2, inertia = lloyd_assign_ref(x, mask, valid)
        return (labels if slot is None else slot[labels]), min_d2, inertia
    n, d, _ = _validate(x, mask, centers, cvalid)
    if x.device.type != "cuda":
        raise ValueError(f"lloyd_assign runs on cuda or cpu, not {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x must start on a 16-byte boundary (the kernel copies 16 bytes at a time)")
    slot, valid = _compact(centers, cvalid)
    k = valid.shape[0]
    ldc = -(-k // 4) * 4
    lib = _load()
    with torch.cuda.device(x.device):
        # feature-major, rows padded with zeros to a multiple of 4 floats
        centers_t = torch.zeros(d, ldc, dtype=torch.float32, device=x.device)
        centers_t[:, :k] = valid.t()
        labels = torch.empty(n, dtype=torch.int64, device=x.device)
        min_d2 = torch.empty(n, dtype=torch.float32, device=x.device)
        inertia = torch.empty(1, dtype=torch.float32, device=x.device)
        plan, scratch = _plan(lib, "assign_plan", 4, n, d, k, x.device)
        err = lib.lloyd_assign(
            x.data_ptr(), mask.data_ptr(), centers_t.data_ptr(), ldc,
            None if slot is None else slot.data_ptr(), n, d, k,
            plan, labels.data_ptr(), min_d2.data_ptr(), scratch.data_ptr(),
            inertia.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "lloyd_assign")
    lloyd_assign.launches += 1
    lloyd_assign.last_k = k
    return labels, min_d2, inertia[0]


lloyd_assign_reduce.launches = 0
lloyd_assign.launches = 0
lloyd_assign.last_k = None
