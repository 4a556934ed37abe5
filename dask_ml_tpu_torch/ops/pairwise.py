"""K10 ``sq_euclidean_safe``: cancellation-guarded pairwise distances.

It replaces ``dask_ml_tpu/metrics/pairwise.py :: _sq_euclidean_safe``
(with ``_exact_sq_chunked`` and ``_row_chunked``), under ``_euclid_tile``,
``_rbf_tile`` and ``_SelfTile``: x and y centred on one anchor, d² by the
float32 expansion, clamped at 0, recomputed exactly as Σ(x−y)² where it
fell below ``SAFE_TAU``·(‖x‖²+‖y‖²), the global diagonal pinned to 0 for
self pairs, then d², √d² or exp(−γd²).  The CUDA source is
``csrc/pairwise.cu``.  At 2^20 x 1024 x 50 the float32 products bound the
call (1.70 ms on an H100), at the Nyström shape 10M x 100 x 50 the bytes
(1.79 ms).  Its design: a column-sum pass over x and y for the anchor, y
centred and transposed once, then a persistent tile kernel (d <= 64) that
stages each 128-row band of x once by ``cp.async``, centres and transposes
it in shared memory, keeps the next band and y tile in flight under the
products and the epilogue, and narrows the tile to 104 columns where m <=
104; past 64 features a tile a block.  What still holds it back: the
epilogue, as long as the products, overlaps them only across the two
CTAs of a SM, and at the Nyström shape the band's staging serves one tile.

The wrapper runs the plain PyTorch version (``sq_euclidean_safe_ref``) on a
CPU tensor and launches the kernel on a CUDA tensor, or raises.  It counts
its launches in ``sq_euclidean_safe.launches``; ``last_flagged`` is a
one-element int64 tensor on the device, the number of entries the last
call recomputed (read it only where a sync is wanted).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

#: the reference's ``_SAFE_TAU``: an entry below this share of
#: ‖x‖²+‖y‖² is recomputed exactly
SAFE_TAU = 1e-2
#: the epilogues, as the C interface numbers them
KINDS = {"sq": 0, "euclid": 1, "rbf": 2}
#: elements of the (rows, m, d) cube the plain version's exact recompute
#: holds at a time (the reference's ``_row_chunked`` bound, ~64 MB)
_CUBE = 16_000_000

_VP, _LL, _INT, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("pairwise")
        lib.pairwise_scratch_floats.argtypes = [_LL, _LL, _INT]
        lib.pairwise_scratch_floats.restype = _LL
        lib.sq_euclidean_safe.argtypes = [_VP, _LL, _VP, _LL, _INT, _LL, _LL, _INT, _INT, _F,
                                          _VP, _LL, _VP, _VP, _VP]
        lib.sq_euclidean_safe.restype = _INT
        lib.pairwise_error_string.argtypes = [_INT]
        lib.pairwise_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _finish(d2, kind, gamma):
    if kind == "sq":
        return d2
    if kind == "euclid":
        return torch.sqrt(d2)
    return torch.exp(torch.tensor(-gamma, dtype=d2.dtype) * d2)


def sq_euclidean_safe_ref(x, y, row0=0, col0=0, self_pairs=False, kind="sq", gamma=None):
    """Plain version of K10: ``(out (n, m), flagged ())``, the reference's
    arithmetic.  The exact recompute visits only the rows holding a flagged
    entry, in row chunks whose (rows, m, d) cube stays under ``_CUBE``
    elements, as the reference's ``_row_chunked``."""
    from ..metrics.pairwise import fp32_matmul

    n, m, d = x.shape[0], y.shape[0], x.shape[1]
    if n == 0 or m == 0:
        return x.new_zeros((n, m)), torch.zeros((), dtype=torch.int64, device=x.device)
    anchor = 0.5 * (torch.mean(x, dim=0) + torch.mean(y, dim=0))
    x = x - anchor
    y = y - anchor
    x_norm = torch.sum(x * x, dim=1, keepdim=True)
    y_norm = torch.sum(y * y, dim=1, keepdim=True).T
    scale = x_norm + y_norm
    with fp32_matmul():
        d2 = torch.clamp_min(scale - 2.0 * (x @ y.T), 0.0)
    flagged = d2 < SAFE_TAU * scale
    if self_pairs:
        ii = row0 + torch.arange(n, device=x.device)[:, None]
        jj = col0 + torch.arange(m, device=x.device)[None, :]
        diag = ii == jj
        d2 = torch.where(diag, torch.zeros((), dtype=d2.dtype, device=d2.device), d2)
        flagged = flagged & ~diag
    rows = torch.nonzero(flagged.any(dim=1))[:, 0]
    chunk = max(_CUBE // max(m * d, 1), 1)
    for s in range(0, rows.shape[0], chunk):
        r = rows[s:s + chunk]
        ex = torch.sum((x[r][:, None, :] - y[None, :, :]) ** 2, dim=-1)
        d2[r] = torch.where(flagged[r], ex, d2[r])
    return _finish(d2, kind, gamma), torch.sum(flagged)


def _check(lib, err):
    if err != 0:
        raise RuntimeError(f"sq_euclidean_safe: CUDA error {err} "
                           f"({lib.pairwise_error_string(err).decode()})")


def _validate(x, y, out):
    for name, t in (("x", x), ("y", y)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.ndim != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-d tensor")
    if y.device != x.device:
        raise ValueError(f"y is on {y.device}, x on {x.device}")
    if x.shape[1] != y.shape[1]:
        raise ValueError(f"x and y disagree on the feature count: {x.shape[1]} vs {y.shape[1]}")
    if out is not None:
        if out.dtype != torch.float32 or out.device != x.device:
            raise ValueError("out must be float32 on x's device")
        if tuple(out.shape) != (x.shape[0], y.shape[0]) or out.stride(1) != 1:
            raise ValueError(f"out must be ({x.shape[0]}, {y.shape[0]}) with unit column "
                             f"stride, got {tuple(out.shape)} strides {out.stride()}")


def sq_euclidean_safe(x, y, row0=0, col0=0, self_pairs=False, kind="sq", gamma=None, out=None):
    """Guarded distances of every (x row, y row) pair, finished by ``kind``
    (``"sq"``: d², ``"euclid"``: √d², ``"rbf"``: exp(−``gamma``·d²)).

    ``x`` (n, d) and ``y`` (m, d) are float32 and contiguous.
    ``self_pairs``: x and y are row blocks of one matrix at global row
    offsets ``row0`` and ``col0``.  ``out``, when given, is an (n, m) view
    with unit column stride (a column block of a wider matrix) that the
    call fills; it is returned.
    """
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {sorted(KINDS)}, got {kind!r}")
    if kind == "rbf" and gamma is None:
        raise ValueError("the rbf epilogue needs gamma")
    _validate(x, y, out)
    if x.device.type == "cpu":
        res, flagged = sq_euclidean_safe_ref(x, y, row0, col0, self_pairs, kind, gamma)
        sq_euclidean_safe.last_flagged = flagged
        if out is None:
            return res
        out.copy_(res)
        return out
    if x.device.type != "cuda":
        raise ValueError(f"sq_euclidean_safe runs on cuda or cpu, not {x.device}")
    n, d = x.shape
    m = y.shape[0]
    if out is None:
        out = torch.empty((n, m), dtype=torch.float32, device=x.device)
    flagged = torch.zeros(1, dtype=torch.int64, device=x.device)
    sq_euclidean_safe.last_flagged = flagged
    if n == 0 or m == 0:
        return out
    if d == 0:
        raise ValueError("x and y must have at least one feature")
    lib = _load()
    with torch.cuda.device(x.device):
        scratch = torch.empty(lib.pairwise_scratch_floats(n, m, d), dtype=torch.float32,
                              device=x.device)
        err = lib.sq_euclidean_safe(
            x.data_ptr(), n, y.data_ptr(), m, d, int(row0), int(col0), int(bool(self_pairs)),
            KINDS[kind], float(gamma or 0.0), out.data_ptr(), out.stride(0),
            scratch.data_ptr(), flagged.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _check(lib, err)
    sq_euclidean_safe.launches += 1
    return out


sq_euclidean_safe.launches = 0
sq_euclidean_safe.last_flagged = None
