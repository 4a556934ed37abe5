"""K9: GaussianNB's per-class moments (``class_moments``: the sums pass
``class_sums`` and the deviations pass ``class_deviations``), and K9b: its
joint log-likelihood (``gaussian_jll``).  The ports of
``dask_ml_tpu/naive_bayes.py :: _class_moments_fn`` and
``GaussianNB._joint_log_likelihood``; their CUDA source is
``csrc/naive_bayes.cu``.

K9's sums run in another order than the plain version's gemms (block
records summed in a fixed order: the same bits every run).  K9b rounds
every operation as its plain version, which sums the features in the same
order, so the two give the same bits.

Each wrapper runs its plain PyTorch version (``*_ref``) on a CPU tensor and
launches its kernel on a CUDA tensor, or raises; each counts its launches
in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..metrics.pairwise import fp32_matmul
from . import _build

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("naive_bayes")
        lib.class_moments_scratch_floats.argtypes = [_LL, _INT, _INT]
        lib.class_moments_scratch_floats.restype = _LL
        lib.class_moments_pass.argtypes = [_INT, _VP, _VP, _VP, _LL, _INT, _INT, _VP, _VP, _VP,
                                           _VP, _VP]
        lib.class_moments_pass.restype = _INT
        lib.gaussian_jll.argtypes = [_VP, _LL, _INT, _INT, _VP, _VP, _VP, _VP, _VP, _VP, _VP]
        lib.gaussian_jll.restype = _INT
        lib.naive_bayes_error_string.argtypes = [_INT]
        lib.naive_bayes_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({lib.naive_bayes_error_string(err).decode()})")


def _safe(m):
    return torch.where(m > 0, m, torch.ones_like(m))


def _onehot(labels, k, dtype):
    """The binary one-hot (n, k); a label outside [0, k) gives zeros."""
    return (labels[:, None].to(torch.int64)
            == torch.arange(k, device=labels.device)).to(dtype)


def class_sums_ref(x, labels, weights, k):
    """Plain version of K9's first pass, the reference's one-hot gemm in
    float32 (no TF32): ``(counts (k,), means (k, d))``."""
    w = _onehot(labels, k, x.dtype) * weights[:, None]
    counts = torch.sum(w, dim=0)
    with fp32_matmul():
        means = (w.T @ x) / _safe(counts)[:, None]
    return counts, means


def class_deviations_ref(x, labels, weights, counts, means):
    """Plain version of K9's second pass: var (k, d), the row's class mean
    selected by the binary one-hot (a gemm, as the reference)."""
    onehot = _onehot(labels, means.shape[0], x.dtype)
    w = onehot * weights[:, None]
    with fp32_matmul():
        dev = x - onehot @ means
        return (w.T @ (dev * dev)) / _safe(counts)[:, None]


def class_moments_ref(x, labels, weights, k):
    """Plain version of K9: ``(counts (k,), means (k, d), var (k, d))``."""
    counts, means = class_sums_ref(x, labels, weights, k)
    return counts, means, class_deviations_ref(x, labels, weights, counts, means)


def _validate(x, labels, weights, k):
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 or x.ndim != 2:
        raise TypeError("x must be a float32 (n, d) tensor")
    n, d = x.shape
    if d == 0 or k < 1:
        raise ValueError(f"need d >= 1 and k >= 1, got d={d}, k={k}")
    if labels.dtype != torch.int32 or tuple(labels.shape) != (n,):
        raise TypeError(f"labels must be int32 ({n},)")
    if weights.dtype != torch.float32 or tuple(weights.shape) != (n,):
        raise TypeError(f"weights must be float32 ({n},)")
    for t in (labels, weights):
        if t.device != x.device:
            raise ValueError(f"every operand must be on {x.device}")


def _moments_pass(pass_, x, labels, weights, k, counts, means, var):
    lib = _load()
    n, d = x.shape
    floats = lib.class_moments_scratch_floats(n, d, k)
    if floats < 0:
        raise ValueError(f"class_moments takes at most 800 classes, got {k}")
    with torch.cuda.device(x.device):
        scratch = torch.empty(max(floats, 1), dtype=torch.float32, device=x.device)
        err = lib.class_moments_pass(
            pass_, x.data_ptr(), labels.data_ptr(), weights.data_ptr(), n, d, k,
            scratch.data_ptr(), counts.data_ptr(), means.data_ptr(),
            0 if var is None else var.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "class_moments_pass")


def class_sums(x, labels, weights, k):
    """K9's first pass: ``(counts (k,), means (k, d))`` with
    counts_c = Σ w over the rows of class c and means_c = Σ w·x /
    safe(counts_c).  ``labels`` are int32 class indices (a row outside
    [0, k) counts nowhere), ``weights`` the mask times any sample weight."""
    _validate(x, labels, weights, k)
    if x.device.type == "cpu":
        return class_sums_ref(x, labels, weights, k)
    if x.device.type != "cuda":
        raise ValueError(f"class_sums runs on cuda or cpu, not {x.device}")
    x, labels, weights = x.contiguous(), labels.contiguous(), weights.contiguous()
    counts = torch.empty(k, dtype=torch.float32, device=x.device)
    means = torch.empty(k, x.shape[1], dtype=torch.float32, device=x.device)
    _moments_pass(0, x, labels, weights, k, counts, means, None)
    class_sums.launches += 1
    return counts, means


def class_deviations(x, labels, weights, counts, means):
    """K9's second pass: var (k, d), Σ w·(x − means_c)² /
    safe(counts_c), the row's mean selected by its label."""
    k = means.shape[0]
    _validate(x, labels, weights, k)
    if x.device.type == "cpu":
        return class_deviations_ref(x, labels, weights, counts, means)
    if x.device.type != "cuda":
        raise ValueError(f"class_deviations runs on cuda or cpu, not {x.device}")
    x, labels, weights = x.contiguous(), labels.contiguous(), weights.contiguous()
    var = torch.empty_like(means)
    _moments_pass(1, x, labels, weights, k, counts.contiguous(), means.contiguous(), var)
    class_deviations.launches += 1
    return var


def class_moments(x, labels, weights, k):
    """Per-class weight mass, mean and variance (two-pass): ``(counts (k,),
    means (k, d), var (k, d))``: K9's two passes."""
    counts, means = class_sums(x, labels, weights, k)
    return counts, means, class_deviations(x, labels, weights, counts, means)


def _jll_terms(var, prior):
    """log(2π var) (k, d) and log prior (k,), the per-class terms K9b and
    its plain version share."""
    return torch.log(2 * math.pi * var), torch.log(prior)


def gaussian_jll_ref(x, theta, var, prior, predict=False):
    """Plain version of K9b: jll (n, k) = log prior + (−0.5 · Σ_j [log(2π
    var) + (x − θ)² / var]), summed over the features in order (one
    float32 op at a time, as the kernel); ``predict`` returns the index of
    the first largest (n,) int64."""
    logterm, logprior = _jll_terms(var, prior)
    acc = torch.zeros(x.shape[0], theta.shape[0], dtype=x.dtype, device=x.device)
    for j in range(x.shape[1]):
        diff = x[:, j, None] - theta[None, :, j]
        acc = acc + (logterm[None, :, j] + (diff * diff) / var[None, :, j])
    jll = logprior[None, :] + (-0.5) * acc
    return torch.argmax(jll, dim=1) if predict else jll


def gaussian_jll(x, theta, var, prior, predict=False):
    """GaussianNB's joint log-likelihood of the rows of ``x`` (n, d) under
    the classes' ``theta`` and ``var`` (k, d) and ``prior`` (k,): jll
    (n, k) float32, or with ``predict`` the index of each row's first
    largest (n,) int64."""
    for name, t in (("x", x), ("theta", theta), ("var", var), ("prior", prior)):
        if not isinstance(t, torch.Tensor) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be a float32 tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    n, d = x.shape
    k = theta.shape[0]
    if tuple(theta.shape) != (k, d) or tuple(var.shape) != (k, d) or tuple(prior.shape) != (k,):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, theta {tuple(theta.shape)}, "
                         f"var {tuple(var.shape)}, prior {tuple(prior.shape)}")
    if x.device.type == "cpu":
        return gaussian_jll_ref(x, theta, var, prior, predict)
    if x.device.type != "cuda":
        raise ValueError(f"gaussian_jll runs on cuda or cpu, not {x.device}")
    x, theta, var = x.contiguous(), theta.contiguous(), var.contiguous()
    logterm, logprior = _jll_terms(var, prior.contiguous())
    lib = _load()
    with torch.cuda.device(x.device):
        if predict:
            out = torch.empty(n, dtype=torch.int64, device=x.device)
            jll_ptr, pred_ptr = 0, out.data_ptr()
        else:
            out = torch.empty(n, k, dtype=torch.float32, device=x.device)
            jll_ptr, pred_ptr = out.data_ptr(), 0
        err = lib.gaussian_jll(x.data_ptr(), n, d, k, theta.data_ptr(), var.data_ptr(),
                               logterm.contiguous().data_ptr(), logprior.data_ptr(), jll_ptr,
                               pred_ptr, torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "gaussian_jll")
    gaussian_jll.launches += 1
    return out


class_sums.launches = 0
class_deviations.launches = 0
gaussian_jll.launches = 0
