"""K2: the logistic loss and its gradient over row shards.

It replaces ``dask_ml_tpu/solvers/families.py :: Logistic.loss`` under
``jax.value_and_grad`` in ``solvers/lbfgs_core.py :: lbfgs_minimize``,
which the reference runs once per row shard inside ``solvers/algorithms.py
:: _admm_run``: here the P shards are the lanes of one call, x ``(P, m,
d)``.  The CUDA source is ``csrc/logistic.cu``; it says what bounds the
kernel on an H100 and what its design does about it.

Two wrappers share the kernel: ``logistic_value_and_grad`` (f and g) and
``logistic_value`` (f only, the line search's probes).  Each runs the plain
PyTorch version (``logistic_value_and_grad_ref``) on a CPU tensor and
launches the kernel on a CUDA tensor, or raises.  Each counts its launches
in ``<wrapper>.launches``; the plain version counts its calls in
``logistic_value_and_grad_ref.calls``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_PLAN_WORDS = 8
_lib = None
_plans: dict = {}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("logistic")
        lib.logistic_plan.argtypes = [_LL, _LL, _INT, _VP]
        lib.logistic_plan.restype = _INT
        lib.logistic_value_and_grad.argtypes = [_VP, _VP, _VP, _VP, _VP, _LL, _LL, _INT, _INT,
                                                _VP, _VP, _VP, _VP, _VP]
        lib.logistic_value_and_grad.restype = _INT
        lib.logistic_error_string.argtypes = [_INT]
        lib.logistic_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(lib, err, what):
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} ({lib.logistic_error_string(err).decode()})")


def _plan(lib, device, P, m, d):
    """The launch plan for (P, m, d) on ``device``, made once."""
    key = (device.index, P, m, d)
    plan = _plans.get(key)
    if plan is None:
        plan = (ctypes.c_longlong * _PLAN_WORDS)()
        _check(lib, lib.logistic_plan(P, m, d, plan), "logistic_plan")
        _plans[key] = plan
    return plan


def _validate(x, y, mask, beta, active):
    """Device, dtype, contiguity and shape checks the kernel relies on."""
    named = {"x": x, "y": y, "mask": mask, "beta": beta}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.ndim != 3:
        raise ValueError(f"x must be (P, m, d), got {tuple(x.shape)}")
    P, m, d = x.shape
    if tuple(y.shape) != (P, m) or tuple(mask.shape) != (P, m) or tuple(beta.shape) != (P, d):
        raise ValueError(
            f"shapes disagree: x {tuple(x.shape)}, y {tuple(y.shape)}, "
            f"mask {tuple(mask.shape)}, beta {tuple(beta.shape)}")
    if P == 0 or m == 0 or d == 0:
        raise ValueError("x must be non-empty")
    if P > 65535:
        raise ValueError(f"P = {P} lanes is past the kernel's grid (65535)")
    if active is not None:
        if active.dtype != torch.bool or tuple(active.shape) != (P,):
            raise ValueError(f"active must be bool ({P},)")
        if active.device != x.device:
            raise ValueError(f"active is on {active.device}, x on {x.device}")


def logistic_terms(x, y, mask, beta, grad=True):
    """K2's arithmetic on every lane: ``(f (P,), g (P, d) or None)``."""
    eta = torch.einsum("pmd,pd->pm", x, beta)
    f = torch.sum(mask * (torch.logaddexp(torch.zeros_like(eta), eta) - y * eta), dim=1)
    g = torch.einsum("pm,pmd->pd", mask * (torch.sigmoid(eta) - y), x) if grad else None
    return f, g


def logistic_value_and_grad_ref(x, y, mask, beta, active=None, grad=True):
    """Plain version of K2: ``(f (P,), g (P, d) or None)``; the lanes that
    ``active`` (P,) bool leaves out come back as zeros."""
    logistic_value_and_grad_ref.calls += 1
    f, g = logistic_terms(x, y, mask, beta, grad)
    if active is not None:
        f = torch.where(active, f, 0.0)
        g = torch.where(active[:, None], g, 0.0) if grad else None
    return f, g


def _launch(x, y, mask, beta, active, grad):
    P, m, d = x.shape
    if x.device.type != "cuda":
        raise ValueError(f"K2 runs on cuda or cpu, not {x.device}")
    lib = _load()
    with torch.cuda.device(x.device):
        if active is None:
            active = torch.ones(P, dtype=torch.bool, device=x.device)
        # the kernel writes only the active lanes: the others stay zero
        f = torch.zeros(P, dtype=torch.float32, device=x.device)
        g = torch.zeros(P, d, dtype=torch.float32, device=x.device) if grad else None
        plan = _plan(lib, x.device, P, m, d)
        scratch = torch.empty(plan[6], dtype=torch.float32, device=x.device)
        err = lib.logistic_value_and_grad(
            x.data_ptr(), y.data_ptr(), mask.data_ptr(), beta.data_ptr(), active.data_ptr(),
            P, m, d, int(grad), plan, scratch.data_ptr(), f.data_ptr(),
            g.data_ptr() if grad else None, torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "logistic_value_and_grad")
    return f, g


def logistic_value_and_grad(x, y, mask, beta, active=None):
    """Per lane p: ``f[p] = Σ_i mask·(softplus(η_i) − y·η_i)`` and ``g[p] =
    Σ_i mask·(σ(η_i) − y)·x_i`` with ``η = x[p] @ beta[p]``, over one read
    of x.

    ``x`` (P, m, d), ``y`` and ``mask`` (P, m), ``beta`` (P, d), all
    float32 and contiguous; ``active`` (P,) bool (default all): the other
    lanes are not read and come back as zeros.
    """
    _validate(x, y, mask, beta, active)
    if x.device.type == "cpu":
        return logistic_value_and_grad_ref(x, y, mask, beta, active, True)
    f, g = _launch(x, y, mask, beta, active, True)
    logistic_value_and_grad.launches += 1
    return f, g


def logistic_value(x, y, mask, beta, active=None):
    """``f`` of :func:`logistic_value_and_grad` alone (the line search's
    probes)."""
    _validate(x, y, mask, beta, active)
    if x.device.type == "cpu":
        return logistic_value_and_grad_ref(x, y, mask, beta, active, False)[0]
    f, _ = _launch(x, y, mask, beta, active, False)
    logistic_value.launches += 1
    return f


logistic_value_and_grad.launches = 0
logistic_value.launches = 0
logistic_value_and_grad_ref.calls = 0
