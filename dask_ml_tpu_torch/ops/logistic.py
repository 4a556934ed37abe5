"""K2: a GLM family's loss and its gradient over row shards.

It replaces ``dask_ml_tpu/solvers/families.py :: Logistic.loss``,
``Normal.loss`` and ``Poisson.loss`` under ``jax.value_and_grad`` in
``solvers/lbfgs_core.py :: lbfgs_minimize``, which the reference runs
once per row shard inside ``solvers/algorithms.py :: _admm_run``, and in
its single-lane solvers: here the P shards are the lanes of one call, x
``(P, m, d)``.  The CUDA source is ``csrc/logistic.cu``, one template over
the family and the design's element type; it says what bounds the kernel
on an H100 and what its design does about it.

Each family has two wrappers on the kernel: ``<family>_value_and_grad`` (f
and g) and ``<family>_value`` (f only, the line searches' probes), for
``logistic``, ``normal`` and ``poisson``.  x is float32 or bfloat16 (the
reference's mixed precision: bf16 X with float32 parameters); y, the mask
and β are float32, and so is every sum.  Each wrapper runs the plain
PyTorch version on a CPU tensor and launches the kernel on a CUDA tensor,
or raises.  Each counts its launches in ``<wrapper>.launches``; the plain
versions count their calls in ``logistic_value_and_grad_ref.calls``
(the logistic wrappers) and ``glm_value_and_grad_ref.calls`` (the others).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_PLAN_WORDS = 8
#: the kernel's family ids
FAMILIES = {"logistic": 0, "normal": 1, "poisson": 2}
#: design element types the kernel reads, and their sizes
_ESIZE = {torch.float32: 4, torch.bfloat16: 2}
_lib = None
_plans: dict = {}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("logistic")
        lib.logistic_plan.argtypes = [_INT, _LL, _LL, _INT, _INT, _VP]
        lib.logistic_plan.restype = _INT
        lib.logistic_value_and_grad.argtypes = [_INT, _VP, _VP, _VP, _VP, _VP, _LL, _LL, _INT,
                                                _INT, _VP, _VP, _VP, _VP, _VP]
        lib.logistic_value_and_grad.restype = _INT
        lib.logistic_error_string.argtypes = [_INT]
        lib.logistic_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(lib, err, what):
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} ({lib.logistic_error_string(err).decode()})")


def _plan(lib, device, family, esize, P, m, d):
    """The launch plan for (family, element size, P, m, d) on ``device``,
    made once."""
    key = (device.index, family, esize, P, m, d)
    plan = _plans.get(key)
    if plan is None:
        plan = (ctypes.c_longlong * _PLAN_WORDS)()
        _check(lib, lib.logistic_plan(FAMILIES[family], P, m, d, esize, plan), "logistic_plan")
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
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _ESIZE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for name in ("y", "mask", "beta"):
        if named[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {named[name].dtype}")
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
    """K2's logistic arithmetic on every lane of a float32 x: ``(f (P,), g
    (P, d) or None)``."""
    eta = torch.einsum("pmd,pd->pm", x, beta)
    f = torch.sum(mask * (torch.logaddexp(torch.zeros_like(eta), eta) - y * eta), dim=1)
    g = torch.einsum("pm,pmd->pd", mask * (torch.sigmoid(eta) - y), x) if grad else None
    return f, g


def glm_terms(family, x, y, mask, beta, grad=True):
    """K2's arithmetic for ``family`` on every lane, a bf16 x widened to
    float32 (other types as they are: float64 for a check in float64):
    ``(f (P,), g (P, d) or None)``.  Normal's ½ multiplies the masked sum,
    as the reference's loss does."""
    if x.dtype == torch.bfloat16:
        x = x.float()
    if family == "logistic":
        return logistic_terms(x, y, mask, beta, grad)
    eta = torch.einsum("pmd,pd->pm", x, beta)
    if family == "normal":
        f = 0.5 * torch.sum(mask * (y - eta) ** 2, dim=1)
        w = eta - y
    elif family == "poisson":
        mu = torch.exp(eta)
        f = torch.sum(mask * (mu - y * eta), dim=1)
        w = mu - y
    else:
        raise ValueError(f"unknown family {family!r}; K2 has {sorted(FAMILIES)}")
    g = torch.einsum("pm,pmd->pd", mask * w, x) if grad else None
    return f, g


def _ref(family, x, y, mask, beta, active, grad):
    f, g = glm_terms(family, x, y, mask, beta, grad)
    if active is not None:
        f = torch.where(active, f, 0.0)
        g = torch.where(active[:, None], g, 0.0) if grad else None
    return f, g


def glm_value_and_grad_ref(family, x, y, mask, beta, active=None, grad=True):
    """Plain version of K2 for ``family``: ``(f (P,), g (P, d) or None)``;
    the lanes that ``active`` (P,) bool leaves out come back as zeros."""
    glm_value_and_grad_ref.calls += 1
    return _ref(family, x, y, mask, beta, active, grad)


def logistic_value_and_grad_ref(x, y, mask, beta, active=None, grad=True):
    """Plain version of K2 for the logistic family (see
    :func:`glm_value_and_grad_ref`)."""
    logistic_value_and_grad_ref.calls += 1
    return _ref("logistic", x, y, mask, beta, active, grad)


def _launch(family, x, y, mask, beta, active, grad):
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
        plan = _plan(lib, x.device, family, _ESIZE[x.dtype], P, m, d)
        scratch = torch.empty(plan[6], dtype=torch.float32, device=x.device)
        err = lib.logistic_value_and_grad(
            FAMILIES[family], x.data_ptr(), y.data_ptr(), mask.data_ptr(), beta.data_ptr(),
            active.data_ptr(), P, m, d, int(grad), plan, scratch.data_ptr(), f.data_ptr(),
            g.data_ptr() if grad else None, torch.cuda.current_stream().cuda_stream)
    _check(lib, err, f"{family}_value_and_grad")
    return f, g


def _wrappers(family, plain, loss, weight):
    """The two wrappers of one family on the kernel: value-and-grad and
    value only, each counting its launches."""

    def value_and_grad(x, y, mask, beta, active=None):
        _validate(x, y, mask, beta, active)
        if x.device.type == "cpu":
            return plain(x, y, mask, beta, active, True)
        f, g = _launch(family, x, y, mask, beta, active, True)
        value_and_grad.launches += 1
        return f, g

    def value(x, y, mask, beta, active=None):
        _validate(x, y, mask, beta, active)
        if x.device.type == "cpu":
            return plain(x, y, mask, beta, active, False)[0]
        f, _ = _launch(family, x, y, mask, beta, active, False)
        value.launches += 1
        return f

    value_and_grad.__name__ = value_and_grad.__qualname__ = f"{family}_value_and_grad"
    value.__name__ = value.__qualname__ = f"{family}_value"
    value_and_grad.__doc__ = (
        f"Per lane p: ``f[p] = Σ_i mask·({loss})`` and ``g[p] = Σ_i mask·({weight})·x_i`` "
        "with ``η = x[p] @ beta[p]``, over one read of x.\n\n"
        "    ``x`` (P, m, d) float32 or bfloat16, ``y`` and ``mask`` (P, m), ``beta``\n"
        "    (P, d) float32, all contiguous; ``active`` (P,) bool (default all): the\n"
        "    other lanes are not read and come back as zeros.\n    ")
    value.__doc__ = f"``f`` of :func:`{family}_value_and_grad` alone (the line searches' probes)."
    value_and_grad.launches = 0
    value.launches = 0
    return value_and_grad, value


def _plain(family):
    return lambda x, y, mask, beta, active, grad: glm_value_and_grad_ref(
        family, x, y, mask, beta, active, grad)


logistic_value_and_grad, logistic_value = _wrappers(
    "logistic", logistic_value_and_grad_ref, "softplus(η_i) − y·η_i", "σ(η_i) − y")
normal_value_and_grad, normal_value = _wrappers(
    "normal", _plain("normal"), "(y − η_i)²/2", "η_i − y")
poisson_value_and_grad, poisson_value = _wrappers(
    "poisson", _plain("poisson"), "exp(η_i) − y·η_i", "exp(η_i) − y")
logistic_value_and_grad_ref.calls = 0
glm_value_and_grad_ref.calls = 0
