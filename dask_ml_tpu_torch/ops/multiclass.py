"""K2-OvR and K2-MN: the multi-class logistic losses and their gradients
over row shards.

K2-OvR (``logistic_ovr_value_and_grad``, ``normal_ovr_value_and_grad``)
replaces ``dask_ml_tpu/solvers/families.py :: Logistic.loss`` and
``Normal.loss`` under ``jax.vmap`` of ``solvers/algorithms.py ::
packed_solve`` and ``lambda_sweep``: K problems share x ``(P, m, d)``,
with targets Y ``(K, P, m)`` and one β a lane of B ``(K·P, d)``, lane
``k·P + p`` the problem k on shard p.  Y is either contiguous (K targets
of their own: one-vs-rest) or one ``(P, m)`` target expanded to K with a
class stride of 0 (a sweep's lanes, which differ only in β): the kernel
then stages one target run a tile for all K, and where d ≤ 32 and K ≤ 16
runs the lanes on the tensor cores as K2-MN runs its classes (plan path
3; ``_plan``'s first word names the path).  K2-MN
(``multinomial_value_and_grad``) replaces ``families.py :: multinomial``'s
softmax loss under ``jax.value_and_grad``: B ``(P, d·K)`` holds one flat β a
shard in the reference's ``(features, K)`` row-major layout, and y ``(P,
m)`` the class indices as floats.  The CUDA source is ``csrc/multiclass.cu``;
it says what bounds the kernels on an H100 and what their design does
about it.  Both read x once for all K classes.

Each kernel has two wrappers, value-and-gradient and value only (the line
search's probes).  Each runs the plain PyTorch version (``*_ref``) on a CPU
tensor and launches the kernel on a CUDA tensor, or raises.  Each counts
its launches in ``<wrapper>.launches``; the plain versions count their
calls in ``<plain version>.calls``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .logistic import glm_terms

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_PLAN_WORDS = 8
_OVR, _MN = 0, 1
#: K2-OvR's families, as the C interface numbers them
_FAMILIES = {"logistic": 0, "normal": 1}
#: most classes a call takes (the wide path keeps 3·K floats of shared memory)
MAX_CLASSES = 4096
_lib = None
_plans: dict = {}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("multiclass")
        lib.multiclass_plan.argtypes = [_INT, _INT, _LL, _LL, _INT, _INT, _INT, _VP]
        lib.multiclass_plan.restype = _INT
        lib.multiclass_value_and_grad.argtypes = [_INT, _INT, _VP, _VP, _VP, _VP, _VP, _LL, _LL,
                                                  _INT, _INT, _LL, _INT, _VP, _VP, _VP, _VP, _VP]
        lib.multiclass_value_and_grad.restype = _INT
        lib.multiclass_error_string.argtypes = [_INT]
        lib.multiclass_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(lib, err, what):
    if err != 0:
        raise RuntimeError(
            f"{what}: CUDA error {err} ({lib.multiclass_error_string(err).decode()})")


def _plan(lib, device, mode, P, m, d, K, family=0, shared=False):
    """The launch plan for (mode, family, P, m, d, K, a shared target or
    not) on ``device``, made once: 8 int64s, the first the kernel's path
    (0 ``ovr_kernel`` or ``tiled_kernel``, 1 ``row_kernel``, 2 ``tc_kernel``
    for K2-MN, 3 ``tc_kernel`` for K2-OvR over one shared target)."""
    key = (device.index, mode, family, P, m, d, K, shared)
    plan = _plans.get(key)
    if plan is None:
        plan = (ctypes.c_longlong * _PLAN_WORDS)()
        _check(lib, lib.multiclass_plan(mode, family, P, m, d, K, int(shared), plan),
               "multiclass_plan")
        _plans[key] = plan
    return plan


def shared_target(Y) -> bool:
    """Whether ``Y`` (K, P, m) is one target expanded to K classes: a class
    stride of 0 over a contiguous ``Y[0]``, as ``y.expand(K, P, m)`` makes."""
    return Y.ndim == 3 and Y.stride(0) == 0 and Y[0].is_contiguous()


def _validate(x, y, mask, beta, active, y_shape, beta_shape, lanes):
    """Device, dtype, contiguity and shape checks the kernels rely on; a
    3-D ``y`` may also be a shared target (:func:`shared_target`)."""
    named = {"x": x, "y": y, "mask": mask, "beta": beta}
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not (t.is_contiguous() or (name == "y" and shared_target(t))):
            raise ValueError(f"{name} must be contiguous"
                             + (" or one target expanded to K" if name == "y" else ""))
    P, m, d = x.shape
    if (tuple(y.shape) != y_shape or tuple(mask.shape) != (P, m)
            or tuple(beta.shape) != beta_shape):
        raise ValueError(
            f"shapes disagree: x {tuple(x.shape)}, y {tuple(y.shape)} (want {y_shape}), "
            f"mask {tuple(mask.shape)}, beta {tuple(beta.shape)} (want {beta_shape})")
    if active is not None:
        if active.dtype != torch.bool or tuple(active.shape) != (lanes,):
            raise ValueError(f"active must be bool ({lanes},)")
        if active.device != x.device:
            raise ValueError(f"active is on {active.device}, x on {x.device}")


def _check_x(x, K):
    if not isinstance(x, torch.Tensor) or x.ndim != 3:
        raise ValueError("x must be a (P, m, d) tensor")
    P, m, d = x.shape
    if P == 0 or m == 0 or d == 0:
        raise ValueError("x must be non-empty")
    if P > 65535:
        raise ValueError(f"P = {P} shards is past the kernels' grid (65535)")
    if not 1 <= K <= MAX_CLASSES:
        raise ValueError(f"{K} classes: the kernels take 1 to {MAX_CLASSES}")
    if K * (d + 1) >= 2 ** 31:
        raise ValueError(f"{K} classes of {d} features: a block record past 2^31 floats")
    return P, m, d


def _launch(mode, x, y, mask, beta, active, K, lanes, grad, family="logistic"):
    P, m, d = x.shape
    # the class stride of an OvR target: P*m floats, or 0 where K share one
    ystride = y.stride(0) if mode == _OVR else 0
    fam = _FAMILIES[family]
    if x.device.type != "cuda":
        raise ValueError(f"the multi-class kernels run on cuda or cpu, not {x.device}")
    lib = _load()
    with torch.cuda.device(x.device):
        if active is None:
            active = torch.ones(lanes, dtype=torch.bool, device=x.device)
        # the kernels write only the active lanes: the others stay zero
        f = torch.zeros(lanes, dtype=torch.float32, device=x.device)
        g = torch.zeros(beta.shape, dtype=torch.float32, device=x.device) if grad else None
        plan = _plan(lib, x.device, mode, P, m, d, K, fam, ystride == 0)
        scratch = torch.empty(plan[6], dtype=torch.float32, device=x.device)
        err = lib.multiclass_value_and_grad(
            mode, fam, x.data_ptr(), y.data_ptr(), mask.data_ptr(), beta.data_ptr(),
            active.data_ptr(), P, m, d, K, ystride, int(grad), plan, scratch.data_ptr(),
            f.data_ptr(), g.data_ptr() if grad else None,
            torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "multiclass_value_and_grad")
    return f, g


# ------------------------------------------------------------------ OvR

def _ovr_ref(family, x, Y, mask, beta, active, grad):
    """Each problem k by K2's arithmetic for ``family`` (``glm_terms``) on
    ``Y[k]``: ``(f (K·P,), g (K·P, d) or None)``, the lanes that ``active``
    leaves out as zeros.  A shared target is read through its one copy."""
    K, P = Y.shape[0], x.shape[0]
    B = beta.view(K, P, -1)
    parts = [glm_terms(family, x, Y[k], mask, B[k], grad) for k in range(K)]
    f = torch.cat([fk for fk, _ in parts])
    g = torch.cat([gk for _, gk in parts]) if grad else None
    if active is not None:
        f = torch.where(active, f, 0.0)
        g = torch.where(active[:, None], g, 0.0) if grad else None
    return f, g


def logistic_ovr_value_and_grad_ref(x, Y, mask, beta, active=None, grad=True):
    """Plain version of K2-OvR's logistic family: ``(f (K·P,), g (K·P, d)
    or None)``; ``Y`` contiguous or a shared target."""
    logistic_ovr_value_and_grad_ref.calls += 1
    return _ovr_ref("logistic", x, Y, mask, beta, active, grad)


def normal_ovr_value_and_grad_ref(x, Y, mask, beta, active=None, grad=True):
    """Plain version of K2-OvR's Normal family (``f`` the masked half sum
    of squares, as the reference's loss); ``Y`` as above."""
    normal_ovr_value_and_grad_ref.calls += 1
    return _ovr_ref("normal", x, Y, mask, beta, active, grad)


def _ovr_checked(x, Y, mask, beta, active):
    K = Y.shape[0] if isinstance(Y, torch.Tensor) and Y.ndim == 3 else 0
    P, m, d = _check_x(x, max(K, 1))
    if K == 0:
        raise ValueError("Y must be (K, P, m)")
    _validate(x, Y, mask, beta, active, (K, P, m), (K * P, d), K * P)
    return K


def _ovr_wrappers(family, plain, loss, weight):
    """K2-OvR's two wrappers of one family: value-and-grad and value only,
    each counting its launches."""

    def value_and_grad(x, Y, mask, beta, active=None):
        K = _ovr_checked(x, Y, mask, beta, active)
        if x.device.type == "cpu":
            return plain(x, Y, mask, beta, active, True)
        f, g = _launch(_OVR, x, Y, mask, beta, active, K, K * x.shape[0], True, family)
        value_and_grad.launches += 1
        return f, g

    def value(x, Y, mask, beta, active=None):
        K = _ovr_checked(x, Y, mask, beta, active)
        if x.device.type == "cpu":
            return plain(x, Y, mask, beta, active, False)[0]
        f, _ = _launch(_OVR, x, Y, mask, beta, active, K, K * x.shape[0], False, family)
        value.launches += 1
        return f

    value_and_grad.__name__ = value_and_grad.__qualname__ = f"{family}_ovr_value_and_grad"
    value.__name__ = value.__qualname__ = f"{family}_ovr_value"
    value_and_grad.__doc__ = (
        f"Per lane l = k·P + p: ``f[l] = Σ_i mask·({loss})`` and ``g[l] = Σ_i "
        f"mask·({weight})·x_i`` with ``η = x[p] @ beta[l]`` and y = ``Y[k, p, i]``, over one "
        "read of x for all K problems.\n\n"
        "    ``x`` (P, m, d), ``mask`` (P, m), ``beta`` (K·P, d), all float32 and\n"
        "    contiguous; ``Y`` (K, P, m) float32, contiguous or one target expanded to\n"
        "    K (class stride 0, ``Y[0]`` contiguous), which the kernel stages once a\n"
        "    tile; ``active`` (K·P,) bool (default all): the other lanes are not read\n"
        "    and come back as zeros.\n    ")
    value.__doc__ = f"``f`` of :func:`{family}_ovr_value_and_grad` alone."
    value_and_grad.launches = 0
    value.launches = 0
    return value_and_grad, value


logistic_ovr_value_and_grad, logistic_ovr_value = _ovr_wrappers(
    "logistic", logistic_ovr_value_and_grad_ref, "softplus(η_i) − y·η_i", "σ(η_i) − y")
normal_ovr_value_and_grad, normal_ovr_value = _ovr_wrappers(
    "normal", normal_ovr_value_and_grad_ref, "(y − η_i)²/2", "η_i − y")


# ---------------------------------------------------------- multinomial

def multinomial_value_and_grad_ref(x, y, mask, beta, active=None, grad=True):
    """Plain version of K2-MN: ``(f (P,), g (P, d·K) or None)``; the lanes
    that ``active`` (P,) leaves out come back as zeros."""
    multinomial_value_and_grad_ref.calls += 1
    P, m, d = x.shape
    K = beta.shape[1] // d
    eta = torch.einsum("pmd,pdk->pmk", x, beta.view(P, d, K))
    lse = torch.logsumexp(eta, dim=2)
    # jax.nn.one_hot of y.astype(int32): truncation, no class outside [0, K)
    onehot = (y.to(torch.int64)[:, :, None]
              == torch.arange(K, device=x.device)).to(eta.dtype)
    f = torch.sum(mask * (lse - torch.sum(eta * onehot, dim=2)), dim=1)
    g = None
    if grad:
        w = mask[:, :, None] * (torch.softmax(eta, dim=2) - onehot)
        g = torch.einsum("pmd,pmk->pdk", x, w).reshape(P, d * K)
    if active is not None:
        f = torch.where(active, f, 0.0)
        g = torch.where(active[:, None], g, 0.0) if grad else None
    return f, g


def _mn_checked(x, y, mask, beta, active):
    if not isinstance(beta, torch.Tensor) or beta.ndim != 2 or not isinstance(x, torch.Tensor) \
            or x.ndim != 3 or x.shape[2] == 0 or beta.shape[1] % x.shape[2]:
        raise ValueError("beta must be (P, d·K) for x (P, m, d)")
    K = beta.shape[1] // x.shape[2]
    P, m, d = _check_x(x, K)
    _validate(x, y, mask, beta, active, (P, m), (P, d * K), P)
    return K


def multinomial_value_and_grad(x, y, mask, beta, active=None):
    """Per shard p: ``f[p] = Σ_i mask·(logsumexp(η_i) − η_i,y_i)`` and
    ``g[p][j, k] = Σ_i mask·(softmax_k(η_i) − [k = y_i])·x_ij`` with ``η_i =
    x[p, i] @ B[p]``, B[p] the ``(d, K)`` view of ``beta[p]``, over one
    read of x.

    ``x`` (P, m, d), ``y`` (P, m) class indices as floats, ``mask`` (P, m),
    ``beta`` (P, d·K), all float32 and contiguous; ``active`` (P,) bool
    (default all): the other lanes are not read and come back as zeros.
    """
    K = _mn_checked(x, y, mask, beta, active)
    if x.device.type == "cpu":
        return multinomial_value_and_grad_ref(x, y, mask, beta, active, True)
    f, g = _launch(_MN, x, y, mask, beta, active, K, x.shape[0], True)
    multinomial_value_and_grad.launches += 1
    return f, g


def multinomial_value(x, y, mask, beta, active=None):
    """``f`` of :func:`multinomial_value_and_grad` alone."""
    K = _mn_checked(x, y, mask, beta, active)
    if x.device.type == "cpu":
        return multinomial_value_and_grad_ref(x, y, mask, beta, active, False)[0]
    f, _ = _launch(_MN, x, y, mask, beta, active, K, x.shape[0], False)
    multinomial_value.launches += 1
    return f


multinomial_value_and_grad.launches = 0
multinomial_value.launches = 0
logistic_ovr_value_and_grad_ref.calls = 0
normal_ovr_value_and_grad_ref.calls = 0
multinomial_value_and_grad_ref.calls = 0
