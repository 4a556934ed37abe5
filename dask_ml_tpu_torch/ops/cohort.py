"""K5: one SGD step of M linear models that share a block.

It replaces ``dask_ml_tpu/model_selection/_packing.py :: _packed_step_impl``
(``jax.vmap`` of ``linear_model/_sgd.py :: sgd_step`` over a stacked model
axis), the step that lets a cohort of M same-key models of a search advance
on a block in one launch.  For x ``[B, d]`` float32 and targets ``[B, K]``
shared by the cohort, masks ``[M, B]`` (a stride-0 broadcast of one mask
unless a member has a ``class_weight`` dict) and the stacked state coef
``[M, d, K]``, intercept ``[M, K]``, t ``[M]``, hyperparameters ``[M, 7]``
(the order of :data:`ops.sgd.HYPER_KEYS`), each lane takes K4's step
(``ops/sgd.py``) on its own state, mask and hyperparameters.  The loss,
penalty, schedule and ``fit_intercept`` are one per cohort.

:func:`cohort_step` writes the M ``(mean loss, Σ mask)`` pairs on the device
and reads nothing back to the host.  It runs its plain PyTorch version
:func:`cohort_step_ref` on a CPU tensor and launches the kernel
(``csrc/cohort.cu``, which says what bounds it on an H100) on a CUDA tensor,
or raises.  It counts its launches in ``cohort_step.launches``; the plain
version counts its calls in ``cohort_step_ref.calls``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .sgd import CLASSIFIER_LOSSES, HYPER_KEYS, LOSSES, PENALTIES, SCHEDULES, learning_rate, \
    row_losses

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_PLAN_WORDS = 6
_lib = None
_plans: dict = {}
#: one scratch buffer a device for the block records, grown to the largest
#: plan's need
_scratch: dict = {}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("cohort")
        lib.cohort_plan.argtypes = [_INT, _LL, _INT, _INT, _INT, _VP]
        lib.cohort_plan.restype = _INT
        lib.cohort_step.argtypes = [_VP, _INT, _INT, _INT, _INT, _VP, _LL, _VP, _LL, _VP, _LL,
                                    _LL, _VP, _VP, _VP, _VP, _LL, _INT, _INT, _INT, _VP, _VP,
                                    _VP]
        lib.cohort_step.restype = _INT
        lib.cohort_error_string.argtypes = [_INT]
        lib.cohort_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.cohort_error_string(err).decode()})")


def _plan(lib, device, loss_id, B, d, K, M):
    """The launch plan for (loss, B, d, K, M) on ``device``, made once, and
    the device's scratch (one stream uses it at a time; a buffer outgrown is
    freed in the stream's order by the allocator)."""
    key = (device.index, loss_id, B, d, K, M)
    plan = _plans.get(key)
    if plan is None:
        plan = (ctypes.c_longlong * _PLAN_WORDS)()
        _check(lib, lib.cohort_plan(loss_id, B, d, K, M, plan), "cohort_plan")
        _plans[key] = plan
    scratch = _scratch.get(device.index)
    if scratch is None or scratch.numel() < plan[3]:
        scratch = torch.empty(int(plan[3]), dtype=torch.float32, device=device)
        _scratch[device.index] = scratch
    return plan, scratch


def cohort_step_ref(x, y, masks, coef, intercept, t, hypers, *, loss, penalty, schedule,
                    fit_intercept=True, out=None):
    """Plain version of :func:`cohort_step`: ``ops.sgd.sgd_update_ref``'s
    arithmetic batched over the lane axis, in the dtype of its inputs (the
    reference's: each row's dℓ divided by its lane's count before the
    product)."""
    cohort_step_ref.calls += 1
    h = hypers.T  # (7, M): h[i] is hyperparameter i of every lane
    margins = torch.matmul(x, coef) + intercept[:, None, :]  # (M, B, K)
    ell, dmarg = row_losses(loss, margins, y[None], h[5][:, None, None])
    m = masks[:, :, None].to(margins.dtype)
    total = torch.sum(masks, dim=1)
    count = torch.where(total > 0, total, torch.ones_like(total))
    mean_loss = torch.sum(ell * m, dim=(1, 2)) / count
    dmarg = dmarg * m / count[:, None, None]
    gcoef = torch.matmul(x.T, dmarg)  # (M, d, K)
    gint = torch.sum(dmarg, dim=1)
    alpha = h[0][:, None, None]
    if penalty == "l2":
        gcoef = gcoef + alpha * coef
    elif penalty == "l1":
        gcoef = gcoef + alpha * torch.sign(coef)
    elif penalty == "elasticnet":
        l1r = h[4][:, None, None]
        gcoef = gcoef + alpha * (l1r * torch.sign(coef) + (1.0 - l1r) * coef)
    eta = learning_rate(schedule, t, h)  # (M,)
    coef.copy_(coef - eta[:, None, None] * gcoef)
    if fit_intercept:
        intercept.copy_(intercept - eta[:, None] * gint)
    t.copy_(t + 1.0)
    if out is None:
        out = torch.empty((coef.shape[0], 2), dtype=torch.float32, device=x.device)
    out[:, 0] = mean_loss
    out[:, 1] = total
    return out


def _validate(x, y, masks, coef, intercept, t, hypers, out, loss, penalty, schedule):
    """Names, devices, types, shapes and strides the kernel relies on."""
    if loss not in LOSSES:
        raise ValueError(f"loss must be one of {tuple(LOSSES)}")
    if penalty not in PENALTIES:
        raise ValueError(f"penalty must be one of {tuple(PENALTIES)}")
    if schedule not in SCHEDULES:
        raise ValueError(f"learning_rate must be one of {tuple(SCHEDULES)}")
    named = {"x": x, "y": y, "masks": masks, "coef": coef, "intercept": intercept, "t": t,
             "hypers": hypers, "out": out}
    for name, v in named.items():
        if v is None and name == "out":
            continue
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if v.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {v.dtype}")
    if x.ndim != 2 or y.ndim != 2 or masks.ndim != 2:
        raise ValueError("x, y and masks must be (B, d), (B, K) and (M, B)")
    B, d = x.shape
    K = y.shape[1]
    M = masks.shape[0]
    if y.shape[0] != B or masks.shape[1] != B:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, y {tuple(y.shape)}, "
                         f"masks {tuple(masks.shape)}")
    if (tuple(coef.shape) != (M, d, K) or tuple(intercept.shape) != (M, K)
            or tuple(t.shape) != (M,) or tuple(hypers.shape) != (M, len(HYPER_KEYS))
            or (out is not None and tuple(out.shape) != (M, 2))):
        raise ValueError(f"state shapes disagree with x {tuple(x.shape)}, y {tuple(y.shape)} "
                         f"and {M} lanes: coef {tuple(coef.shape)}, intercept "
                         f"{tuple(intercept.shape)}, t {tuple(t.shape)}, hypers "
                         f"{tuple(hypers.shape)}")
    if B == 0 or d == 0 or K == 0 or M == 0:
        raise ValueError("x, y and masks must have rows, columns and lanes")
    if loss not in CLASSIFIER_LOSSES and K != 1:
        raise ValueError(f"{loss} takes one target column, got {K}")
    for name in ("coef", "intercept", "t", "hypers", "out"):
        v = named[name]
        if v is not None and not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (d > 1 and x.stride(1) != 1) or (K > 1 and y.stride(1) != 1):
        raise ValueError("each row of x and y must be contiguous")
    if M * K * (d + 3) >= 2 ** 31:
        raise ValueError(f"{M} lanes of {K} columns of {d} features: a block record past "
                         "2^31 floats")


def cohort_step(x, y, masks, coef, intercept, t, hypers, *, loss, penalty, schedule,
                fit_intercept=True, out=None):
    """One SGD step of each of the M lanes on the shared block, on the
    stacked state (coef, intercept, t) in place; returns ``out`` (M, 2), each
    lane's (mean loss, Σ mask), allocated when not given.  No host read."""
    _validate(x, y, masks, coef, intercept, t, hypers, out, loss, penalty, schedule)
    if x.device.type == "cpu":
        return cohort_step_ref(x, y, masks, coef, intercept, t, hypers, loss=loss,
                               penalty=penalty, schedule=schedule, fit_intercept=fit_intercept,
                               out=out)
    if x.device.type != "cuda":
        raise ValueError(f"K5 runs on cuda or cpu, not {x.device}")
    lib = _load()
    B, d = x.shape
    K, M = y.shape[1], masks.shape[0]
    with torch.cuda.device(x.device):
        if out is None:
            out = torch.empty((M, 2), dtype=torch.float32, device=x.device)
        plan, scratch = _plan(lib, x.device, LOSSES[loss], B, d, K, M)
        err = lib.cohort_step(
            plan, LOSSES[loss], PENALTIES[penalty], SCHEDULES[schedule], int(fit_intercept),
            x.data_ptr(), x.stride(0), y.data_ptr(), y.stride(0), masks.data_ptr(),
            masks.stride(0), masks.stride(1), coef.data_ptr(), intercept.data_ptr(),
            t.data_ptr(), hypers.data_ptr(), B, d, K, M, scratch.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "cohort_step")
    cohort_step.launches += 1
    return out


cohort_step.launches = 0
cohort_step_ref.calls = 0
