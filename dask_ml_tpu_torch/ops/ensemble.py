"""K5′: one SGD step of each of M linear models, each on its own window of X.

It replaces ``dask_ml_tpu/ensemble/_blockwise.py :: _ensemble_epoch``
(``jax.vmap`` of ``linear_model/_sgd.py :: sgd_step`` over a stacked state,
each model's own block, its own mask and its own hyperparameters): the
epoch of a blockwise voting ensemble.  For x ``[n, d]`` float32 and targets
``[n, K]``, window starts ``st`` (M ints), masks ``[M, B]`` and the stacked
state coef ``[M, d, K]``, intercept ``[M, K]``, t ``[M]``, hyperparameters
``[M, 7]`` (the order of :data:`ops.sgd.HYPER_KEYS`), member ``m`` takes
K4's step (``ops/sgd.py``) on rows ``st[m] .. st[m] + B`` of x and y, read
where they lie (windows may overlap), with mask row ``m``, its own state
and its own hyperparameters.  K5 (``ops/cohort.py``) is the form where the
M models share one block.

:func:`group_step` writes the M ``(mean loss, Σ mask)`` pairs on the device
and reads nothing back to the host.  It runs its plain PyTorch version
:func:`group_step_ref` on a CPU tensor and launches the kernel
(``csrc/sgd.cu :: sgd_group_step``, one launch for the whole ensemble,
which says what bounds it on an H100) on a CUDA tensor, or raises.  The
window starts are host ints, checked on the host at every call; their
device copy is made once for a tuple and a device (:func:`group_offsets`).
It counts its launches in ``group_step.launches``; the plain version counts
its calls in ``group_step_ref.calls``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .sgd import CLASSIFIER_LOSSES, HYPER_KEYS, LOSSES, PENALTIES, SCHEDULES, update_ref

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_PLAN_WORDS = 9
_lib = None
_plans: dict = {}
#: one scratch buffer a device for the block records, grown to the largest plan's need
_scratch: dict = {}
#: one ticket array a device, a ticket a member, 0 between launches, grown with M
_tickets: dict = {}
#: the device copies of window starts, by (starts, device)
_offsets: dict = {}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("sgd")
        lib.sgd_group_plan.argtypes = [_INT, _LL, _INT, _INT, _INT, _VP]
        lib.sgd_group_plan.restype = _INT
        lib.sgd_group_step.argtypes = [_VP, _INT, _INT, _INT, _INT, _VP, _LL, _VP, _LL, _VP,
                                       _LL, _LL, _VP, _VP, _VP, _VP, _VP, _LL, _INT, _INT, _INT,
                                       _VP, _VP, _VP, _VP]
        lib.sgd_group_step.restype = _INT
        lib.sgd_error_string.argtypes = [_INT]
        lib.sgd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.sgd_error_string(err).decode()})")


def _plan(lib, device, loss_id, B, d, K, M):
    """The launch plan for (loss, B, d, K, M) on ``device``, made once, the
    device's scratch (one stream uses it at a time) and its M tickets."""
    key = (device.index, loss_id, B, d, K, M)
    plan = _plans.get(key)
    if plan is None:
        plan = (ctypes.c_longlong * _PLAN_WORDS)()
        _check(lib, lib.sgd_group_plan(loss_id, B, d, K, M, plan), "sgd_group_plan")
        _plans[key] = plan
    scratch = _scratch.get(device.index)
    if scratch is None or scratch.numel() < plan[6]:
        scratch = torch.empty(int(plan[6]), dtype=torch.float32, device=device)
        _scratch[device.index] = scratch
    tickets = _tickets.get(device.index)
    if tickets is None or tickets.numel() < M:
        tickets = torch.zeros(M, dtype=torch.int32, device=device)
        _tickets[device.index] = tickets
    return plan, scratch, tickets


def group_offsets(starts, device):
    """The window starts as an int64 tensor on ``device``, copied once for a
    tuple of starts and a device (through page-locked memory to a card, so
    the copy waits for nothing)."""
    starts = tuple(int(s) for s in starts)
    device = torch.device(device)
    key = (starts, device)
    st = _offsets.get(key)
    if st is None:
        host = torch.tensor(starts, dtype=torch.int64)
        if device.type == "cuda":
            host = host.pin_memory()
        st = _offsets[key] = host.to(device, non_blocking=True)
    return st


def group_step_ref(x, y, starts, masks, coef, intercept, t, hypers, *, loss, penalty, schedule,
                   fit_intercept=True, out=None):
    """Plain version of :func:`group_step`: ``ops.sgd.sgd_update_ref``'s
    arithmetic on each member's window (a view of x and y, no copy), its
    state slices updated in place (the reference's: each row's dℓ divided by
    its member's count before the product), in the dtype of its inputs."""
    group_step_ref.calls += 1
    M, B = masks.shape
    if out is None:
        out = torch.empty((M, 2), dtype=x.dtype, device=x.device)
    for m, s in enumerate(starts):
        update_ref(x[s:s + B], y[s:s + B], masks[m], coef[m], intercept[m], t[m], hypers[m],
                   loss=loss, penalty=penalty, schedule=schedule, fit_intercept=fit_intercept,
                   out=out[m])
    return out


def _validate(x, y, starts, masks, coef, intercept, t, hypers, out, loss, penalty, schedule):
    """Names, devices, types, shapes, strides and windows the kernel relies on."""
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
        raise ValueError("x, y and masks must be (n, d), (n, K) and (M, B)")
    n, d = x.shape
    K = y.shape[1]
    M, B = masks.shape
    if y.shape[0] != n:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, y {tuple(y.shape)}")
    if (tuple(coef.shape) != (M, d, K) or tuple(intercept.shape) != (M, K)
            or tuple(t.shape) != (M,) or tuple(hypers.shape) != (M, len(HYPER_KEYS))
            or (out is not None and tuple(out.shape) != (M, 2))):
        raise ValueError(f"state shapes disagree with x {tuple(x.shape)}, y {tuple(y.shape)} "
                         f"and {M} members: coef {tuple(coef.shape)}, intercept "
                         f"{tuple(intercept.shape)}, t {tuple(t.shape)}, hypers "
                         f"{tuple(hypers.shape)}")
    if B == 0 or d == 0 or K == 0 or M == 0:
        raise ValueError("x, y and masks must have rows, columns and members")
    if len(starts) != M:
        raise ValueError(f"{len(starts)} window starts for {M} members")
    if any(not 0 <= int(s) <= n - B for s in starts):
        raise ValueError(f"a window of {B} rows starting at {list(starts)} leaves x's {n} rows")
    if loss not in CLASSIFIER_LOSSES and K != 1:
        raise ValueError(f"{loss} takes one target column, got {K}")
    for name in ("coef", "intercept", "t", "hypers", "out"):
        v = named[name]
        if v is not None and not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (d > 1 and x.stride(1) != 1) or (K > 1 and y.stride(1) != 1):
        raise ValueError("each row of x and y must be contiguous")
    if M * K * (d + 3) >= 2 ** 31:
        raise ValueError(f"{M} members of {K} columns of {d} features: records past 2^31 floats")


def group_step(x, y, starts, masks, coef, intercept, t, hypers, *, loss, penalty, schedule,
               fit_intercept=True, out=None):
    """One SGD step of each of the M members on its own window ``x[st:st +
    B]``, on the stacked state (coef, intercept, t) in place; returns ``out``
    (M, 2), each member's (mean loss, Σ mask), allocated when not given.  No
    host read."""
    _validate(x, y, starts, masks, coef, intercept, t, hypers, out, loss, penalty, schedule)
    if x.device.type == "cpu":
        return group_step_ref(x, y, starts, masks, coef, intercept, t, hypers, loss=loss,
                              penalty=penalty, schedule=schedule, fit_intercept=fit_intercept,
                              out=out)
    if x.device.type != "cuda":
        raise ValueError(f"K5′ runs on cuda or cpu, not {x.device}")
    lib = _load()
    d, K = x.shape[1], y.shape[1]
    M, B = masks.shape
    with torch.cuda.device(x.device):
        if out is None:
            out = torch.empty((M, 2), dtype=torch.float32, device=x.device)
        plan, scratch, tickets = _plan(lib, x.device, LOSSES[loss], B, d, K, M)
        st = group_offsets(starts, x.device)
        err = lib.sgd_group_step(
            plan, LOSSES[loss], PENALTIES[penalty], SCHEDULES[schedule], int(fit_intercept),
            x.data_ptr(), x.stride(0), y.data_ptr(), y.stride(0), masks.data_ptr(),
            masks.stride(0), masks.stride(1), st.data_ptr(), coef.data_ptr(),
            intercept.data_ptr(), t.data_ptr(), hypers.data_ptr(), B, d, K, M,
            scratch.data_ptr(), tickets.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "sgd_group_step")
    group_step.launches += 1
    return out


group_step.launches = 0
group_step_ref.calls = 0
