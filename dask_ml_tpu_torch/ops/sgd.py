"""K4: minibatch SGD steps of a linear model, and the loss alone.

It replaces ``dask_ml_tpu/linear_model/_sgd.py :: sgd_step`` (the step of
``partial_fit``), ``:: sgd_epoch`` (a ``lax.scan`` of the step over an
epoch's minibatches) and ``:: _eval_loss_fn`` (the held-out loss of
``early_stopping``).  For one block x ``[B, d]`` float32, targets
``[B, K]``, a mask ``[B]`` and the state coef ``[d, K]``, intercept ``[K]``,
t ``[]``:

- margins = x·coef + intercept;
- per row and column, the loss and dLoss/dmargin: ``log_loss``, ``hinge``,
  ``squared_hinge`` and ``modified_huber`` on ±1 targets, ``squared_error``
  and ``huber`` (with ``epsilon``) on real targets;
- count = Σ mask (1 where it is 0), mean_loss = Σ mask·ℓ / count;
- gcoef = xᵀ·(mask·dℓ/count), gint = Σ rows of the same;
- the penalty (``l2``, ``l1``, ``elasticnet`` or None) and the learning
  rate of the schedule (``constant``, ``optimal``, ``invscaling``,
  ``adaptive``) at t;
- coef, intercept (with ``fit_intercept``) and t updated in place.

The hyperparameters are one float32 device tensor, in the order of
:data:`HYPER_KEYS`.  The CUDA source is ``csrc/sgd.cu``; it says what
bounds the kernel on an H100 and what its design does about it.  x, the
targets and the mask may be row-strided views (a minibatch ``rows[i::n_mb]``
of a padded block is one), as long as each row is contiguous.

Three wrappers: :func:`sgd_update` (the step), :func:`sgd_epoch` (an
epoch's steps over minibatch stacks ``(B, n_mb, ...)``, in one cooperative
launch) and :func:`sgd_loss` (the masked mean loss only).  At K = 1 and
d ≤ 256 a step, or the loss, is one launch: its blocks' records are summed
by the last block to finish, which a ticket on the device (0 between
launches) names.  Each writes its
``(mean loss, Σ mask)`` pairs on the device and reads nothing back to the
host.  Each runs its plain PyTorch version (``*_ref``) on a CPU tensor and
launches the kernel on a CUDA tensor, or raises.  Each counts its launches
in ``<wrapper>.launches``; the plain versions count their calls in
``<plain version>.calls``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_VP, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_PLAN_WORDS = 9
#: the kernel's ids of the losses, penalties and schedules
LOSSES = {"log_loss": 0, "hinge": 1, "squared_hinge": 2, "modified_huber": 3,
          "squared_error": 4, "huber": 5}
CLASSIFIER_LOSSES = ("log_loss", "hinge", "squared_hinge", "modified_huber")
PENALTIES = {None: 0, "l2": 1, "l1": 2, "elasticnet": 3}
SCHEDULES = {"constant": 0, "optimal": 1, "invscaling": 2, "adaptive": 3}
#: the order of the hyperparameter tensor
HYPER_KEYS = ("alpha", "eta0", "power_t", "t0", "l1_ratio", "epsilon", "eta_scale")
_lib = None
_plans: dict = {}
#: one scratch buffer a device for the block records, grown to the largest
#: plan's need (16 MB at most, or one block record where that is more)
_scratch: dict = {}
#: one ticket a device: the K = 1 step's count of blocks done, 0 between launches
_tickets: dict = {}


def _load():
    global _lib
    if _lib is None:
        lib = _build.load("sgd")
        lib.sgd_plan.argtypes = [_INT, _LL, _INT, _INT, _INT, _VP]
        lib.sgd_plan.restype = _INT
        lib.sgd_step.argtypes = [_VP, _INT, _INT, _INT, _INT, _INT, _VP, _LL, _VP, _LL, _VP, _LL,
                                 _VP, _VP, _VP, _VP, _LL, _INT, _INT, _VP, _VP, _VP, _VP]
        lib.sgd_step.restype = _INT
        lib.sgd_epoch_run.argtypes = [_VP, _INT, _INT, _INT, _INT, _VP, _LL, _LL, _VP, _LL, _LL,
                                      _VP, _LL, _LL, _VP, _VP, _VP, _VP, _LL, _INT, _INT, _INT,
                                      _VP, _VP, _VP]
        lib.sgd_epoch_run.restype = _INT
        lib.sgd_error_string.argtypes = [_INT]
        lib.sgd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(lib, err, what):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.sgd_error_string(err).decode()})")


def _plan(lib, device, loss_id, B, d, K, epoch=False):
    """The launch plan for (loss, B, d, K) on ``device`` (with ``epoch``:
    an epoch's, B the rows of one minibatch), made once, and the device's
    scratch for the block records (one stream uses it at a time; a buffer
    outgrown is freed in the stream's order by the allocator)."""
    key = (device.index, loss_id, B, d, K, epoch)
    plan = _plans.get(key)
    if plan is None:
        plan = (ctypes.c_longlong * _PLAN_WORDS)()
        _check(lib, lib.sgd_plan(loss_id, B, d, K, int(epoch), plan),
               "sgd_plan (an epoch needs every block resident at once)" if epoch
               else "sgd_plan")
        _plans[key] = plan
    scratch = _scratch.get(device.index)
    if scratch is None or scratch.numel() < plan[6]:
        scratch = torch.empty(max(int(plan[6]), 1), dtype=torch.float32, device=device)
        _scratch[device.index] = scratch
    return plan, scratch


def _ticket(device):
    """The device's ticket for the K = 1 step's finish (made zeroed once; each
    launch leaves it 0)."""
    ticket = _tickets.get(device.index)
    if ticket is None:
        ticket = _tickets[device.index] = torch.zeros(1, dtype=torch.int32, device=device)
    return ticket


# ------------------------------------------------------------ plain versions

def row_losses(loss, margins, y, epsilon):
    """Per row and column ``(ℓ, dℓ/dmargin)`` for ``margins`` and ``y``
    ``[B, K]``: ±1 targets for the classifier losses (the reference's
    ``_margin_losses``), real targets for ``squared_error`` and ``huber``
    (``_regression_losses``), with the reference's comparisons at the kinks."""
    if loss in CLASSIFIER_LOSSES:
        z = y * margins
        if loss == "log_loss":
            ell = torch.logaddexp(torch.zeros_like(z), -z)
            dz = -torch.sigmoid(-z)
        elif loss == "hinge":
            ell = torch.clamp(1.0 - z, min=0.0)
            dz = torch.where(z < 1.0, -1.0, 0.0)
        elif loss == "squared_hinge":
            h = torch.clamp(1.0 - z, min=0.0)
            ell = h * h
            dz = -2.0 * h
        else:  # modified_huber
            h = torch.clamp(1.0 - z, min=0.0)
            ell = torch.where(z >= -1.0, h * h, -4.0 * z)
            dz = torch.where(z >= -1.0, -2.0 * h, -4.0)
        return ell, dz * y
    r = margins - y
    if loss == "squared_error":
        return 0.5 * r * r, r
    if loss == "huber":
        a = torch.abs(r)
        ell = torch.where(a <= epsilon, 0.5 * r * r, epsilon * (a - 0.5 * epsilon))
        return ell, torch.where(a <= epsilon, r, epsilon * torch.sign(r))
    raise ValueError(f"unknown loss {loss!r}")


def learning_rate(schedule, t, hyper):
    """eta at step t (reference: ``_sgd.py :: _learning_rate``)."""
    alpha, eta0, power_t, t0 = hyper[0], hyper[1], hyper[2], hyper[3]
    if schedule == "constant":
        return eta0
    if schedule == "adaptive":
        return eta0 * hyper[6]
    if schedule == "optimal":
        return 1.0 / (alpha * (t0 + t))
    if schedule == "invscaling":
        return eta0 / torch.pow(t + 1.0, power_t)
    raise ValueError(f"unknown learning_rate {schedule!r}")


def _masked_terms(x, y, mask, coef, intercept, hyper, loss):
    margins = x @ coef + intercept
    ell, dmarg = row_losses(loss, margins, y, hyper[5])
    m = mask[:, None].to(margins.dtype)
    total = torch.sum(mask)
    count = torch.where(total > 0, total, torch.ones_like(total))
    return ell, dmarg, m, total, count


def sgd_update_ref(x, y, mask, coef, intercept, t, hyper, *, loss, penalty, schedule,
                   fit_intercept=True, out=None):
    """Plain version of :func:`sgd_update`, in the reference's arithmetic
    (each row's dℓ divided by the count before the product)."""
    sgd_update_ref.calls += 1
    return update_ref(x, y, mask, coef, intercept, t, hyper, loss=loss, penalty=penalty,
                      schedule=schedule, fit_intercept=fit_intercept, out=out)


def update_ref(x, y, mask, coef, intercept, t, hyper, *, loss, penalty, schedule,
               fit_intercept=True, out=None):
    """The arithmetic of :func:`sgd_update_ref`, uncounted: the step of each
    member of K5′'s plain version (``ops/ensemble.py``) too."""
    ell, dmarg, m, total, count = _masked_terms(x, y, mask, coef, intercept, hyper, loss)
    mean_loss = torch.sum(ell * m) / count
    dmarg = dmarg * m / count
    gcoef = x.T @ dmarg
    gint = torch.sum(dmarg, dim=0)
    alpha = hyper[0]
    if penalty == "l2":
        gcoef = gcoef + alpha * coef
    elif penalty == "l1":
        gcoef = gcoef + alpha * torch.sign(coef)
    elif penalty == "elasticnet":
        l1r = hyper[4]
        gcoef = gcoef + alpha * (l1r * torch.sign(coef) + (1.0 - l1r) * coef)
    eta = learning_rate(schedule, t, hyper)
    coef.copy_(coef - eta * gcoef)
    if fit_intercept:
        intercept.copy_(intercept - eta * gint)
    t.copy_(t + 1.0)
    out = torch.empty(2, dtype=torch.float32, device=x.device) if out is None else out
    out[0] = mean_loss
    out[1] = total
    return out


def sgd_epoch_ref(xs, ys, ms, coef, intercept, t, hyper, *, loss, penalty, schedule,
                  fit_intercept=True, out=None):
    """Plain version of :func:`sgd_epoch`: a step of :func:`sgd_update_ref`
    for each minibatch ``xs[:, i]``, in order, its pair in ``out[i]``."""
    sgd_epoch_ref.calls += 1
    n_mb = xs.shape[1]
    out = torch.empty((n_mb, 2), dtype=xs.dtype, device=xs.device) if out is None else out
    for i in range(n_mb):
        sgd_update_ref(xs[:, i], ys[:, i], ms[:, i], coef, intercept, t, hyper, loss=loss,
                       penalty=penalty, schedule=schedule, fit_intercept=fit_intercept,
                       out=out[i])
    return out


def sgd_loss_ref(x, y, mask, coef, intercept, hyper, *, loss, out=None):
    """Plain version of :func:`sgd_loss`."""
    sgd_loss_ref.calls += 1
    ell, _, m, total, count = _masked_terms(x, y, mask, coef, intercept, hyper, loss)
    out = torch.empty(2, dtype=torch.float32, device=x.device) if out is None else out
    out[0] = torch.sum(ell * m) / count
    out[1] = total
    return out


# ------------------------------------------------------------------ wrappers

def _validate(x, y, mask, coef, intercept, t, hyper, out, loss, penalty, schedule):
    """Names, devices, types, shapes and strides the kernel relies on."""
    if loss not in LOSSES:
        raise ValueError(f"loss must be one of {tuple(LOSSES)}")
    if penalty not in PENALTIES:
        raise ValueError(f"penalty must be one of {tuple(PENALTIES)}")
    if schedule is not None and schedule not in SCHEDULES:
        raise ValueError(f"learning_rate must be one of {tuple(SCHEDULES)}")
    if not isinstance(x, torch.Tensor) or x.ndim != 2:
        raise ValueError("x must be a (B, d) tensor")
    if x.dtype == torch.bfloat16:
        raise NotImplementedError(
            "a bfloat16 x is not ported yet (ROADMAP: bf16 K4); pass float32")
    named = {"x": x, "y": y, "mask": mask, "coef": coef, "intercept": intercept, "t": t,
             "hyper": hyper, "out": out}
    for name, v in named.items():
        if v is None and name in ("t", "out"):
            continue
        if not isinstance(v, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if v.device != x.device:
            raise ValueError(f"{name} is on {v.device}, x on {x.device}")
        if v.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {v.dtype}")
    B, d = x.shape
    if y.ndim != 2 or y.shape[0] != B or tuple(mask.shape) != (B,):
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, y {tuple(y.shape)}, "
                         f"mask {tuple(mask.shape)}")
    K = y.shape[1]
    if (tuple(coef.shape) != (d, K) or tuple(intercept.shape) != (K,)
            or tuple(hyper.shape) != (len(HYPER_KEYS),)
            or (t is not None and t.ndim != 0) or (out is not None and tuple(out.shape) != (2,))):
        raise ValueError(f"state shapes disagree with x {tuple(x.shape)} and y {tuple(y.shape)}: "
                         f"coef {tuple(coef.shape)}, intercept {tuple(intercept.shape)}")
    if d == 0 or K == 0:
        raise ValueError("x and y must have columns")
    if loss not in CLASSIFIER_LOSSES and K != 1:
        raise ValueError(f"{loss} takes one target column, got {K}")
    for name in ("coef", "intercept", "hyper", "out"):
        v = named[name]
        if v is not None and not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (d > 1 and x.stride(1) != 1) or (K > 1 and y.stride(1) != 1):
        raise ValueError("each row of x and y must be contiguous")
    if K * (d + 1) + 2 >= 2 ** 31:
        raise ValueError(f"{K} columns of {d} features: a block record past 2^31 floats")


def _cuda_lib(x):
    if x.device.type != "cuda":
        raise ValueError(f"K4 runs on cuda or cpu, not {x.device}")
    return _load()


def _launch(x, y, mask, coef, intercept, t, hyper, out, loss, penalty, schedule, fit_intercept,
            grad):
    lib = _cuda_lib(x)
    B, d = x.shape
    K = y.shape[1]
    with torch.cuda.device(x.device):
        if out is None:
            out = torch.empty(2, dtype=torch.float32, device=x.device)
        plan, scratch = _plan(lib, x.device, LOSSES[loss], B, d, K)
        err = lib.sgd_step(
            plan, LOSSES[loss], int(grad), PENALTIES[penalty],
            SCHEDULES[schedule] if grad else 0, int(fit_intercept),
            x.data_ptr(), x.stride(0), y.data_ptr(), y.stride(0), mask.data_ptr(),
            mask.stride(0), coef.data_ptr(), intercept.data_ptr(),
            t.data_ptr() if grad else None, hyper.data_ptr(), B, d, K, scratch.data_ptr(),
            _ticket(x.device).data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "sgd_step")
    return out


def sgd_update(x, y, mask, coef, intercept, t, hyper, *, loss, penalty, schedule,
               fit_intercept=True, out=None):
    """One SGD step on the state (coef, intercept, t), in place; returns
    ``out`` (2,) = (mean loss, Σ mask), allocated when not given.  No host
    read."""
    _validate(x, y, mask, coef, intercept, t, hyper, out, loss, penalty, schedule)
    if t is None or t.ndim != 0:
        raise ValueError("t must be a 0-d tensor")
    if x.device.type == "cpu":
        return sgd_update_ref(x, y, mask, coef, intercept, t, hyper, loss=loss, penalty=penalty,
                              schedule=schedule, fit_intercept=fit_intercept, out=out)
    out = _launch(x, y, mask, coef, intercept, t, hyper, out, loss, penalty, schedule,
                  fit_intercept, True)
    sgd_update.launches += 1
    return out


def sgd_epoch(xs, ys, ms, coef, intercept, t, hyper, *, loss, penalty, schedule,
              fit_intercept=True, out=None):
    """An epoch: one step for each minibatch ``i`` of the stacks ``xs``
    ``(B, n_mb, d)``, ``ys`` ``(B, n_mb, K)`` and ``ms`` ``(B, n_mb)`` (the
    strided views ``xs[:, i]``, read where they lie), in order, on the state
    in place; returns ``out`` ``(n_mb, 2)``, each step's (mean loss, Σ
    mask), allocated when not given.  Validated once an epoch; on the card
    one cooperative launch, no host read.  ``n_mb`` must be at least 2 (one
    minibatch is :func:`sgd_update`'s step)."""
    if not all(isinstance(v, torch.Tensor) for v in (xs, ys, ms)) or (xs.ndim, ys.ndim,
                                                                      ms.ndim) != (3, 3, 2):
        raise ValueError("xs, ys and ms must be (B, n_mb, d), (B, n_mb, K) and (B, n_mb) "
                         "tensors")
    if ys.shape[:2] != xs.shape[:2] or ms.shape != xs.shape[:2]:
        raise ValueError(f"stacks disagree: xs {tuple(xs.shape)}, ys {tuple(ys.shape)}, "
                         f"ms {tuple(ms.shape)}")
    n_mb = xs.shape[1]
    if n_mb < 2:
        raise ValueError(f"an epoch of {n_mb} minibatch: one step is sgd_update's")
    _validate(xs[:, 0], ys[:, 0], ms[:, 0], coef, intercept, t, hyper, None, loss, penalty,
              schedule)
    if t is None or t.ndim != 0:
        raise ValueError("t must be a 0-d tensor")
    if out is not None and (not isinstance(out, torch.Tensor) or tuple(out.shape) != (n_mb, 2)
                            or out.dtype != torch.float32 or out.device != xs.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 ({n_mb}, 2) tensor on {xs.device}")
    if xs.device.type == "cpu":
        return sgd_epoch_ref(xs, ys, ms, coef, intercept, t, hyper, loss=loss, penalty=penalty,
                             schedule=schedule, fit_intercept=fit_intercept, out=out)
    lib = _cuda_lib(xs)
    B, _, d = xs.shape
    K = ys.shape[2]
    with torch.cuda.device(xs.device):
        if out is None:
            out = torch.empty((n_mb, 2), dtype=torch.float32, device=xs.device)
        plan, scratch = _plan(lib, xs.device, LOSSES[loss], B, d, K, epoch=True)
        err = lib.sgd_epoch_run(
            plan, LOSSES[loss], PENALTIES[penalty], SCHEDULES[schedule], int(fit_intercept),
            xs.data_ptr(), xs.stride(0), xs.stride(1), ys.data_ptr(), ys.stride(0),
            ys.stride(1), ms.data_ptr(), ms.stride(0), ms.stride(1), coef.data_ptr(),
            intercept.data_ptr(), t.data_ptr(), hyper.data_ptr(), B, n_mb, d, K,
            scratch.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _check(lib, err, "sgd_epoch_run")
    sgd_epoch.launches += 1
    return out


def sgd_loss(x, y, mask, coef, intercept, hyper, *, loss, out=None):
    """The masked mean loss of the state on a block: ``out`` (2,) = (mean
    loss, Σ mask).  No host read."""
    _validate(x, y, mask, coef, intercept, None, hyper, out, loss, None, None)
    if x.device.type == "cpu":
        return sgd_loss_ref(x, y, mask, coef, intercept, hyper, loss=loss, out=out)
    out = _launch(x, y, mask, coef, intercept, None, hyper, out, loss, None, None, False, False)
    sgd_loss.launches += 1
    return out


sgd_update.launches = 0
sgd_epoch.launches = 0
sgd_loss.launches = 0
sgd_update_ref.calls = 0
sgd_epoch_ref.calls = 0
sgd_loss_ref.calls = 0
