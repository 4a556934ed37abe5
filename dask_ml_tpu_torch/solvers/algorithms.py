"""Solver algorithms: the port of ``dask_ml_tpu/solvers/algorithms.py``
(``admm``, ``lbfgs``, ``gradient_descent``, ``proximal_grad``, ``newton``
and ``packed_solve``).

The reference runs each solve as one XLA program: ADMM's per-shard local
L-BFGS solves run inside ``shard_map``, one per device, joined by psums.
The port views the padded rows as ``(P, n/P, d)`` contiguous row shards,
as ``shard_map`` splits them (pad rows in the last), and runs the P local
solves as the lanes of one batched L-BFGS (``lbfgs_core``) whose objective
evaluations are K2 launches over all lanes at once; the psums become sums
over the lane axis.  The consensus step, the Boyd residuals and the
adaptive ρ step stay on the device as small tensors; the loop reads one
flag per round on the host (``lbfgs_core.HOST_SYNCS``).  The single-lane
solvers (``lbfgs``, ``gradient_descent``, ``proximal_grad``, ``newton``)
take all rows as one shard and are batched over lanes the same way, each
lane with its own step size and stopping flags.

``packed_solve`` runs K one-vs-rest problems over the same rows as K·P
lanes of the same batched loops (K for the single-lane solvers), the
reference's vmap over its whole-solve ``while_loop`` written out: their
objective evaluations are K2-OvR launches, one read of x for all K
classes, and the ADMM loop keeps K consensus vectors, one ρ, one residual
pair and one round count a class, still reading one flag a loop step for
all lanes.

``lambda_sweep`` runs L solves of the same (X, y) at L values of λ as the
lanes of one batched solve (L·P for ``admm``): λ is an (L,) tensor, one
value a lane, wherever it enters (the penalty and its gradient, the
prox, Newton's ``H + λI``), and y reaches the lanes as one stride-0 view,
which K2-OvR stages once a tile for all of them.  Every runner also takes
a scalar λ, with the bits it always had.

A bfloat16 design matrix stays bf16 (the reference's mixed precision): K2
reads it as bf16, and β, y, every sum and ADMM's z, u and residuals are
float32.  Not ported yet (ROADMAP: [port-admm]): the ``probe_grid`` line
search and bf16 X for multi-class fits and sweeps.
"""

from __future__ import annotations

import logging
import math
import os

import numpy as np
import torch

from ..core.mesh import get_device, get_n_shards
from ..core.sharded import ShardedRows, shard_rows
from ..metrics.pairwise import fp32_matmul
from .families import Family, Logistic, _no_bf16_multiclass
from .lbfgs_core import (
    HOST_SYNCS, any_active, check_line_search, lbfgs_minimize, run_line_search)
from .regularizers import L2, get_regularizer

logger = logging.getLogger(__name__)

def _prep(X, y):
    """Normalize inputs to (x, y, mask) padded tensors on X's device: x
    float32 or bfloat16, y and the mask float32.

    A tensor stays where it is.  A bfloat16 design stays bf16 (the
    reference keeps floating designs as they are, with float32
    parameters); float64 becomes float32 and integers are cast, as the
    reference's host ingest does, and float16 is widened to float32 (the
    same numbers: the reference's products promote it to float32, and K2
    reads float32 or bf16)."""
    if isinstance(X, ShardedRows):
        Xs = X
    elif isinstance(X, torch.Tensor):
        Xs = shard_rows(X)
    else:
        Xs = shard_rows(np.asarray(X, dtype=np.float32))
    x, mask = Xs.data, Xs.mask
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    x = x.contiguous()
    if isinstance(y, ShardedRows):
        yv = y.data
    elif isinstance(y, torch.Tensor):
        yv = y
    else:
        yv = torch.from_numpy(np.ascontiguousarray(np.asarray(y, dtype=np.float32)))
    yv = yv.to(device=x.device, dtype=_param_dtype(x)).reshape(-1)
    if yv.shape[0] != x.shape[0]:
        yv = torch.cat([yv, yv.new_zeros(x.shape[0] - yv.shape[0])])
    return x, yv.contiguous(), mask.to(torch.float32).contiguous()


def _param_dtype(x):
    """Accumulation/parameter dtype for a design matrix: float32, for
    float32 and bfloat16 designs alike (the reference's
    ``promote_types(x.dtype, float32)``)."""
    return torch.float32


def _pdim(x, family):
    """Parameter-vector length: features × the family's parameters per
    feature (1 for the binary logistic family)."""
    return x.shape[1] * int(getattr(family, "params_per_feature", 1))


def _init_beta(beta0, x, family):
    """Zeros (cold start) or a caller-supplied warm start, shape-checked."""
    d = _pdim(x, family)
    if beta0 is None:
        return torch.zeros(d, dtype=_param_dtype(x), device=x.device)
    if not isinstance(beta0, torch.Tensor):
        beta0 = torch.from_numpy(np.asarray(beta0, dtype=np.float32))
    b = beta0.to(device=x.device, dtype=_param_dtype(x)).reshape(-1)
    if b.shape[0] != d:
        raise ValueError(
            f"beta0 has {b.shape[0]} parameters; this solve needs {d}"
        )
    return b


#: Python-level solver dispatch counter; ``host_syncs`` reads the
#: batched loops' host syncs (``lbfgs_core.HOST_SYNCS``).
DISPATCH_COUNTS = {"solves": 0}


def reset_dispatch_counts():
    DISPATCH_COUNTS["solves"] = 0
    HOST_SYNCS["syncs"] = 0


def _shards(x, yv, mask, n_shards):
    """``(P, n/P, d)``, ``(P, n/P)``, ``(P, n/P)`` views: contiguous row
    shards, as ``shard_map`` splits the padded rows (zero rows with zero
    mask are added first where the rows do not split evenly).  A ``yv``
    of K targets ``(K, n)`` becomes ``(K, P, n/P)``."""
    P = int(n_shards)
    pad = (-x.shape[0]) % P
    if pad:
        x = torch.cat([x, x.new_zeros(pad, x.shape[1])])
        yv = torch.cat([yv, yv.new_zeros(yv.shape[:-1] + (pad,))], dim=-1)
        mask = torch.cat([mask, mask.new_zeros(pad)])
    m = x.shape[0] // P
    return x.view(P, m, x.shape[1]), yv.view(yv.shape[:-1] + (P, m)), mask.view(P, m)


def _lam_col(lam):
    """λ against a (L, D) batch: a scalar as it is, an (L,) vector as a
    column, one value a lane."""
    return lam[:, None] if lam.ndim == 1 else lam


def _make_objective(family, reg, x3, y2, m2, lamduh):
    """Total objective of each lane, ``fun(b, active, grad)`` as
    ``lbfgs_core`` takes it: the family's loss plus the penalty, λ a
    scalar tensor or one value a lane (L,)."""
    lam_g = _lam_col(lamduh)

    def obj(b, active, grad):
        if not grad:
            return family.loss(b, x3, y2, m2, active) + reg.penalty(b, lamduh)
        f, g = family.loss_and_grad(b, x3, y2, m2, active)
        return f + reg.penalty(b, lamduh), g + reg.gradient(b, lam_g)

    return obj


def line_search_strategy(requested: str = "auto") -> str:
    """Resolve a line-search choice: ``auto`` is ``backtrack``, as the
    reference resolves it off a TPU; ``probe_grid`` is not ported (ROADMAP:
    [port-admm] probe_grid)."""
    requested = "backtrack" if requested == "auto" else requested
    check_line_search(requested)
    return requested


# ---------------------------------------------------------------- lbfgs --


def _one_shard(x, yv, mask, lamduh, tol):
    """All rows as one shard for the single-lane solvers: ``x3`` (1, n, d),
    the targets (1, n) or, for L one-vs-rest problems or an L-lane sweep,
    (L, 1, n), the mask (1, n), tol as a parameter-dtype scalar and λ as
    one (a float) or one value a lane (an (L,) tensor)."""
    x3, y2, m2 = _shards(x, yv, mask, 1)
    dt, dev = _param_dtype(x), x.device
    return (x3, y2, m2, torch.as_tensor(lamduh, dtype=dt, device=dev),
            torch.tensor(tol, dtype=dt, device=dev))


def _converged(f_prev, f_new, tol):
    """The reference's relative-decrease stop; ``f_prev`` starts at inf,
    which never counts as converged."""
    return torch.isfinite(f_prev) & (
        torch.abs(f_prev - f_new) <= tol * torch.clamp(torch.abs(f_prev), min=1.0))


def _lbfgs_run(x, yv, mask, B0, lamduh, max_iter, tol, *, family, reg, line_search):
    """The reference's ``_lbfgs_run`` over all rows as one shard, for the
    lanes of ``B0`` (L, D): one problem (``yv`` (n,), L = 1) or L
    one-vs-rest problems (``yv`` (L, n)).  Returns (β (L, D), iterations
    (L,))."""
    x3, y2, m2, lam, _ = _one_shard(x, yv, mask, lamduh, tol)
    obj = _make_objective(family, reg, x3, y2, m2, lam)
    beta, st = lbfgs_minimize(obj, B0, max_iter=int(max_iter), tol=float(tol),
                              line_search=line_search)
    return beta, st.k


def _check_smooth(solver, reg, lamduh):
    if lamduh and not reg.smooth:
        raise ValueError(
            f"{solver} requires a smooth penalty; got {reg.__name__}. "
            "Use proximal_grad or admm for l1/elastic_net."
        )


def _solve_one(runner, X, y, beta0, return_n_iter, family, lamduh, max_iter, tol, **kw):
    """One problem over all rows through a single-lane runner: the public
    ``lbfgs``, ``gradient_descent``, ``proximal_grad`` and ``newton``."""
    x, yv, mask = _prep(X, y)
    DISPATCH_COUNTS["solves"] += 1
    beta, k = runner(x, yv, mask, _init_beta(beta0, x, family)[None], lamduh, max_iter, tol,
                     family=family, **kw)
    return (beta[0], int(k[0])) if return_n_iter else beta[0]


def lbfgs(X, y, *, family: type[Family] = Logistic, regularizer=L2,
          lamduh: float = 0.0, max_iter: int = 100, tol: float = 1e-5,
          beta0=None, return_n_iter: bool = False, line_search: str = "auto"):
    """Full-gradient L-BFGS on the total (smooth) objective: one lane over
    all rows.  Reference: ``dask_ml_tpu/solvers/algorithms.py :: lbfgs``."""
    line_search = line_search_strategy(line_search)
    reg = get_regularizer(regularizer)
    _check_smooth("lbfgs", reg, lamduh)
    return _solve_one(_lbfgs_run, X, y, beta0, return_n_iter, family, lamduh, max_iter, tol,
                      reg=reg, line_search=line_search)


# ---------------------------------------------------- gradient descent --


def _gd_run(x, yv, mask, B0, lamduh, max_iter, tol, *, family, reg, line_search):
    """The reference's ``_gd_run`` for the lanes of ``B0`` (L, D) over all
    rows as one shard (``yv`` as in :func:`_lbfgs_run`): per lane a step
    size, a previous f and a stop flag; a pure-Armijo search along
    −stepsize·g, the step size doubled by t after a step and halved after
    a failed search.  Returns (β (L, D), iterations (L,))."""
    x3, y2, m2, lam, tol = _one_shard(x, yv, mask, lamduh, tol)
    obj = _make_objective(family, reg, x3, y2, m2, lam)
    L, dt, dev = B0.shape[0], _param_dtype(x), x.device
    beta = B0.clone()
    stepsize = torch.ones(L, dtype=dt, device=dev)
    f_prev = torch.full((L,), math.inf, dtype=dt, device=dev)
    converged = torch.zeros(L, dtype=torch.bool, device=dev)
    k = torch.zeros(L, dtype=torch.int32, device=dev)
    while True:
        running = (k < max_iter) & ~converged
        if not any_active(running):
            break
        f, g = obj(beta, running, True)
        t, _, f_new, _ = run_line_search(line_search, obj, beta, f, g, -stepsize[:, None] * g,
                                         1e-4, 30, running, c2=None)
        beta_new = beta - (t * stepsize)[:, None] * g
        step_new = torch.where(t > 0, stepsize * t * 2.0, stepsize * 0.5)
        beta = torch.where(running[:, None], beta_new, beta)
        stepsize = torch.where(running, step_new, stepsize)
        converged = torch.where(running, _converged(f_prev, f_new, tol), converged)
        f_prev = torch.where(running, f_new, f_prev)
        k = k + running.to(torch.int32)
    return beta, k


def gradient_descent(X, y, *, family: type[Family] = Logistic, regularizer=L2,
                     lamduh: float = 0.0, max_iter: int = 100, tol: float = 1e-7,
                     beta0=None, return_n_iter: bool = False, line_search: str = "backtrack"):
    """Armijo-backtracking gradient descent on the total (smooth) objective,
    one lane over all rows.  Reference: ``dask_ml_tpu/solvers/algorithms.py
    :: gradient_descent``."""
    line_search = line_search_strategy(line_search)
    reg = get_regularizer(regularizer)
    _check_smooth("gradient_descent", reg, lamduh)
    return _solve_one(_gd_run, X, y, beta0, return_n_iter, family, lamduh, max_iter, tol,
                      reg=reg, line_search=line_search)


# ------------------------------------------------------ proximal grad --


def _pg_run(x, yv, mask, B0, lamduh, max_iter, tol, *, family, reg):
    """The reference's ``_pg_run`` for the lanes of ``B0`` (L, D):
    z = prox_{tλ}(β − t·g) with t halved (at most 30 times) while the
    smooth loss at z passes its quadratic upper bound f + gᵀΔ + ‖Δ‖²/(2t);
    the next step starts at 2t.  Lanes check their bounds in lockstep, each
    by its own predicate.  Returns (β (L, D), iterations (L,))."""
    x3, y2, m2, lam, tol = _one_shard(x, yv, mask, lamduh, tol)
    L, dt, dev = B0.shape[0], _param_dtype(x), x.device
    beta = B0.clone()
    t_next = torch.ones(L, dtype=dt, device=dev)
    f_prev = torch.full((L,), math.inf, dtype=dt, device=dev)
    converged = torch.zeros(L, dtype=torch.bool, device=dev)
    k = torch.zeros(L, dtype=torch.int32, device=dev)
    while True:
        running = (k < max_iter) & ~converged
        if not any_active(running):
            break
        f, g = family.loss_and_grad(beta, x3, y2, m2, running)
        t = t_next
        j = torch.zeros(L, dtype=torch.int32, device=dev)
        check = running
        while True:
            z = reg.prox(beta - t[:, None] * g, (t * lam)[:, None])
            diff = z - beta
            ub = f + torch.sum(g * diff, dim=1) + torch.sum(diff ** 2, dim=1) / (2 * t)
            check = check & (family.loss(z, x3, y2, m2, check) > ub) & (j < 30)
            if not any_active(check):
                break
            t = torch.where(check, 0.5 * t, t)
            j = j + check.to(torch.int32)
        beta = torch.where(running[:, None], z, beta)
        t_next = torch.where(running, t * 2.0, t_next)
        converged = torch.where(running, _converged(f_prev, f, tol), converged)
        f_prev = torch.where(running, f, f_prev)
        k = k + running.to(torch.int32)
    return beta, k


def proximal_grad(X, y, *, family: type[Family] = Logistic, regularizer=L2,
                  lamduh: float = 0.0, max_iter: int = 100, tol: float = 1e-7,
                  beta0=None, return_n_iter: bool = False):
    """Proximal gradient with backtracking on the smooth part, one lane over
    all rows: z = prox_{tλ}(β − t∇f(β)).  Reference:
    ``dask_ml_tpu/solvers/algorithms.py :: proximal_grad``."""
    return _solve_one(_pg_run, X, y, beta0, return_n_iter, family, lamduh, max_iter, tol,
                      reg=get_regularizer(regularizer))


# ------------------------------------------------------------- newton --


def _newton_run(x, yv, mask, B0, lamduh, max_iter, tol, *, family, reg, line_search):
    """The reference's ``_newton_run`` for the lanes of ``B0`` (L, D): per
    lane H = (x·w)ᵀx with w = hessian_weights(xβ)·mask, plus λI for a
    smooth penalty and always 1e-8·I, p = −H⁻¹g, then a pure-Armijo
    search.  H is a float32 PyTorch product with TF32 off (the reference's
    plain XLA gemm), over x widened to float32 once a solve where it is
    bf16, as the reference's promotion does.  Returns (β (L, D),
    iterations (L,))."""
    x3, y2, m2, lam, tol = _one_shard(x, yv, mask, lamduh, tol)
    obj = _make_objective(family, reg, x3, y2, m2, lam)
    L, dt, dev = B0.shape[0], _param_dtype(x), x.device
    xf, m1 = x3[0].to(dt), m2[0]
    eye = torch.eye(xf.shape[1], dtype=dt, device=dev)
    beta = B0.clone()
    f_prev = torch.full((L,), math.inf, dtype=dt, device=dev)
    converged = torch.zeros(L, dtype=torch.bool, device=dev)
    k = torch.zeros(L, dtype=torch.int32, device=dev)
    while True:
        running = (k < max_iter) & ~converged
        if not any_active(running):
            break
        f, g = obj(beta, running, True)
        with fp32_matmul():
            w = family.hessian_weights((xf @ beta.T).T) * m1
            H = torch.stack([(xf * w[lane, :, None]).T @ xf for lane in range(L)])
        if reg.smooth:
            H = H + (lam[:, None, None] if lam.ndim == 1 else lam) * eye
        H = H + 1e-8 * eye
        p = -torch.linalg.solve_ex(H, g)[0]
        t, _, f_new, _ = run_line_search(line_search, obj, beta, f, g, p, 1e-4, 30, running,
                                         c2=None)
        beta = torch.where(running[:, None], beta + t[:, None] * p, beta)
        converged = torch.where(running, _converged(f_prev, f_new, tol), converged)
        f_prev = torch.where(running, f_new, f_prev)
        k = k + running.to(torch.int32)
    return beta, k


def _check_newton_family(family):
    if getattr(family, "params_per_feature", 1) > 1:
        raise ValueError(
            "newton needs scalar per-sample hessian weights; the multinomial family has a "
            "KxK block hessian — use lbfgs/gradient_descent/proximal_grad/admm")


def newton(X, y, *, family: type[Family] = Logistic, regularizer=L2,
           lamduh: float = 0.0, max_iter: int = 50, tol: float = 1e-8,
           beta0=None, return_n_iter: bool = False, line_search: str = "backtrack"):
    """Damped Newton, one lane over all rows: the Hessian XᵀWX as one
    product, a (d×d) solve.  Reference: ``dask_ml_tpu/solvers/algorithms.py
    :: newton``."""
    line_search = line_search_strategy(line_search)
    reg = get_regularizer(regularizer)
    _check_smooth("newton", reg, lamduh)
    _check_newton_family(family)
    return _solve_one(_newton_run, X, y, beta0, return_n_iter, family, lamduh, max_iter, tol,
                      reg=reg, line_search=line_search)


# --------------------------------------------------------------- admm --


def _admm_run(x3, y, m2, lamduh, rho, abstol, reltol, inner_tol, max_it, z_init, *,
              family, reg, inner_iter, line_search, adaptive_rho):
    """The reference's ``_admm_run`` with the P shards as lanes, for one
    problem (``y`` (P, m)) or, under ``packed_solve``, K one-vs-rest
    problems over the same rows (``y`` (K, P, m)), or, under
    ``lambda_sweep``, K values of λ (``lamduh`` (K,)) over one target
    (``y`` a stride-0 (K, P, m) view): K·P lanes, lane ``k·P + p`` the
    problem k on shard p, with K consensus vectors, ρs, residual pairs and
    round counts.  A class whose loop has ended keeps
    its state bit for bit and its lanes drop out of every evaluation, as
    a lane of the reference's vmapped ``while_loop`` does; one flag a loop
    step is read for all classes.  ``z_init`` (K, D); returns (z (K, D),
    rounds (K,))."""
    P = x3.shape[0]
    K = y.shape[0] if y.ndim == 3 else 1
    dt = _param_dtype(x3)
    dev = x3.device
    D = z_init.shape[1]
    sqrt_d = torch.sqrt(torch.tensor(float(D), dtype=dt, device=dev))

    def per_lane(v):  # a class's value on each of its P lanes
        return torch.repeat_interleave(v, P, dim=0)

    beta_l = per_lane(z_init).clone()
    u_l = torch.zeros(K * P, D, dtype=dt, device=dev)
    z = z_init.clone()
    rho0 = torch.tensor(rho, dtype=dt, device=dev)
    rho_c = rho0.expand(K).clone()
    primal = torch.full((K,), math.inf, dtype=dt, device=dev)
    dual = primal.clone()
    eps_pri = torch.zeros(K, dtype=dt, device=dev)
    eps_dual = eps_pri.clone()
    rho_moved = torch.zeros(K, dtype=torch.bool, device=dev)
    rounds = torch.zeros(K, dtype=torch.int32, device=dev)
    while True:
        run = (rounds < max_it) & ((primal >= eps_pri) | (dual >= eps_dual) | rho_moved)
        if not any_active(run):
            break
        lanes = per_lane(run)
        z_old, u0 = z, u_l
        z_lane, rho_lane = per_lane(z_old), per_lane(rho_c)

        def local_obj(b, active, grad):
            diff = b - z_lane + u0
            pen = 0.5 * rho_lane * torch.sum(diff ** 2, dim=1)
            if not grad:
                return family.loss(b, x3, y, m2, active) + pen
            f, g = family.loss_and_grad(b, x3, y, m2, active)
            return f + pen, g + rho_lane[:, None] * diff

        b_new, _ = lbfgs_minimize(local_obj, beta_l, max_iter=inner_iter, tol=inner_tol,
                                  line_search=line_search, active=lanes)
        bk = b_new.view(K, P, D)
        b_bar = torch.sum(bk, dim=1) / P
        u_bar = torch.sum(u0.view(K, P, D), dim=1) / P
        z_new = reg.prox(b_bar + u_bar, _lam_col(lamduh) / (rho_c[:, None] * P))
        u_new = u0 + b_new - per_lane(z_new)
        # residual pieces: per-shard sums, then the sum over shards
        primal_sq = torch.sum(torch.sum((bk - z_new[:, None]) ** 2, dim=2), dim=1)
        beta_sq = torch.sum(torch.sum(bk ** 2, dim=2), dim=1)
        u_sq = torch.sum(torch.sum(u_new.view(K, P, D) ** 2, dim=2), dim=1)
        primal_new = torch.sqrt(primal_sq)
        dual_new = rho_c * torch.sqrt(P * torch.sum((z_new - z_old) ** 2, dim=1))
        eps_pri_new = sqrt_d * abstol + reltol * torch.maximum(
            torch.sqrt(beta_sq), math.sqrt(P * 1.0) * torch.linalg.vector_norm(z_new, dim=1))
        eps_dual_new = sqrt_d * abstol + reltol * rho_c * torch.sqrt(u_sq)
        rho_new, moved = rho_c, torch.zeros_like(rho_moved)
        if adaptive_rho:
            # Boyd §3.4.1 residual balancing, as the reference: rescale the
            # scaled dual on every change of rho, suppress the exit while
            # rho moves, and stop balancing once both residuals pass
            done = (primal_new < eps_pri_new) & (dual_new < eps_dual_new)
            grow = ~done & (primal_new > 10.0 * dual_new)
            shrink = ~done & (dual_new > 10.0 * primal_new)
            factor = torch.where(
                grow | shrink,
                torch.clamp(torch.sqrt(primal_new / torch.clamp(dual_new, min=1e-30)), 0.1, 10.0),
                1.0,
            )
            rho_new = torch.minimum(torch.maximum(rho_c * factor, rho0 * 1e-6), rho0 * 1e6)
            moved = rho_new != rho_c
            u_new = u_new * per_lane(rho_c / rho_new)[:, None]
        # the classes whose loop has ended keep every piece of their state
        z = torch.where(run[:, None], z_new, z)
        beta_l = torch.where(lanes[:, None], b_new, beta_l)
        u_l = torch.where(lanes[:, None], u_new, u_l)
        primal = torch.where(run, primal_new, primal)
        dual = torch.where(run, dual_new, dual)
        eps_pri = torch.where(run, eps_pri_new, eps_pri)
        eps_dual = torch.where(run, eps_dual_new, eps_dual)
        rho_c = torch.where(run, rho_new, rho_c)
        rho_moved = torch.where(run, moved, rho_moved)
        rounds = rounds + run.to(torch.int32)
    return z, rounds


def _admm_solve(x, yv, mask, Z0, P, *, lamduh, rho, abstol, reltol, inner_tol, max_iter,
                family, reg, inner_iter, line_search, adaptive_rho):
    """``_admm_run`` on the padded rows split into P shards: ``yv`` (n,)
    and ``Z0`` (1, D), or K targets (K, n) and (K, D); ``lamduh`` a float,
    or (K,) one value a problem."""
    dt = _param_dtype(x)
    x3, y2, m2 = _shards(x, yv, mask, P)

    def scalar(v):
        return torch.tensor(v, dtype=dt, device=x.device)

    return _admm_run(
        x3, y2, m2, torch.as_tensor(lamduh, dtype=dt, device=x.device), rho, scalar(abstol),
        scalar(reltol), float(inner_tol),
        int(max_iter), Z0, family=family, reg=reg, inner_iter=int(inner_iter),
        line_search=line_search, adaptive_rho=adaptive_rho)


def admm(X, y, *, family: type[Family] = Logistic, regularizer=L2,
         lamduh: float = 0.0, rho: float = 1.0, max_iter: int = 100,
         abstol: float = 1e-4, reltol: float = 1e-2,
         inner_iter: int = 50, inner_tol: float = 1e-6, n_shards=None,
         return_n_iter: bool = False, line_search: str = "backtrack",
         adaptive_rho: bool = True, beta0=None):
    """Consensus ADMM (Boyd et al. §8): per-shard local subproblems solved
    by the batched L-BFGS, one lane a shard, consensus z through the
    regularizer's prox, scaled dual updates, the Boyd residual stopping
    rule and adaptive ρ.  Reference: ``dask_ml_tpu/solvers/algorithms.py ::
    admm``, whose shard count is its mesh's data-axis size; here it is
    ``n_shards`` (default ``core.get_n_shards()``), and the answer depends
    on it as the reference's does on the mesh.
    """
    line_search = line_search_strategy(line_search)
    reg = get_regularizer(regularizer)
    x, yv, mask = _prep(X, y)
    DISPATCH_COUNTS["solves"] += 1
    P = get_n_shards() if n_shards is None else int(n_shards)
    z, rounds = _admm_solve(
        x, yv, mask, _init_beta(beta0, x, family)[None], P, lamduh=lamduh, rho=rho,
        abstol=abstol, reltol=reltol, inner_tol=inner_tol, max_iter=max_iter, family=family,
        reg=reg, inner_iter=inner_iter, line_search=line_search, adaptive_rho=adaptive_rho)
    return (z[0], int(rounds[0])) if return_n_iter else z[0]


# ------------------------------------------------------- packed (lanes) --

_PACK_ENV = "DASK_ML_TPU_TORCH_PACK"
_RUNNERS = {"lbfgs": _lbfgs_run, "gradient_descent": _gd_run, "proximal_grad": _pg_run,
            "newton": _newton_run}


def pack_strategy(n_lanes: int | None = None, device=None) -> str:
    """How one-vs-rest multi-class solves execute,
    ``DASK_ML_TPU_TORCH_PACK`` = ``packed`` | ``sequential`` | ``auto``
    (reference: ``algorithms.py :: pack_strategy``, ``DASK_ML_TPU_PACK``):

    - ``packed``: the K solves as the lanes of one batched solve, whose
      evaluations read x once for all K classes (K2-OvR).
    - ``sequential``: K whole solves, one a class.
    - ``auto`` (default): packed on CUDA, sequential on the CPU, as the
      reference packs on its accelerator and not on the CPU.  ``device``
      (default: the active device) is where the rows lie.  ``n_lanes`` is
      accepted as the reference's is; the policy does not read it.
    """
    v = os.environ.get(_PACK_ENV, "auto").strip().lower()
    if v not in ("auto", "packed", "sequential"):
        raise ValueError(f"{_PACK_ENV} must be auto|packed|sequential, got {v!r}")
    if v != "auto":
        return v
    device = torch.device(device) if device is not None else get_device()
    return "packed" if device.type == "cuda" else "sequential"


def packed_solve(solver: str, X, Y, *, family: type[Family] = Logistic,
                 regularizer=L2, lamduh: float = 0.0, max_iter: int = 100,
                 tol: float = 1e-5, rho: float = 1.0, abstol: float = 1e-4,
                 reltol: float = 1e-2, inner_iter: int = 50,
                 inner_tol: float = 1e-6, n_shards=None,
                 line_search: str | None = None, Beta0=None):
    """K independent solves over the leading axis of ``Y`` (reference:
    ``algorithms.py :: packed_solve``).  Under ``pack_strategy() ==
    "packed"`` they run as the lanes of one batched solve (K lanes for the
    single-lane solvers, K·P for ``admm``), each stopping by its own
    rules; under ``"sequential"`` as K solves.  The answers agree up to
    the order of float32 sums.

    Args:
      solver: ``admm``, ``lbfgs``, ``gradient_descent``, ``proximal_grad``
        or ``newton``.
      Y: (K, padded_rows) stacked 0/1 targets aligned with ``X``'s padded
        rows (pad rows are dead through the mask).
      Beta0: (K, D) warm starts, one row a class (default zeros).
    Returns:
      (betas (K, D) tensor, n_iters (K,) int32 numpy): each class's own
      executed-iteration count.
    """
    if solver != "admm" and solver not in _RUNNERS:
        raise ValueError(f"Unknown solver {solver!r}")
    reg = get_regularizer(regularizer)
    if solver in ("lbfgs", "gradient_descent", "newton"):
        _check_smooth(solver, reg, lamduh)
    if solver == "newton":
        _check_newton_family(family)
    x, _, mask = _prep(X, np.zeros(1, np.float32))
    _no_bf16_multiclass(x)
    Yd = Y if isinstance(Y, torch.Tensor) else torch.from_numpy(np.asarray(Y, np.float32))
    Yd = Yd.to(device=x.device, dtype=_param_dtype(x))
    if Yd.ndim != 2 or Yd.shape[1] > x.shape[0]:
        raise ValueError(f"Y must be (K, padded_rows={x.shape[0]}); got {tuple(Yd.shape)}")
    if Yd.shape[1] < x.shape[0]:
        Yd = torch.cat([Yd, Yd.new_zeros(Yd.shape[0], x.shape[0] - Yd.shape[1])], dim=1)
    Yd = Yd.contiguous()
    K = Yd.shape[0]
    strategy = pack_strategy(K, x.device)
    if strategy == "packed":
        # lanes in lockstep run one line search: backtrack, as the
        # reference forces under vmap
        if line_search not in (None, "backtrack", "auto"):
            logger.info("packed_solve forces line_search='backtrack' (requested %r)",
                        line_search)
        line_search = "backtrack"
    else:
        line_search = line_search_strategy("auto" if line_search is None else line_search)
    if Beta0 is None:
        B0 = torch.zeros(K, _pdim(x, family), dtype=_param_dtype(x), device=x.device)
    else:
        if len(Beta0) != K:
            raise ValueError(f"Beta0 must have {K} rows (one per lane); got {len(Beta0)}")
        B0 = torch.stack([_init_beta(b, x, family) for b in Beta0])
    if solver == "admm":
        P = get_n_shards() if n_shards is None else int(n_shards)

        def run(yv, b0):
            return _admm_solve(
                x, yv, mask, b0, P, lamduh=lamduh, rho=rho, abstol=abstol, reltol=reltol,
                inner_tol=inner_tol, max_iter=max_iter, family=family, reg=reg,
                inner_iter=inner_iter, line_search=line_search, adaptive_rho=True)
    else:
        runner = _RUNNERS[solver]
        # proximal_grad has its own backtracking and takes no line search
        extra = {} if solver == "proximal_grad" else {"line_search": line_search}

        def run(yv, b0):
            return runner(x, yv, mask, b0, lamduh, max_iter, tol, family=family, reg=reg,
                          **extra)

    if strategy == "packed":
        DISPATCH_COUNTS["solves"] += 1
        betas, n_its = run(Yd, B0)
    else:
        DISPATCH_COUNTS["solves"] += K
        outs = [run(Yd[c], B0[c:c + 1]) for c in range(K)]
        betas = torch.cat([b for b, _ in outs])
        n_its = torch.cat([n for _, n in outs])
    return betas, n_its.cpu().numpy().astype(np.int32)


# ------------------------------------------------------ lambda sweep --

_GRID_PACK_ENV = "DASK_ML_TPU_TORCH_GRID_PACK"


def grid_pack_strategy(device=None) -> str:
    """Whether a grid search's C-sweep runs packed (``lambda_sweep``),
    ``DASK_ML_TPU_TORCH_GRID_PACK`` = ``packed`` | ``sequential`` | ``auto``
    (reference: ``algorithms.py :: grid_pack_strategy``,
    ``DASK_ML_TPU_GRID_PACK``).  A knob of its own, apart from
    ``DASK_ML_TPU_TORCH_PACK``, as in the reference.  ``auto`` (default) is
    packed on CUDA and sequential on the CPU; ``device`` (default: the
    active device) is where the rows lie."""
    v = os.environ.get(_GRID_PACK_ENV, "auto").strip().lower()
    if v not in ("auto", "packed", "sequential"):
        raise ValueError(f"{_GRID_PACK_ENV} must be auto|packed|sequential, got {v!r}")
    if v != "auto":
        return v
    device = torch.device(device) if device is not None else get_device()
    return "packed" if device.type == "cuda" else "sequential"


def check_lambda_sweep(solver: str, lams, *, family: type[Family] = Logistic,
                       regularizer=L2) -> np.ndarray:
    """The argument checks of :func:`lambda_sweep`, which touch no data and
    launch nothing; returns ``lams`` as a float64 numpy vector.  Raises
    ``ValueError`` as the reference's ``lambda_sweep`` does: ``lams`` not
    1-D, an unknown solver, a penalty that is not smooth under ``lbfgs``,
    ``gradient_descent`` or ``newton`` (with a nonzero λ), or a
    matrix-parameter family under ``newton``."""
    reg = get_regularizer(regularizer)
    lam = np.asarray(lams, dtype=np.float64)
    if lam.ndim != 1:
        raise ValueError(f"lams must be 1-D, got shape {lam.shape}")
    if solver == "admm":
        return lam
    if solver not in _RUNNERS:
        raise ValueError(f"Unknown solver {solver!r}")
    if solver in ("lbfgs", "gradient_descent", "newton") and not reg.smooth \
            and bool(np.any(lam)):
        raise ValueError(f"{solver} requires a smooth penalty; got {reg.__name__}")
    if solver == "newton" and getattr(family, "params_per_feature", 1) > 1:
        raise ValueError("newton does not support matrix-parameter families")
    return lam


def lambda_sweep(solver: str, X, y, lams, *, family: type[Family] = Logistic,
                 regularizer=L2, max_iter: int = 100, tol: float = 1e-5,
                 rho: float = 1.0, abstol: float = 1e-4, reltol: float = 1e-2,
                 inner_iter: int = 50, inner_tol: float = 1e-6, n_shards=None,
                 line_search: str = "backtrack"):
    """L solves of the same (X, y) at the L values of ``lams`` as the lanes
    of one batched solve (reference: ``algorithms.py :: lambda_sweep``, a
    ``jax.vmap`` over λ): L lanes for ``lbfgs``, ``gradient_descent``,
    ``proximal_grad`` and ``newton``, L·P for ``admm`` (P = ``n_shards``,
    default ``core.get_n_shards()``), each lane stopping by its own rules.
    The line search is ``backtrack`` (lanes in lockstep run one), as the
    reference forces it.

    y reaches the lanes as one stride-0 view ``(L, P, m)`` of its single
    copy, padded once beforehand, never as L copies: the objective's
    evaluations are K2-OvR launches that stage one target run a tile for
    all the lanes.  Every lane starts from zeros.  The grid search calls
    this under ``grid_pack_strategy() == "packed"``; there is no sequential
    fallback here.

    Returns (betas (L, D) tensor, n_iters (L,) int32 tensor) on X's device.
    """
    reg = get_regularizer(regularizer)
    lam_np = check_lambda_sweep(solver, lams, family=family, regularizer=reg)
    if line_search != "backtrack":
        logger.info("lambda_sweep forces line_search='backtrack' (requested %r)", line_search)
    x, yv, mask = _prep(X, y)
    _no_bf16_multiclass(x)
    dt, dev = _param_dtype(x), x.device
    lam = torch.as_tensor(lam_np, dtype=dt, device=dev)
    L = lam.shape[0]
    DISPATCH_COUNTS["solves"] += 1
    P = (get_n_shards() if n_shards is None else int(n_shards)) if solver == "admm" else 1
    pad = (-x.shape[0]) % P
    if pad:  # once, before the lanes' view: _shards then concatenates nothing
        x = torch.cat([x, x.new_zeros(pad, x.shape[1])])
        yv = torch.cat([yv, yv.new_zeros(pad)])
        mask = torch.cat([mask, mask.new_zeros(pad)])
    Y = yv.expand(L, yv.shape[0])
    B0 = torch.zeros(L, _pdim(x, family), dtype=dt, device=dev)
    if solver == "admm":
        return _admm_solve(
            x, Y, mask, B0, P, lamduh=lam, rho=rho, abstol=abstol, reltol=reltol,
            inner_tol=inner_tol, max_iter=max_iter, family=family, reg=reg,
            inner_iter=inner_iter, line_search="backtrack", adaptive_rho=True)
    extra = {} if solver == "proximal_grad" else {"line_search": "backtrack"}
    return _RUNNERS[solver](x, Y, mask, B0, lam, max_iter, tol, family=family, reg=reg, **extra)
