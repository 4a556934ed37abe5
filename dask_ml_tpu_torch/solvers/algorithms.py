"""Solver algorithms: the port of ``dask_ml_tpu/solvers/algorithms.py``
(``admm`` and ``lbfgs``).

The reference runs each solve as one XLA program: ADMM's per-shard local
L-BFGS solves run inside ``shard_map``, one per device, joined by psums.
The port views the padded rows as ``(P, n/P, d)`` contiguous row shards,
as ``shard_map`` splits them (pad rows in the last), and runs the P local
solves as the lanes of one batched L-BFGS (``lbfgs_core``) whose objective
evaluations are K2 launches over all lanes at once; the psums become sums
over the lane axis.  The consensus step, the Boyd residuals and the
adaptive ρ step stay on the device as small tensors; the loop reads one
flag per round on the host (``lbfgs_core.HOST_SYNCS``).

Not ported yet (ROADMAP: [port-admm]): ``gradient_descent``,
``proximal_grad``, ``newton``, ``packed_solve``, ``lambda_sweep``, the
``*_strategy`` policies other than ``line_search_strategy``, and bf16
design matrices.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.mesh import get_n_shards
from ..core.sharded import ShardedRows, shard_rows
from .families import Family, Logistic
from .lbfgs_core import HOST_SYNCS, any_active, check_line_search, lbfgs_minimize
from .regularizers import L2, get_regularizer

def _prep(X, y):
    """Normalize inputs to (x, y, mask) padded float32 tensors on X's device.

    A tensor stays where it is; float64 becomes float32 and integers are
    cast, as the reference's host ingest does.  Half-precision design
    matrices raise: the reference keeps bf16 X with float32 parameters, a
    path the port does not have yet (ROADMAP: [port-admm] bf16 X)."""
    if isinstance(X, ShardedRows):
        Xs = X
    elif isinstance(X, torch.Tensor):
        Xs = shard_rows(X)
    else:
        Xs = shard_rows(np.asarray(X, dtype=np.float32))
    x, mask = Xs.data, Xs.mask
    if x.dtype in (torch.float16, torch.bfloat16):
        raise NotImplementedError(
            f"a {x.dtype} design matrix is not supported yet (ROADMAP: [port-admm] "
            "bf16 X); pass float32")
    if x.dtype != torch.float32:
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
    """Accumulation/parameter dtype for a design matrix: float32."""
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
    mask are added first where the rows do not split evenly)."""
    P = int(n_shards)
    pad = (-x.shape[0]) % P
    if pad:
        x = torch.cat([x, x.new_zeros(pad, x.shape[1])])
        yv = torch.cat([yv, yv.new_zeros(pad)])
        mask = torch.cat([mask, mask.new_zeros(pad)])
    m = x.shape[0] // P
    return x.view(P, m, x.shape[1]), yv.view(P, m), mask.view(P, m)


def _make_objective(family, reg, x3, y2, m2, lamduh):
    """Total objective of each lane, ``fun(b, active, grad)`` as
    ``lbfgs_core`` takes it: the family's loss plus the penalty."""

    def obj(b, active, grad):
        if not grad:
            return family.loss(b, x3, y2, m2, active) + reg.penalty(b, lamduh)
        f, g = family.loss_and_grad(b, x3, y2, m2, active)
        return f + reg.penalty(b, lamduh), g + reg.gradient(b, lamduh)

    return obj


def line_search_strategy(requested: str = "auto") -> str:
    """Resolve a line-search choice: ``auto`` is ``backtrack``, as the
    reference resolves it off a TPU; ``probe_grid`` is not ported (ROADMAP:
    [port-admm] probe_grid)."""
    requested = "backtrack" if requested == "auto" else requested
    check_line_search(requested)
    return requested


# ---------------------------------------------------------------- lbfgs --


def lbfgs(X, y, *, family: type[Family] = Logistic, regularizer=L2,
          lamduh: float = 0.0, max_iter: int = 100, tol: float = 1e-5,
          beta0=None, return_n_iter: bool = False, line_search: str = "auto"):
    """Full-gradient L-BFGS on the total (smooth) objective: one lane over
    all rows.  Reference: ``dask_ml_tpu/solvers/algorithms.py :: lbfgs``."""
    line_search = line_search_strategy(line_search)
    reg = get_regularizer(regularizer)
    if lamduh and not reg.smooth:
        raise ValueError(
            f"lbfgs requires a smooth penalty; got {reg.__name__}. "
            "Use proximal_grad or admm for l1/elastic_net."
        )
    x, yv, mask = _prep(X, y)
    DISPATCH_COUNTS["solves"] += 1
    beta0 = _init_beta(beta0, x, family)
    x3, y2, m2 = _shards(x, yv, mask, 1)
    lam = torch.tensor(lamduh, dtype=_param_dtype(x), device=x.device)
    obj = _make_objective(family, reg, x3, y2, m2, lam)
    beta, st = lbfgs_minimize(obj, beta0[None], max_iter=int(max_iter), tol=float(tol),
                              line_search=line_search)
    return (beta[0], int(st.k[0])) if return_n_iter else beta[0]


# --------------------------------------------------------------- admm --


def _admm_run(x3, y2, m2, lamduh, rho, abstol, reltol, inner_tol, max_it, z_init, *,
              family, reg, inner_iter, line_search, adaptive_rho):
    """The reference's ``_admm_run`` with the P shards as lanes: returns
    (z, rounds)."""
    P = x3.shape[0]
    dt = _param_dtype(x3)
    dev = x3.device
    d = x3.shape[2]
    sqrt_d = torch.sqrt(torch.tensor(float(d), dtype=dt, device=dev))
    beta_l = z_init[None].expand(P, d).clone()
    u_l = torch.zeros(P, d, dtype=dt, device=dev)
    z = z_init.clone()
    rho0 = torch.tensor(rho, dtype=dt, device=dev)
    rho_c = rho0.clone()
    primal = dual = torch.tensor(math.inf, dtype=dt, device=dev)
    eps_pri = eps_dual = torch.tensor(0.0, dtype=dt, device=dev)
    rho_moved = torch.tensor(False, device=dev)
    i = 0
    while i < max_it and any_active((primal >= eps_pri) | (dual >= eps_dual) | rho_moved):
        z_old, u0, rho_r = z, u_l, rho_c

        def local_obj(b, active, grad):
            diff = b - z_old + u0
            pen = 0.5 * rho_r * torch.sum(diff ** 2, dim=1)
            if not grad:
                return family.loss(b, x3, y2, m2, active) + pen
            f, g = family.loss_and_grad(b, x3, y2, m2, active)
            return f + pen, g + rho_r * diff

        b_new, _ = lbfgs_minimize(local_obj, beta_l, max_iter=inner_iter, tol=inner_tol,
                                  line_search=line_search)
        b_bar = torch.sum(b_new, dim=0) / P
        u_bar = torch.sum(u0, dim=0) / P
        z = reg.prox(b_bar + u_bar, lamduh / (rho_c * P))
        u_l = u0 + b_new - z
        beta_l = b_new
        # residual pieces: per-shard sums, then the sum over shards
        primal_sq = torch.sum(torch.sum((b_new - z) ** 2, dim=1))
        beta_sq = torch.sum(torch.sum(b_new ** 2, dim=1))
        u_sq = torch.sum(torch.sum(u_l ** 2, dim=1))
        primal = torch.sqrt(primal_sq)
        dual = rho_c * torch.sqrt(P * torch.sum((z - z_old) ** 2))
        eps_pri = sqrt_d * abstol + reltol * torch.maximum(
            torch.sqrt(beta_sq), math.sqrt(P * 1.0) * torch.linalg.vector_norm(z))
        eps_dual = sqrt_d * abstol + reltol * rho_c * torch.sqrt(u_sq)
        if adaptive_rho:
            # Boyd §3.4.1 residual balancing, as the reference: rescale the
            # scaled dual on every change of rho, suppress the exit while
            # rho moves, and stop balancing once both residuals pass
            done = (primal < eps_pri) & (dual < eps_dual)
            grow = ~done & (primal > 10.0 * dual)
            shrink = ~done & (dual > 10.0 * primal)
            factor = torch.where(
                grow | shrink,
                torch.clamp(torch.sqrt(primal / torch.clamp(dual, min=1e-30)), 0.1, 10.0),
                1.0,
            )
            rho_new = torch.minimum(torch.maximum(rho_c * factor, rho0 * 1e-6), rho0 * 1e6)
            rho_moved = rho_new != rho_c
            u_l = u_l * (rho_c / rho_new)
            rho_c = rho_new
        i += 1
    return z, i


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
    dt = _param_dtype(x)
    P = get_n_shards() if n_shards is None else int(n_shards)
    x3, y2, m2 = _shards(x, yv, mask, P)

    def scalar(v):
        return torch.tensor(v, dtype=dt, device=x.device)

    beta, n_it = _admm_run(
        x3, y2, m2, scalar(lamduh), rho, scalar(abstol), scalar(reltol), float(inner_tol),
        int(max_iter), _init_beta(beta0, x, family), family=family, reg=reg,
        inner_iter=int(inner_iter), line_search=line_search, adaptive_rho=adaptive_rho)
    return (beta, n_it) if return_n_iter else beta
