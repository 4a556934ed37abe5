"""L-BFGS batched over lanes: the port of ``dask_ml_tpu/solvers/lbfgs_core.py``.

The reference is one ``lax.while_loop`` per problem; ADMM runs one per row
shard inside ``shard_map``, each on its own device.  The port runs the P
problems as lanes of one batched loop on one device: state ``x (P, d)``,
``S/Y (P, m, d)``, ``rho (P, m)`` and per-lane ``k``, ``n_updates`` and
``converged``.  Every ``while_loop`` condition of the reference becomes a
per-lane predicate.  A lane whose condition is false keeps its state bit
for bit, and drops out of the objective's evaluations through the
``active`` flag that the objective hands to K2.  So each lane's result is
the one its own loop would give.

The objective is a callable ``fun(x, active, grad)``: for the ``active``
lanes of ``x`` (P, d) it returns ``(f (P,), g (P, d))`` when ``grad``, else
``f``; other lanes' entries are not used.

PyTorch runs eagerly, so a data-dependent exit reads one device flag on
the host per step of a batched loop (an L-BFGS iteration, a backtracking
or an expansion check) while any lane is still in it; ``HOST_SYNCS``
counts those reads.  Only the ``backtrack`` line search is ported;
``probe_grid`` raises (ROADMAP: [port-admm]).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

#: Host reads of a device flag, one per step of a batched loop.
HOST_SYNCS = {"syncs": 0}


def any_active(flags) -> bool:
    """Whether any lane is still in a loop: one host sync, counted."""
    HOST_SYNCS["syncs"] += 1
    return bool(flags.any())


class LBFGSState(NamedTuple):
    x: torch.Tensor  # (P, d)
    f: torch.Tensor  # (P,)
    g: torch.Tensor  # (P, d)
    S: torch.Tensor  # (P, m, d) s-history (circular)
    Y: torch.Tensor  # (P, m, d) y-history
    rho: torch.Tensor  # (P, m)
    k: torch.Tensor  # (P,) iterations taken
    n_updates: torch.Tensor  # (P,) history entries written
    converged: torch.Tensor  # (P,)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _two_loop(g, S, Y, rho, n_updates, m, filled):
    """Two-loop recursion over each lane's circular history → descent
    direction.  ``filled`` (a host int) bounds every lane's entries
    (n_updates ≤ iterations so far): the entries past it are invalid in
    every lane, where the reference adds zero, so they are skipped."""
    P, d = g.shape
    write_pos = n_updates % m
    ar = torch.arange(m, device=g.device)
    # newest → oldest: the newest entry is at write_pos - 1
    order = ((write_pos[:, None] - 1 - ar[None, :]) % m)[:, :filled]
    valid = ar[None, :filled] < torch.clamp(n_updates, max=m)[:, None]
    So = torch.gather(S, 1, order[:, :, None].expand(P, filled, d))
    Yo = torch.gather(Y, 1, order[:, :, None].expand(P, filled, d))
    ro = torch.gather(rho, 1, order)

    q = g
    alphas = []
    for i in range(filled):
        a = torch.where(valid[:, i], ro[:, i] * _dot(So[:, i], q), 0.0)
        q = q - a[:, None] * Yo[:, i]
        alphas.append(a)

    newest = ((write_pos - 1) % m)[:, None, None].expand(P, 1, d)
    Sn = torch.gather(S, 1, newest)[:, 0]
    Yn = torch.gather(Y, 1, newest)[:, 0]
    gamma = torch.where(n_updates > 0,
                        _dot(Sn, Yn) / torch.clamp(_dot(Yn, Yn), min=1e-12), 1.0)
    r = gamma[:, None] * q
    for ii in range(filled - 1, -1, -1):  # oldest → newest
        b = ro[:, ii] * _dot(Yo[:, ii], r)
        r = r + torch.where(valid[:, ii], alphas[ii] - b, 0.0)[:, None] * So[:, ii]
    return r


def _backtrack_wolfe(fun, x, f0, g, p, c1, c2, max_backtracks, active):
    """Weak-Wolfe search per lane: Armijo backtracking, then step expansion
    while the curvature condition gᵀ(x+tp)·p ≥ c2·gᵀp fails but Armijo
    still holds at 2t.  Lanes step in lockstep, each by its own
    predicates, as the reference's ``bt_cond``/``ex_cond`` loops do.

    ``c2=None`` is pure Armijo (``gradient_descent`` and ``newton``): no
    expansion, and no gradient is evaluated; a lane whose search failed
    gets ``t = 0`` and ``f_t = f0``, as the reference's; ``g_t`` is None.

    Returns ``(t, failed, f_t, g_t)`` with ``(f_t, g_t)`` the objective at
    ``x + t·p``: every expansion check evaluates it there (the reference's
    ``value_and_grad(x + t*p)`` in ``ex_cond``), and a lane's last check is
    at its final t, the same β the caller's ``x + t·p`` gives bit for bit.
    ``fun(x + 2t·p)``, which a check needs only where the curvature fails
    (and the expansion may go on), is evaluated only in those lanes; a
    lane that doubles its step takes it as its new f, the same β as the
    reference's recomputation in ``ex_body``.
    """
    P = x.shape[0]
    dg = _dot(g, p)
    t = torch.ones(P, dtype=f0.dtype, device=x.device)
    f_new = fun(x + p, active, False)
    j = torch.zeros(P, dtype=torch.int32, device=x.device)
    while True:
        bt = active & ~(f_new <= f0 + c1 * t * dg) & (j < max_backtracks)
        if not any_active(bt):
            break
        t = torch.where(bt, 0.5 * t, t)
        f_new = torch.where(bt, fun(x + t[:, None] * p, bt, False), f_new)
        j = j + bt.to(torch.int32)
    failed = (j >= max_backtracks) & (f_new > f0 + c1 * t * dg)
    t = torch.where(failed, 0.0, t)
    if c2 is None:
        return t, failed, torch.where(failed, f0, f_new), None

    j = torch.zeros_like(j)
    ex = active
    f_t = torch.zeros_like(f0)
    g_t = torch.zeros_like(g)
    while True:
        f_c, g_c = fun(x + t[:, None] * p, ex, True)
        f_t = torch.where(ex, f_c, f_t)
        g_t = torch.where(ex[:, None], g_c, g_t)
        curv_ok = _dot(g_c, p) >= c2 * dg
        t2 = 2.0 * t
        more = ex & ~curv_ok & (j < 8) & (t > 0)
        f2 = fun(x + t2[:, None] * p, more, False)
        ex = more & (f2 <= f0 + c1 * t2 * dg)
        t = torch.where(ex, t2, t)
        j = j + ex.to(torch.int32)
        if not any_active(ex):
            break
    return t, failed, f_t, g_t


def check_line_search(strategy):
    """Raise unless ``strategy`` is a line search the port has."""
    if strategy == "backtrack":
        return
    if strategy == "probe_grid":
        raise NotImplementedError(
            "the probe_grid line search is not ported yet "
            "(ROADMAP: [port-admm] probe_grid); use line_search='backtrack'")
    raise ValueError(
        f"line_search must be 'probe_grid' or 'backtrack'; got {strategy!r}"
    )


def run_line_search(strategy, fun, x, f0, g, p, c1, max_backtracks, active, c2=0.9):
    """Dispatch on the strategy: ``backtrack`` only (``probe_grid`` is not
    ported).  Returns ``(t, failed, f_t, g_t)``, see
    :func:`_backtrack_wolfe`; ``c2=None`` is pure Armijo, with ``g_t``
    None."""
    check_line_search(strategy)
    return _backtrack_wolfe(fun, x, f0, g, p, c1, c2, max_backtracks, active)


def lbfgs_minimize(
    fun: Callable,
    x0,
    *,
    max_iter: int = 100,
    tol: float = 1e-5,
    history: int = 10,
    c1: float = 1e-4,
    max_backtracks: int = 30,
    line_search: str = "backtrack",
    active=None,
):
    """Minimize P objectives at once, one a lane; returns (x, LBFGSState).

    ``fun(x, active, grad)`` as the module says; ``x0`` (P, d).  Per lane,
    the reference's rules: convergence at ‖g‖_∞ ≤ tol, or a relative
    objective decrease ≤ 10·eps (active only when ``tol > 0``), or a line
    search that fails; at most ``max_iter`` iterations.  ``active`` (P,)
    bool (default all): the other lanes are never evaluated, take no
    step, and come back as their ``x0`` with ``k = 0``.
    """
    check_line_search(line_search)
    m = history
    P, d = x0.shape
    dev = x0.device
    everyone = torch.ones(P, dtype=torch.bool, device=dev) if active is None else active
    f0, g0 = fun(x0, everyone, True)
    eps = torch.finfo(f0.dtype).eps
    st = LBFGSState(
        x=x0.clone(),
        f=f0,
        g=g0,
        S=torch.zeros(P, m, d, dtype=x0.dtype, device=dev),
        Y=torch.zeros(P, m, d, dtype=x0.dtype, device=dev),
        rho=torch.zeros(P, m, dtype=f0.dtype, device=dev),
        k=torch.zeros(P, dtype=torch.int32, device=dev),
        n_updates=torch.zeros(P, dtype=torch.int32, device=dev),
        converged=(torch.amax(torch.abs(g0), dim=1) <= tol) | ~everyone,
    )
    lanes = torch.arange(P, device=dev)
    steps = 0
    while True:
        running = (st.k < max_iter) & ~st.converged
        if not any_active(running):
            break
        p = -_two_loop(st.g, st.S, st.Y, st.rho, st.n_updates, m, min(steps, m))
        steps += 1
        # safeguard: if p is not a descent direction, use -g
        descent = _dot(p, st.g) < 0
        p = torch.where(descent[:, None], p, -st.g)
        t, failed, f_new, g_new = run_line_search(
            line_search, fun, st.x, st.f, st.g, p, c1, max_backtracks, running)
        x_new = st.x + t[:, None] * p
        s = x_new - st.x
        y = g_new - st.g
        sy = _dot(s, y)
        # relative curvature condition: an absolute threshold rejects the
        # small-but-informative steps taken in narrow valleys
        good = sy > 1e-10 * torch.linalg.vector_norm(s, dim=1) * torch.linalg.vector_norm(y, dim=1)
        write = running & good
        pos = st.n_updates % m
        st.S[lanes, pos] = torch.where(write[:, None], s, st.S[lanes, pos])
        st.Y[lanes, pos] = torch.where(write[:, None], y, st.Y[lanes, pos])
        st.rho[lanes, pos] = torch.where(write, 1.0 / torch.clamp(sy, min=1e-12),
                                         st.rho[lanes, pos])
        rel_dec = (st.f - f_new) / torch.clamp(
            torch.maximum(torch.abs(st.f), torch.abs(f_new)), min=1.0)
        stalled = (rel_dec <= 10.0 * eps) & (tol > 0)
        converged = (torch.amax(torch.abs(g_new), dim=1) <= tol) | failed | stalled
        st = LBFGSState(
            x=torch.where(running[:, None], x_new, st.x),
            f=torch.where(running, f_new, st.f),
            g=torch.where(running[:, None], g_new, st.g),
            S=st.S, Y=st.Y, rho=st.rho,
            k=st.k + running.to(torch.int32),
            n_updates=st.n_updates + write.to(torch.int32),
            converged=torch.where(running, converged, st.converged),
        )
    return st.x, st
