"""The port's ``gradient_descent``, ``proximal_grad`` and ``newton``, its
``lbfgs`` and ``admm`` for the normal and Poisson families, its bfloat16
design path and ``packed_solve`` with the three new solvers, against the
JAX reference's, on the CPU: the reference on the 8 virtual CPU devices of
the tier-1 conftest, the port at ``n_shards=8``, the same seeded numpy
inputs (2003×6 plus the intercept, λ = 0.5).

Tolerance, as in ``test_torch_solvers.py``: ‖Δβ‖∞ ≤ 1e-4·‖β_ref‖∞ with
equal iteration counts.  The single-lane solvers stop by the reference's
relative-decrease rule, held here at ``tol=1e-4``: at their default tol
(1e-7, 1e-8) that rule compares two float32 objectives at their rounding,
and the reference's own ``n_iter_`` then moves when the rows inside each
shard are permuted.  Each case below was checked against such
permutations first: the reference moves by ≤ 1.5e-7·‖β‖∞ there, except
where a case says otherwise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dask_ml_tpu import solvers as ref_solvers
from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu.linear_model.utils import add_intercept as ref_add_intercept
from dask_ml_tpu.solvers.lbfgs_core import _backtrack_wolfe as ref_backtrack
from dask_ml_tpu_torch import solvers
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.linear_model.utils import add_intercept
from dask_ml_tpu_torch.solvers import algorithms
from dask_ml_tpu_torch.solvers.lbfgs_core import _backtrack_wolfe

RTOL_BETA = 1e-4
TOL = {"tol": 1e-4}


@pytest.fixture(autouse=True)
def _cpu():
    mesh.set_device("cpu")
    mesh.set_n_shards(8)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    mesh.set_device(None)
    mesh.set_n_shards(1)
    torch.set_num_threads(threads)


def _data(family, seed, n=2003, d=6):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    w = rng.standard_normal(d)
    if family == "Logistic":
        y = (1.0 / (1.0 + np.exp(-X @ w)) > rng.uniform(size=n)).astype(np.float32)
    elif family == "Normal":
        y = (X @ w + 0.5 + rng.standard_normal(n)).astype(np.float32)
    else:
        y = rng.poisson(np.exp(X @ (0.3 * w))).astype(np.float32)
    return X, y


def _pair(family, solver, seed, bf16=False, **kw):
    """(ref β, ref n_iter, port β, port n_iter) of one solve at λ = 0.5."""
    X, y = _data(family, seed)
    kw = dict(lamduh=0.5, return_n_iter=True, **kw)
    rX = ref_shard_rows(X, dtype=jnp.bfloat16) if bf16 else ref_shard_rows(X)
    pX = shard_rows(X, dtype=torch.bfloat16) if bf16 else shard_rows(X)
    rb, rn = getattr(ref_solvers, solver)(ref_add_intercept(rX), y,
                                          family=getattr(ref_solvers, family), **kw)
    pb, pn = getattr(solvers, solver)(add_intercept(pX), y, family=getattr(solvers, family), **kw)
    return np.asarray(rb), int(rn), pb, pn


def _hold(rb, rn, pb, pn):
    assert pb.dtype == torch.float32
    assert pn == rn
    assert float(np.abs(pb.numpy() - rb).max()) <= RTOL_BETA * float(np.abs(rb).max())


# --------------------------------------------------------- pure Armijo

def test_pure_armijo_lanes_match_reference_line_search():
    # f(x) = Σ exp(a·x) − b·x along p; per lane: the unit step (0),
    # backtracking (1, 2), an uphill search that fails (3: t = 0 and f_t =
    # f0) and an inactive lane (4).  No gradient is evaluated.
    a = np.array([0.5, 2.0, 30.0, 1.0, 0.3], np.float32)
    b = np.array([0.5, 3.0, 30.75, 1.0, 1.0], np.float32)
    x0 = np.array([-4.0, 0.0, 0.0, -4.0, -4.0], np.float32)
    d, max_backtracks = 3, 10
    x = np.repeat(x0[:, None], d, axis=1)
    p = np.ones((5, d), np.float32)
    p[3] = -1.0
    active = np.array([True, True, True, True, False])
    ref = []
    for lane in range(4):
        ai, bi = a[lane], b[lane]
        vg = jax.value_and_grad(lambda z: jnp.sum(jnp.exp(ai * z) - bi * z))  # noqa: B023
        f0, g0 = vg(jnp.asarray(x[lane]))
        t, f_new, g_new, failed = ref_backtrack(vg, jnp.asarray(x[lane]), f0, g0,
                                                jnp.asarray(p[lane]), 1e-4, None, max_backtracks)
        assert g_new is None
        ref.append((float(t), float(f_new), bool(failed)))
    at, bt = torch.from_numpy(a)[:, None], torch.from_numpy(b)[:, None]
    seen = []

    def fun(z, act, grad):
        if act is not None:
            seen.append((act.clone(), grad))
        f = torch.sum(torch.exp(at * z) - bt * z, dim=1)
        return (f, at * torch.exp(at * z) - bt) if grad else f

    xt, pt = torch.from_numpy(x), torch.from_numpy(p)
    f0, g0 = fun(xt, None, True)
    t, failed, f_t, g_t = _backtrack_wolfe(fun, xt, f0, g0, pt, 1e-4, None, max_backtracks,
                                           torch.from_numpy(active))
    assert g_t is None and not any(grad for _, grad in seen)
    assert not any(bool(act[4]) for act, _ in seen)
    assert [r[0] for r in ref] == [1.0, 0.25, 2.0 ** -10, 0.0]
    for lane in range(4):
        assert (t[lane].item(), bool(failed[lane])) == (ref[lane][0], ref[lane][2]), lane
        np.testing.assert_allclose(f_t[lane].item(), ref[lane][1], rtol=1e-6)
    assert f_t[3].item() == f0[3].item()  # the failed search keeps f0


# ---------------------------------------------------- single-lane solvers

SINGLE = [
    # (family, solver, regularizer, extra, seed)
    ("Logistic", "gradient_descent", "l2", TOL, 0),
    ("Logistic", "proximal_grad", "l1", TOL, 0),
    ("Logistic", "proximal_grad", "l2", TOL, 1),
    ("Logistic", "proximal_grad", "elastic_net", TOL, 0),
    ("Logistic", "newton", "l2", TOL, 0),
    ("Normal", "gradient_descent", "l2", TOL, 0),
    ("Normal", "newton", "l2", TOL, 1),
    ("Poisson", "gradient_descent", "l2", TOL, 0),
    ("Poisson", "proximal_grad", "l1", TOL, 0),
    ("Poisson", "proximal_grad", "l2", TOL, 1),
    ("Poisson", "proximal_grad", "elastic_net", TOL, 0),
    ("Poisson", "newton", "l2", TOL, 0),
    # normal proximal_grad at 4 iterations: at its fifth the step-size test
    # f(z) > f + gᵀΔ + ‖Δ‖²/(2t) compares numbers that differ by less than
    # f's float32 rounding (the loss is quadratic, Δ ~ 1e-5), and the
    # reference's own β moves by 7.3e-5·‖β‖∞ under a within-shard
    # permutation there; through four iterations the two agree to 1e-7
    ("Normal", "proximal_grad", "l1", dict(TOL, max_iter=4), 0),
    ("Normal", "proximal_grad", "l2", dict(TOL, max_iter=4), 2),
    ("Normal", "proximal_grad", "elastic_net", dict(TOL, max_iter=4), 0),
]


@pytest.mark.parametrize("family,solver,reg,extra,seed", SINGLE,
                         ids=[f"{f}-{s}-{r}" for f, s, r, _, _ in SINGLE])
def test_single_lane_solvers_match_reference(family, solver, reg, extra, seed):
    _hold(*_pair(family, solver, seed, regularizer=reg, **extra))


OTHER_FAMILIES = [
    ("Normal", "lbfgs", {}, 1),
    ("Poisson", "lbfgs", {}, 2),
    # ADMM with its inner solves at fixed work, as test_torch_solvers.py
    ("Normal", "admm", dict(inner_tol=0.0, inner_iter=30), 0),
    # Poisson ADMM at fixed work: the exp makes the local solves' noise
    # floor coarser; the reference moves by 1.8e-5·‖β‖∞ under a permutation
    ("Poisson", "admm", dict(inner_tol=0.0, inner_iter=10, abstol=0.0, reltol=0.0, max_iter=5),
     0),
]


@pytest.mark.parametrize("family,solver,extra,seed", OTHER_FAMILIES,
                         ids=[f"{f}-{s}" for f, s, _, _ in OTHER_FAMILIES])
def test_lbfgs_and_admm_match_reference_for_other_families(family, solver, extra, seed):
    _hold(*_pair(family, solver, seed, **extra))


BF16 = [
    ("Logistic", "lbfgs", {}, 0),
    ("Logistic", "admm", dict(inner_tol=0.0, inner_iter=30), 0),
    ("Logistic", "gradient_descent", TOL, 1),
    ("Normal", "lbfgs", {}, 1),
    ("Poisson", "gradient_descent", TOL, 0),
]


@pytest.mark.parametrize("family,solver,extra,seed", BF16,
                         ids=[f"{f}-{s}" for f, s, _, _ in BF16])
def test_bf16_design_matches_reference(family, solver, extra, seed):
    # the reference's shard_rows(X, dtype=bfloat16): bf16 X, float32 β
    _hold(*_pair(family, solver, seed, bf16=True, **extra))


def test_single_lane_solvers_take_one_gradient_an_iteration(monkeypatch):
    # gradient_descent and newton search by pure Armijo, proximal_grad by
    # its own bound: none evaluates a gradient in its line search
    X, y = _data("Logistic", 0)
    Xi = add_intercept(shard_rows(X))
    grads = []
    real = solvers.Logistic.loss_and_grad

    def counted(*args, **kwargs):
        grads.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(solvers.Logistic, "loss_and_grad", staticmethod(counted))
    for solver in ("gradient_descent", "proximal_grad", "newton"):
        grads.clear()
        _, n_it = getattr(solvers, solver)(Xi, y, lamduh=0.5, tol=1e-4, return_n_iter=True)
        assert len(grads) == n_it > 1, solver


def test_new_solvers_refuse_what_the_reference_refuses():
    X, y = _data("Logistic", 3)
    Xi = add_intercept(shard_rows(X[:64]))
    for solver in ("gradient_descent", "newton"):
        with pytest.raises(ValueError, match="smooth penalty"):
            getattr(solvers, solver)(Xi, y[:64], regularizer="l1", lamduh=1.0)
    with pytest.raises(ValueError, match="hessian"):
        solvers.newton(Xi, np.zeros(64, np.float32), family=solvers.multinomial(3))
    with pytest.raises(NotImplementedError, match="probe_grid"):
        solvers.gradient_descent(Xi, y[:64], line_search="probe_grid")
    # pure L1 proximal gradient with λ = 0 is plain gradient steps with
    # the step-size test: it runs
    beta, n_it = solvers.proximal_grad(Xi, y[:64], regularizer="l1", return_n_iter=True)
    assert bool(torch.isfinite(beta).all()) and n_it >= 1


# ------------------------------------------------------------- packed

def _ovr_data(seed, n=2003, d=6, K=3):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = rng.standard_normal((K, d)).astype(np.float32)
    eta = X @ W.T
    Y = (1.0 / (1.0 + np.exp(-eta)) > rng.uniform(size=eta.shape)).astype(np.float32).T
    return X, Y


@pytest.mark.parametrize("solver,kw", [
    ("gradient_descent", dict(lamduh=0.5, tol=1e-4)),
    ("proximal_grad", dict(lamduh=0.5, tol=1e-4, regularizer="l1")),
    ("newton", dict(lamduh=0.5, tol=1e-4)),
])
def test_packed_solve_new_solvers_match_reference(monkeypatch, solver, kw):
    # the reference's vmapped lanes against the port's K lanes on K2-OvR;
    # each class stops by its own rule (seed 0: 15, 7, 7 iterations of
    # gradient descent)
    monkeypatch.setenv("DASK_ML_TPU_PACK", "packed")
    monkeypatch.setenv("DASK_ML_TPU_TORCH_PACK", "packed")
    X, Y = _ovr_data(0)
    Xr = ref_add_intercept(ref_shard_rows(X))
    rb, rn = ref_solvers.packed_solve(
        solver, Xr, np.pad(Y, ((0, 0), (0, Xr.data.shape[0] - Y.shape[1]))), **kw)
    algorithms.reset_dispatch_counts()
    pb, pn = solvers.packed_solve(solver, add_intercept(shard_rows(X)), Y, **kw)
    assert algorithms.DISPATCH_COUNTS["solves"] == 1
    np.testing.assert_array_equal(pn, np.asarray(rn))
    assert len(set(pn.tolist())) > 1
    rb = np.asarray(rb)
    assert float(np.abs(pb.numpy() - rb).max()) <= RTOL_BETA * float(np.abs(rb).max())


def test_packed_solve_refuses_what_it_does_not_take(monkeypatch):
    monkeypatch.setenv("DASK_ML_TPU_TORCH_PACK", "packed")
    X, Y = _ovr_data(4, n=64)
    with pytest.raises(ValueError, match="smooth penalty"):
        solvers.packed_solve("newton", X, Y, regularizer="elastic_net", lamduh=1.0)
    with pytest.raises(ValueError, match="hessian"):
        solvers.packed_solve("newton", X, Y, family=solvers.multinomial(3))
    with pytest.raises(NotImplementedError, match="bf16 multi-class"):
        solvers.packed_solve("gradient_descent", torch.from_numpy(X).bfloat16(), Y)
    with pytest.raises(NotImplementedError, match="packed Poisson"):
        solvers.packed_solve("lbfgs", X, Y, family=solvers.Poisson)


def test_pack_strategy_defaults_to_the_active_device(monkeypatch):
    # without a device argument the policy reads the active device
    monkeypatch.delenv("DASK_ML_TPU_TORCH_PACK", raising=False)
    assert algorithms.pack_strategy() == "sequential"
    assert algorithms.pack_strategy(4) == "sequential"
