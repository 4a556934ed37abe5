"""The port's packed C-sweep (``solvers.lambda_sweep``, per-lane λ in the
solvers, ``grid_pack_strategy``) against the JAX reference's, on the CPU,
with the reference on the 8 virtual CPU devices of the tier-1 conftest and
the port at ``n_shards=8``, the same seeded numpy inputs.

Tolerances: each lane's β within 1e-4·‖β_lane‖∞ of the reference's, with
equal iteration counts.  The data are chosen clear of the stopping rules'
near-ties (ROADMAP Queue 3): lbfgs is tolerance-driven on 4003×12 seed 0;
ADMM runs at fixed work (6 rounds of 20 inner iterations); the smooth
L1 ``proximal_grad`` runs 5 iterations, since its backtracking makes the
reference's own lanes move by 2e-4·‖β‖∞ against its single solves past
that; ``newton`` and ``gradient_descent`` are tolerance-driven.  The
kernels' plain versions, which every CPU solve runs, are held bit for bit
on a stride-0 target against a materialized copy.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dask_ml_tpu import solvers as ref_solvers
from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu.linear_model.utils import add_intercept as ref_add_intercept
from dask_ml_tpu.solvers.families import Normal as RefNormal
from dask_ml_tpu_torch import solvers
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.linear_model.utils import add_intercept
from dask_ml_tpu_torch.ops import multiclass
from dask_ml_tpu_torch.solvers import algorithms

RTOL_BETA = 1e-4
LAMS = [0.01, 0.3, 3.0, 30.0]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.delenv("DASK_ML_TPU_TORCH_GRID_PACK", raising=False)
    mesh.set_device("cpu")
    mesh.set_n_shards(8)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    mesh.set_device(None)
    mesh.set_n_shards(1)
    torch.set_num_threads(threads)


def _data(family, n=4003, d=12, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d)
    if family == "logistic":
        y = (X @ w + rng.logistic(size=n) > 0).astype(np.float32)
    else:
        y = (X @ w + 0.5 * rng.normal(size=n)).astype(np.float32)
    return X, y


_FAMILIES = {"logistic": (solvers.Logistic, ref_solvers.Logistic),
             "normal": (solvers.Normal, ref_solvers.Normal)}
_CASES = {
    "lbfgs": {},
    "gradient_descent": {"max_iter": 40},
    "proximal_grad": {"regularizer": "l1", "max_iter": 5},
    "newton": {"max_iter": 10},
    "admm": {"max_iter": 6, "inner_iter": 20, "inner_tol": 0.0, "abstol": 0.0, "reltol": 0.0},
}


def _both(solver, family, kw, X, y, lams=LAMS):
    fam, ref_fam = _FAMILIES[family]
    algorithms.reset_dispatch_counts()
    ref_solvers.reset_dispatch_counts()
    rb, rn = ref_solvers.lambda_sweep(solver, ref_add_intercept(ref_shard_rows(X)),
                                      ref_shard_rows(y), lams, family=ref_fam, **kw)
    pb, pn = solvers.lambda_sweep(solver, add_intercept(shard_rows(X)), shard_rows(y), lams,
                                  family=fam, **kw)
    assert algorithms.DISPATCH_COUNTS["solves"] == ref_solvers.DISPATCH_COUNTS["solves"] == 1
    return np.asarray(rb), np.asarray(rn), pb, pn


@pytest.mark.parametrize("family", ["logistic", "normal"])
@pytest.mark.parametrize("solver", list(_CASES))
def test_lambda_sweep_matches_reference_lane_by_lane(solver, family):
    X, y = _data(family)
    rb, rn, pb, pn = _both(solver, family, _CASES[solver], X, y)
    assert pb.shape == rb.shape == (len(LAMS), X.shape[1] + 1)
    assert pb.dtype == torch.float32 and pn.dtype == torch.int32
    np.testing.assert_array_equal(pn.numpy(), rn)
    err = np.abs(pb.numpy() - rb).max(axis=1)
    assert np.all(err <= RTOL_BETA * np.abs(rb).max(axis=1)), err / np.abs(rb).max(axis=1)
    # the lanes differ: each took its own λ
    assert len({round(float(b), 4) for b in np.abs(rb).sum(axis=1)}) == len(LAMS)


@pytest.mark.parametrize("solver", ["lbfgs", "proximal_grad", "admm"])
def test_each_lane_is_the_solve_at_its_lambda(solver):
    """A sweep's lane and the single solve at its λ agree to float32
    rounding with equal iteration counts: a vector λ enters each lane as
    the scalar does."""
    X, y = _data("logistic")
    kw = dict(_CASES[solver])
    Xi = add_intercept(shard_rows(X))
    pb, pn = solvers.lambda_sweep(solver, Xi, shard_rows(y), LAMS, **kw)
    run = getattr(solvers, solver)
    for i, lam in enumerate(LAMS):
        b, k = run(Xi, shard_rows(y), lamduh=lam, return_n_iter=True, **kw)
        assert int(pn[i]) == k
        assert float((pb[i] - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_the_target_reaches_the_lanes_as_one_stride_0_view(monkeypatch):
    """The lanes' target is a stride-0 view of one padded copy, also where
    the rows do not split evenly into the shards."""
    X, y = _data("logistic", n=4001)
    seen = []
    real = multiclass.logistic_ovr_value_and_grad

    def spy(x, Y, mask, beta, active=None):
        seen.append((Y.stride(0), multiclass.shared_target(Y), tuple(Y.shape)))
        return real(x, Y, mask, beta, active)

    monkeypatch.setattr(multiclass, "logistic_ovr_value_and_grad", spy)
    solvers.lambda_sweep("admm", add_intercept(shard_rows(X, n_shards=1)), y, LAMS, max_iter=1,
                         inner_iter=2, n_shards=8)
    assert seen and all(s == (0, True, (len(LAMS), 8, 501)) for s in seen)


@pytest.mark.parametrize("family", ["logistic", "normal"])
def test_plain_k2_ovr_on_a_stride_0_target_equals_it_on_a_copy_bit_for_bit(family):
    rng = np.random.RandomState(3)
    P, m, d, K = 3, 101, 7, 5
    x = torch.from_numpy(rng.normal(size=(P, m, d)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(P, m)).astype(np.float32))
    if family == "logistic":
        y = (y > 0).float()
    mask = torch.from_numpy(rng.uniform(size=(P, m)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(K * P, d)).astype(np.float32))
    vg = getattr(multiclass, f"{family}_ovr_value_and_grad")
    v = getattr(multiclass, f"{family}_ovr_value")
    Y = y.expand(K, P, m)
    assert multiclass.shared_target(Y) and not Y.is_contiguous()
    f, g = vg(x, Y, mask, B)
    fc, gc = vg(x, Y.contiguous(), mask, B)
    assert torch.equal(f, fc) and torch.equal(g, gc)
    assert torch.equal(v(x, Y, mask, B), f)


def test_normal_ovr_plain_version_matches_reference_lane_by_lane():
    rng = np.random.RandomState(4)
    P, m, d, K = 2, 77, 6, 3
    x = rng.normal(size=(P, m, d)).astype(np.float32)
    Y = rng.normal(size=(K, P, m)).astype(np.float32)
    mask = rng.uniform(size=(P, m)).astype(np.float32)
    B = (rng.normal(size=(K * P, d)) / np.sqrt(d)).astype(np.float32)
    f, g = multiclass.normal_ovr_value_and_grad(*map(torch.from_numpy, (x, Y, mask, B)))
    vg = jax.value_and_grad(RefNormal.loss)
    for k in range(K):
        for p in range(P):
            rf, rg = vg(jnp.asarray(B[k * P + p]), jnp.asarray(x[p]), jnp.asarray(Y[k, p]),
                        jnp.asarray(mask[p]))
            np.testing.assert_allclose(f[k * P + p].item(), float(rf), rtol=1e-5)
            rg = np.asarray(rg)
            np.testing.assert_allclose(g[k * P + p].numpy(), rg, rtol=0,
                                       atol=1e-5 * np.abs(rg).max())


@pytest.mark.parametrize("solver,kw,match", [
    ("lbfgs", {"regularizer": "l1"}, "smooth penalty"),
    ("newton", {"regularizer": "elastic_net"}, "smooth penalty"),
    ("newton", {"family": "multinomial"}, "matrix-parameter"),
    ("sgd", {}, "Unknown solver"),
    ("lbfgs", {"lams": [[0.1, 1.0]]}, "1-D"),
    ("admm", {"lams": np.ones((2, 2))}, "1-D"),
])
def test_lambda_sweep_refuses_what_the_reference_refuses(solver, kw, match):
    X, y = _data("logistic", n=64)
    kw = dict(kw)
    lams = kw.pop("lams", LAMS)
    fam = kw.pop("family", None)
    port_kw, ref_kw = dict(kw), dict(kw)
    if fam == "multinomial":
        port_kw["family"], ref_kw["family"] = solvers.multinomial(3), ref_solvers.multinomial(3)
    algorithms.reset_dispatch_counts()
    ref_solvers.reset_dispatch_counts()
    with pytest.raises(ValueError, match=match):
        ref_solvers.lambda_sweep(solver, ref_shard_rows(X), ref_shard_rows(y), lams, **ref_kw)
    with pytest.raises(ValueError, match=match):
        solvers.lambda_sweep(solver, shard_rows(X), shard_rows(y), lams, **port_kw)
    assert algorithms.DISPATCH_COUNTS["solves"] == ref_solvers.DISPATCH_COUNTS["solves"] == 0
    # an all-zero λ takes a nonsmooth penalty under lbfgs, as in the reference
    if match == "smooth penalty" and solver == "lbfgs":
        b, _ = solvers.lambda_sweep(solver, shard_rows(X), shard_rows(y), [0.0, 0.0], **port_kw)
        assert tuple(b.shape) == (2, X.shape[1])


def test_packed_normal_solve_matches_reference(monkeypatch):
    """``packed_solve`` of the Normal family, K targets of their own, now
    through K2-OvR's Normal family (it raised before)."""
    monkeypatch.setenv("DASK_ML_TPU_TORCH_PACK", "packed")
    monkeypatch.setenv("DASK_ML_TPU_PACK", "packed")
    rng = np.random.RandomState(6)
    X = rng.normal(size=(1003, 6)).astype(np.float32)
    Y = (X @ rng.normal(size=(6, 3)) + 0.3 * rng.normal(size=(1003, 3))).T.astype(np.float32)
    Xi = add_intercept(shard_rows(X))
    Yp = np.zeros((3, Xi.data.shape[0]), np.float32)
    Yp[:, :1003] = Y
    rb, rn = ref_solvers.packed_solve("lbfgs", ref_add_intercept(ref_shard_rows(X)), Yp,
                                      family=ref_solvers.Normal, lamduh=0.5)
    pb, pn = solvers.packed_solve("lbfgs", Xi, Yp, family=solvers.Normal, lamduh=0.5)
    np.testing.assert_array_equal(pn, np.asarray(rn))
    rb = np.asarray(rb)
    assert np.abs(pb.numpy() - rb).max() <= RTOL_BETA * np.abs(rb).max()


def test_grid_pack_strategy_is_its_own_knob(monkeypatch):
    assert algorithms.grid_pack_strategy() == "sequential"  # the CPU
    assert algorithms.grid_pack_strategy("cuda") == "packed"
    monkeypatch.setenv("DASK_ML_TPU_TORCH_PACK", "packed")
    assert algorithms.grid_pack_strategy() == "sequential"
    monkeypatch.setenv("DASK_ML_TPU_TORCH_GRID_PACK", "packed")
    assert algorithms.grid_pack_strategy() == "packed"
    monkeypatch.setenv("DASK_ML_TPU_TORCH_GRID_PACK", "Sequential ")
    assert algorithms.grid_pack_strategy("cuda") == "sequential"
    monkeypatch.setenv("DASK_ML_TPU_TORCH_GRID_PACK", "fast")
    with pytest.raises(ValueError, match="auto|packed|sequential"):
        algorithms.grid_pack_strategy()
