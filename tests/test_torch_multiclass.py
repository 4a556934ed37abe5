"""The port's multi-class pieces against the JAX reference's, on the CPU:
the plain versions of K2-OvR and K2-MN (``ops/multiclass.py``) against
``jax.value_and_grad`` of the reference losses, and ``packed_solve``
against the reference's, with the reference on the 8 virtual CPU devices
of the tier-1 conftest and the port at ``n_shards=8``, the same seeded
numpy inputs.

Tolerances: the plain versions match to rtol 1e-5 on f and 1e-5·max|g|
on g (float32 sums in another order), as K2's do.  Solves match to
‖Δβ‖∞ ≤ 1e-4·‖β_ref‖∞ with equal iteration counts for each class.  The
targets are learnable (bench.py's packed A/B draws them from hyperplanes
of X, here through a logistic link).  Tolerance-driven ADMM is not held
here: with the default inner tolerance the reference's own β moves by
2.5e-4·‖β‖∞ at 2003×6, seed 0, when the rows inside each shard are
permuted (ROADMAP Queue 3), so ADMM runs at fixed work (6 rounds of 30
inner iterations), where that spread is 3e-5 and the port sits within
3e-6 to 6e-6.  ``lbfgs`` is held both tolerance-driven (seed 1: the
reference moves by 6e-8 under permutation) and at fixed work.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu.linear_model.utils import add_intercept as ref_add_intercept
from dask_ml_tpu.solvers import packed_solve as ref_packed_solve
from dask_ml_tpu.solvers.families import Logistic as RefLogistic
from dask_ml_tpu.solvers.families import multinomial as ref_multinomial
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.linear_model.utils import add_intercept
from dask_ml_tpu_torch.ops import multiclass
from dask_ml_tpu_torch.solvers import DISPATCH_COUNTS, Logistic, lbfgs_minimize, packed_solve
from dask_ml_tpu_torch.solvers import algorithms

RTOL_BETA = 1e-4


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


def _masked(rng, P, m):
    mask = rng.uniform(size=(P, m)).astype(np.float32)
    mask[rng.uniform(size=(P, m)) < 0.1] = 0.0
    return mask


# ------------------------------------------------------------------ K2-OvR

@pytest.mark.parametrize("P,m,d,K", [
    (1, 1001, 3, 2), (8, 137, 13, 4), (3, 77, 1, 3), (2, 50, 130, 16),
    # the kernel's staging edges: m = 1, 2, 3 mod 4 with P > 1, K = 1, 5, 16
    (3, 101, 29, 4), (2, 102, 28, 16), (4, 103, 29, 5), (2, 37, 29, 1), (2, 60, 29, 16)])
def test_ovr_plain_version_matches_reference_class_by_class(P, m, d, K):
    rng = np.random.RandomState(P * m + d + K)
    x = rng.standard_normal((P, m, d)).astype(np.float32)
    B = (rng.standard_normal((K * P, d)) / np.sqrt(d)).astype(np.float32)
    Y = (rng.uniform(size=(K, P, m)) < 0.4).astype(np.float32)
    mask = _masked(rng, P, m)
    t = [torch.from_numpy(a) for a in (x, Y, mask, B)]
    f, g = multiclass.logistic_ovr_value_and_grad(*t)
    fv = multiclass.logistic_ovr_value(*t)
    vg = jax.value_and_grad(RefLogistic.loss)
    for k in range(K):
        for p in range(P):
            lane = k * P + p
            rf, rg = vg(jnp.asarray(B[lane]), jnp.asarray(x[p]), jnp.asarray(Y[k, p]),
                        jnp.asarray(mask[p]))
            np.testing.assert_allclose(f[lane].item(), float(rf), rtol=1e-5)
            np.testing.assert_allclose(fv[lane].item(), float(rf), rtol=1e-5)
            rg = np.asarray(rg)
            np.testing.assert_allclose(g[lane].numpy(), rg, rtol=0,
                                       atol=1e-5 * np.abs(rg).max())


def test_ovr_inactive_lanes_are_zero_and_the_active_ones_unchanged():
    rng = np.random.RandomState(0)
    P, m, d, K = 3, 40, 5, 3
    t = [torch.from_numpy(a) for a in (
        rng.standard_normal((P, m, d)).astype(np.float32),
        (rng.uniform(size=(K, P, m)) < 0.5).astype(np.float32), _masked(rng, P, m),
        rng.standard_normal((K * P, d)).astype(np.float32))]
    active = torch.arange(K * P) % 4 != 1
    before = multiclass.logistic_ovr_value_and_grad_ref.calls
    f, g = multiclass.logistic_ovr_value_and_grad(*t, active)
    assert multiclass.logistic_ovr_value_and_grad_ref.calls == before + 1
    assert not bool(f[~active].any()) and not bool(g[~active].any())
    full_f, full_g = multiclass.logistic_ovr_value_and_grad(*t)
    assert torch.equal(f[active], full_f[active]) and torch.equal(g[active], full_g[active])
    with pytest.raises(ValueError, match="shapes disagree"):
        multiclass.logistic_ovr_value(t[0], t[1], t[2], t[3][:P].contiguous())
    with pytest.raises(TypeError, match="float32"):
        multiclass.logistic_ovr_value(t[0].double(), *t[1:])


# ------------------------------------------------------------------- K2-MN

@pytest.mark.parametrize("P,m,d,K", [(1, 1001, 3, 3), (8, 137, 13, 4), (3, 77, 1, 2),
                                     (2, 50, 30, 16),
                                     # the widths of the kernel's tensor-core path: one
                                     # n-tile of 8 classes, one class past it, two n-tiles
                                     (2, 77, 28, 8), (2, 77, 29, 8), (2, 77, 28, 9),
                                     (2, 77, 29, 9), (2, 77, 28, 16), (2, 77, 29, 16)])
def test_multinomial_plain_version_matches_reference(P, m, d, K):
    rng = np.random.RandomState(P * m + d + K)
    x = rng.standard_normal((P, m, d)).astype(np.float32)
    B = (rng.standard_normal((P, d * K)) / np.sqrt(d)).astype(np.float32)
    y = rng.randint(0, K, size=(P, m)).astype(np.float32)
    mask = _masked(rng, P, m)
    t = [torch.from_numpy(a) for a in (x, y, mask, B)]
    f, g = multiclass.multinomial_value_and_grad(*t)
    fv = multiclass.multinomial_value(*t)
    vg = jax.value_and_grad(ref_multinomial(K).loss)
    for p in range(P):
        rf, rg = vg(jnp.asarray(B[p]), jnp.asarray(x[p]), jnp.asarray(y[p]),
                    jnp.asarray(mask[p]))
        np.testing.assert_allclose(f[p].item(), float(rf), rtol=1e-5)
        np.testing.assert_allclose(fv[p].item(), float(rf), rtol=1e-5)
        rg = np.asarray(rg)
        np.testing.assert_allclose(g[p].numpy(), rg, rtol=0, atol=1e-5 * np.abs(rg).max())


def test_multinomial_inactive_lanes_and_out_of_range_labels():
    rng = np.random.RandomState(1)
    P, m, d, K = 3, 30, 4, 3
    x = rng.standard_normal((P, m, d)).astype(np.float32)
    B = rng.standard_normal((P, d * K)).astype(np.float32)
    y = rng.randint(0, K, size=(P, m)).astype(np.float32)
    y[0, :3] = [-1.0, K, K - 0.5]  # no class, no class, truncated to K - 1
    mask = _masked(rng, P, m)
    t = [torch.from_numpy(a) for a in (x, y, mask, B)]
    active = torch.tensor([True, False, True])
    f, g = multiclass.multinomial_value_and_grad(*t, active)
    assert f[1].item() == 0.0 and not bool(g[1].any())
    rf, rg = jax.value_and_grad(ref_multinomial(K).loss)(
        jnp.asarray(B[0]), jnp.asarray(x[0]), jnp.asarray(y[0]), jnp.asarray(mask[0]))
    np.testing.assert_allclose(f[0].item(), float(rf), rtol=1e-5)
    np.testing.assert_allclose(g[0].numpy(), np.asarray(rg), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(rg)).max())
    with pytest.raises(ValueError, match="beta must be"):
        multiclass.multinomial_value(t[0], t[1], t[2], t[3][:, :-1].contiguous())


# ------------------------------------------------------------ packed_solve

def _ovr_data(seed, n=2003, d=6, K=3):
    rng = np.random.RandomState(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    W = rng.standard_normal((K, d)).astype(np.float32)
    eta = X @ W.T
    Y = (1.0 / (1.0 + np.exp(-eta)) > rng.uniform(size=eta.shape)).astype(np.float32).T
    return X, Y


FIXED_ADMM = dict(lamduh=0.5, abstol=0.0, reltol=0.0, inner_tol=0.0, inner_iter=30, max_iter=6)


def _close(port, ref):
    port, ref = port.numpy(), np.asarray(ref)
    return float(np.abs(port - ref).max()) <= RTOL_BETA * float(np.abs(ref).max())


@pytest.mark.parametrize("solver,kw,seed", [
    ("lbfgs", dict(lamduh=0.5), 1),
    ("lbfgs", dict(lamduh=1.0, max_iter=20, tol=0.0), 0),
    ("admm", FIXED_ADMM, 0),
], ids=["lbfgs-tol", "lbfgs-fixed", "admm-fixed"])
def test_packed_solve_matches_reference(monkeypatch, solver, kw, seed):
    monkeypatch.setenv("DASK_ML_TPU_PACK", "packed")
    monkeypatch.setenv("DASK_ML_TPU_TORCH_PACK", "packed")
    X, Y = _ovr_data(seed)
    Xr = ref_add_intercept(ref_shard_rows(X))
    rb, rn = ref_packed_solve(solver, Xr, np.pad(Y, ((0, 0), (0, Xr.data.shape[0] - Y.shape[1]))),
                              **kw)
    algorithms.reset_dispatch_counts()
    pb, pn = packed_solve(solver, add_intercept(shard_rows(X)), Y, **kw)
    assert DISPATCH_COUNTS["solves"] == 1
    np.testing.assert_array_equal(pn, np.asarray(rn))
    assert _close(pb, rb)


@pytest.mark.parametrize("solver,kw", [("lbfgs", dict(lamduh=0.5)), ("admm", FIXED_ADMM)])
def test_packed_matches_sequential(monkeypatch, solver, kw):
    X, Y = _ovr_data(2)
    Xi = add_intercept(shard_rows(X))
    beta0 = np.linspace(-0.3, 0.3, 3 * 7).reshape(3, 7).astype(np.float32)
    out = {}
    for strategy in ("packed", "sequential"):
        monkeypatch.setenv("DASK_ML_TPU_TORCH_PACK", strategy)
        algorithms.reset_dispatch_counts()
        out[strategy] = packed_solve(solver, Xi, torch.from_numpy(Y), Beta0=beta0, **kw)
        assert DISPATCH_COUNTS["solves"] == (1 if strategy == "packed" else 3)
    np.testing.assert_array_equal(out["packed"][1], out["sequential"][1])
    assert _close(out["packed"][0], out["sequential"][0].numpy())
    # the warm start matters: a cold packed solve lands elsewhere after its rounds
    monkeypatch.setenv("DASK_ML_TPU_TORCH_PACK", "packed")
    cold = packed_solve(solver, Xi, Y, **dict(kw, max_iter=1))[0]
    warm = packed_solve(solver, Xi, Y, Beta0=beta0, **dict(kw, max_iter=1))[0]
    assert not torch.equal(cold, warm)


def test_a_class_that_stops_keeps_its_state(monkeypatch):
    # tolerance-driven: class 1 stops after 11 rounds, class 0 after 15;
    # class 1's β must be what a solve of that class alone gives, bit for bit
    monkeypatch.setenv("DASK_ML_TPU_TORCH_PACK", "packed")
    X, Y = _ovr_data(3, n=1001)
    Xi = add_intercept(shard_rows(X))
    betas, n_it = packed_solve("admm", Xi, Y, lamduh=1.0, inner_iter=20)
    assert n_it[1] < n_it[0]
    alone, n1 = packed_solve("admm", Xi, Y[1:2], lamduh=1.0, inner_iter=20)
    assert int(n1[0]) == int(n_it[1])
    assert torch.equal(alone[0], betas[1])


def test_pack_strategy_and_unported_solvers(monkeypatch):
    monkeypatch.delenv("DASK_ML_TPU_TORCH_PACK", raising=False)
    assert algorithms.pack_strategy(4, "cpu") == "sequential"
    assert algorithms.pack_strategy(4, "cuda") == "packed"
    monkeypatch.setenv("DASK_ML_TPU_TORCH_PACK", "packed")
    assert algorithms.pack_strategy(4, "cpu") == "packed"
    monkeypatch.setenv("DASK_ML_TPU_TORCH_PACK", "fast")
    with pytest.raises(ValueError, match="DASK_ML_TPU_TORCH_PACK"):
        algorithms.pack_strategy()
    monkeypatch.delenv("DASK_ML_TPU_TORCH_PACK")
    X, Y = _ovr_data(4, n=64)
    with pytest.raises(ValueError, match="smooth penalty"):
        packed_solve("lbfgs", X, Y, regularizer="l1", lamduh=1.0)
    with pytest.raises(ValueError, match="Beta0"):
        packed_solve("lbfgs", X, Y, Beta0=np.zeros((2, 6), np.float32))
    with pytest.raises(ValueError, match="Unknown solver"):
        packed_solve("sgd", X, Y)


def test_lbfgs_minimize_leaves_inactive_lanes_alone():
    # the lanes of a class whose ADMM loop has ended: never evaluated, no
    # step, back as their start point with k = 0
    rng = np.random.RandomState(5)
    P, m, d = 4, 60, 3
    t = [torch.from_numpy(a) for a in (
        rng.standard_normal((P, m, d)).astype(np.float32),
        (rng.uniform(size=(P, m)) < 0.5).astype(np.float32), np.ones((P, m), np.float32))]
    seen = []

    def fun(b, act, grad):  # a penalty on every lane, as ADMM's local objective has
        seen.append(act.clone())
        pen = 0.5 * torch.sum(b ** 2, dim=1)
        if not grad:
            return Logistic.loss(b, *t, act) + pen
        f, g = Logistic.loss_and_grad(b, *t, act)
        return f + pen, g + b

    x0 = torch.from_numpy(rng.standard_normal((P, d)).astype(np.float32))
    active = torch.tensor([True, False, True, False])
    x, st = lbfgs_minimize(fun, x0, max_iter=10, tol=1e-6, active=active)
    assert not any(bool((a & ~active).any()) for a in seen)
    assert torch.equal(x[~active], x0[~active]) and not bool(st.k[~active].any())
    both, _ = lbfgs_minimize(fun, x0, max_iter=10, tol=1e-6)
    assert torch.equal(x[active], both[active])


# --------------------------------------------- K2-MN's 3-pass TF32 products

TOL = 1e-5  # the card tests' tolerance: 1e-5 of each element's Σ|terms|


def _tf32(a):
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: the mantissa
    to 10 bits, to nearest with ties away from zero."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _truncated(a):
    """float32 as the tensor cores read a TF32 operand: the low 13 bits
    dropped."""
    return (a.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tensor_core_product(a, b, passes):
    """a @ b of float32 operands as K2-MN's tensor cores take it: each
    operand split into hi = TF32(v) and lo = v - hi (read truncated), the
    products exact (float64 here); 3 passes sum lo·hi + hi·lo + hi·hi, 1
    pass hi·hi alone."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah.double() @ bh.double()
    if passes == 3:
        al, bl = _truncated(a - ah), _truncated(b - bh)
        out = out + al.double() @ bh.double() + ah.double() @ bl.double()
    return out


def _multinomial_by_tensor_cores(x, y, mask, beta, passes):
    """η, f and g of one shard with both class products (η = x·B and
    g = xᵀ·W, W the float32 weights) taken as the kernel takes them."""
    d = x.shape[1]
    K = beta.shape[0] // d
    eta = _tensor_core_product(x, beta.view(d, K), passes)
    onehot = torch.nn.functional.one_hot(y.long(), K).double()
    m = mask.double()
    f = torch.sum(m * (torch.logsumexp(eta, 1) - torch.sum(eta * onehot, 1)))
    w = (m[:, None] * (torch.softmax(eta, 1) - onehot)).float()
    return eta, f, _tensor_core_product(x.T.contiguous(), w, passes).reshape(-1)


@pytest.mark.parametrize("d,K", [(29, 4), (28, 16)])
def test_multinomial_three_pass_split_holds_the_tolerance(d, K):
    """The kernel's hi/lo split of both class products holds η, f and g to
    TOL of their Σ|terms| against float64, at phase 7's magnitudes (x and
    the softmax stand-in's W standard normal, the intercept column at
    d = 29), where a single TF32 pass (about 11 bits) misses that bound."""
    rng = np.random.RandomState(d * K)
    m = 256
    x = rng.standard_normal((m, d)).astype(np.float32)
    if d == 29:
        x[:, -1] = 1.0
    beta = rng.standard_normal(d * K).astype(np.float32)
    y = rng.randint(0, K, size=m).astype(np.float32)
    mask = _masked(rng, 1, m)[0]
    x, y, mask, beta = (torch.from_numpy(a) for a in (x, y, mask, beta))
    xd, md = x.double(), mask.double()
    eta = xd @ beta.double().view(d, K)
    eta_mag = xd.abs() @ beta.double().abs().view(d, K)
    rf, rg = multiclass.multinomial_value_and_grad_ref(xd[None], y[None].double(), md[None],
                                                       beta.double()[None])
    onehot = torch.nn.functional.one_hot(y.long(), K).double()
    f_mag = torch.sum(md * (torch.logsumexp(eta, 1).abs() + torch.sum(eta * onehot, 1).abs()))
    w = md[:, None] * (torch.softmax(eta, 1) - onehot)
    g_mag = (xd.abs().T @ w.abs()).reshape(-1)

    def worst(passes):
        e, f, g = _multinomial_by_tensor_cores(x, y, mask, beta, passes)
        return (float(((e - eta).abs() / eta_mag).max()), float((f - rf[0]).abs() / f_mag),
                float(((g - rg[0]).abs() / g_mag).max()))

    three, one = worst(3), worst(1)
    assert max(three) <= TOL, three
    assert one[0] > TOL and one[2] > TOL, one



def _ovr_by_tensor_cores(family, x, y, mask, B, passes):
    """η (m, L), f (L,) and g (L, d) of one shard over one shared target y,
    with both lane products (η = x·Bᵀ and g = Wᵀ·x, W the float32 weights)
    taken as K2-OvR's shared-target path takes them."""
    eta = _tensor_core_product(x, B.T.contiguous(), passes)
    yd, md = y.double()[:, None], mask.double()[:, None]
    if family == "logistic":
        f = torch.sum(md * (torch.logaddexp(torch.zeros_like(eta), eta) - yd * eta), 0)
        w = md * (torch.sigmoid(eta) - yd)
    else:
        f = torch.sum(md * 0.5 * (yd - eta) ** 2, 0)
        w = md * (eta - yd)
    return eta, f, _tensor_core_product(x.T.contiguous(), w.float(), passes).T


@pytest.mark.parametrize("family", ["logistic", "normal"])
@pytest.mark.parametrize("d,L", [(29, 8), (29, 5), (32, 16)])
def test_ovr_shared_three_pass_split_holds_the_tolerance(family, d, L):
    """K2-OvR's shared-target path splits both lane products as K2-MN's
    does: the split holds η, f and g to TOL of their Σ|terms| against the
    float64 plain version at phase 13d's magnitudes (x standard normal
    with the intercept column, B (L, d) of scale 1/√d, a 0/1 target for
    the logistic family and a real one for the Normal), where a single
    TF32 pass misses that bound."""
    rng = np.random.RandomState(d * L + (family == "normal"))
    m = 256
    x = rng.standard_normal((m, d)).astype(np.float32)
    x[:, -1] = 1.0
    B = (rng.standard_normal((L, d)) / np.sqrt(d)).astype(np.float32)
    if family == "logistic":
        y = (rng.uniform(size=m) < 0.4).astype(np.float32)
    else:
        y = (2.0 * rng.standard_normal(m)).astype(np.float32)
    mask = _masked(rng, 1, m)[0]
    x, y, mask, B = (torch.from_numpy(a) for a in (x, y, mask, B))
    xd, yd, md = x.double(), y.double(), mask.double()
    eta = xd @ B.double().T
    eta_mag = xd.abs() @ B.double().abs().T
    ref = getattr(multiclass, f"{family}_ovr_value_and_grad_ref")
    rf, rg = ref(xd[None], yd[None].expand(L, 1, m), md[None], B.double())
    if family == "logistic":
        sp = torch.logaddexp(torch.zeros_like(eta), eta)
        f_mag = torch.sum(md[:, None] * (sp.abs() + (yd[:, None] * eta).abs()), 0)
        w = md[:, None] * (torch.sigmoid(eta) - yd[:, None])
    else:
        f_mag = torch.sum(md[:, None] * 0.5 * (yd[:, None] - eta) ** 2, 0)
        w = md[:, None] * (eta - yd[:, None])
    g_mag = w.abs().T @ xd.abs()

    def worst(passes):
        e, f, g = _ovr_by_tensor_cores(family, x, y, mask, B, passes)
        return (float(((e - eta).abs() / eta_mag).max()), float(((f - rf).abs() / f_mag).max()),
                float(((g - rg).abs() / g_mag).max()))

    three, one = worst(3), worst(1)
    assert max(three) <= TOL, three
    assert one[0] > TOL and one[2] > TOL, one
