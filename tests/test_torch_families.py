"""K2's family-generic plain version (``ops/logistic.py``: the logistic,
normal and Poisson losses on float32 or bfloat16 x) and the port's
``Normal`` and ``Poisson`` families against the JAX reference's, on the
CPU.

The same seeded numpy inputs go to ``jax.value_and_grad`` of
``dask_ml_tpu.solvers.families.<Family>.loss`` (x as a float32 or
bfloat16 ``jnp`` array: the reference widens it to float32 in its
product) and to the port's wrappers, which run the plain version on a CPU
tensor.  Tolerances: f to rtol 1e-5, g to 1e-5 of each element's Σ|terms|
(float32 sums in another order); the lanes that ``active`` leaves out are
zeros.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dask_ml_tpu.solvers import families as ref_families
from dask_ml_tpu_torch.core import mesh
from dask_ml_tpu_torch.ops import logistic, multiclass
from dask_ml_tpu_torch.solvers import Logistic, Normal, Poisson, multinomial

TOL = 1e-5
WRAPPERS = {"logistic": (logistic.logistic_value_and_grad, logistic.logistic_value),
            "normal": (logistic.normal_value_and_grad, logistic.normal_value),
            "poisson": (logistic.poisson_value_and_grad, logistic.poisson_value)}
REF = {"logistic": ref_families.Logistic, "normal": ref_families.Normal,
       "poisson": ref_families.Poisson}
PORT = {"logistic": Logistic, "normal": Normal, "poisson": Poisson}


@pytest.fixture(autouse=True)
def _cpu():
    mesh.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    mesh.set_device(None)
    torch.set_num_threads(threads)


def _inputs(family, P, m, d, seed, eta_scale=1.0):
    """x, y, a weighted mask in [0, 3] with zeros, β; y fits the family
    (0/1, real, counts)."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((P, m, d)).astype(np.float32)
    beta = (eta_scale * rng.standard_normal((P, d)) / np.sqrt(d)).astype(np.float32)
    if family == "logistic":
        y = (rng.uniform(size=(P, m)) < 0.4).astype(np.float32)
    elif family == "normal":
        y = (3.0 * rng.standard_normal((P, m))).astype(np.float32)
    else:
        y = rng.poisson(2.0, size=(P, m)).astype(np.float32)
    mask = (3.0 * rng.uniform(size=(P, m))).astype(np.float32)
    mask[rng.uniform(size=(P, m)) < 0.1] = 0.0
    return x, y, mask, beta


def _magnitudes(family, x, y, mask, beta):
    """Σ|terms| of f and of each g element, in float64."""
    eta = np.einsum("pmd,pd->pm", x.astype(np.float64), beta.astype(np.float64))
    if family == "logistic":
        f_terms = np.abs(np.logaddexp(0.0, eta)) + np.abs(y * eta)
        w = 1.0 / (1.0 + np.exp(-eta)) - y
    elif family == "normal":
        f_terms = 0.5 * (y - eta) ** 2
        w = eta - y
    else:
        f_terms = np.exp(eta) + np.abs(y * eta)
        w = np.exp(eta) - y
    return (mask * f_terms).sum(1), np.einsum("pm,pmd->pd", np.abs(mask * w), np.abs(x))


def _bf16(x):
    """x rounded to bfloat16, as float32 (what both packages read)."""
    return torch.from_numpy(x).bfloat16().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["logistic", "normal", "poisson"])
@pytest.mark.parametrize("P,m,d", [(1, 1001, 3), (3, 137, 29), (2, 77, 1), (2, 50, 130)])
def test_plain_version_matches_reference_value_and_grad(family, dtype, P, m, d):
    x, y, mask, beta = _inputs(family, P, m, d, P * m + d)
    active = np.ones(P, bool)
    if P > 1:
        active[1] = False
    xt = torch.from_numpy(x)
    if dtype == "bfloat16":
        xt = xt.bfloat16()
        x = _bf16(x)
    vg, v = WRAPPERS[family]
    args = (xt, *map(torch.from_numpy, (y, mask, beta)), torch.from_numpy(active))
    f, g = vg(*args)
    fv = v(*args)
    assert f.dtype == g.dtype == torch.float32
    ref_vg = jax.value_and_grad(REF[family].loss)
    jx = jnp.asarray(x) if dtype == "float32" else jnp.asarray(x, dtype=jnp.bfloat16)
    f_mag, g_mag = _magnitudes(family, x, y, mask, beta)
    for p in range(P):
        if not active[p]:
            assert f[p].item() == 0.0 and fv[p].item() == 0.0 and not bool(g[p].any())
            continue
        rf, rg = ref_vg(jnp.asarray(beta[p]), jx[p], jnp.asarray(y[p]), jnp.asarray(mask[p]))
        np.testing.assert_allclose(f[p].item(), float(rf), rtol=TOL)
        assert f[p].item() == fv[p].item()  # both wrappers compute f the same way
        assert abs(f[p].item() - float(rf)) <= TOL * f_mag[p]
        assert np.all(np.abs(g[p].numpy() - np.asarray(rg)) <= TOL * g_mag[p] + 1e-6)


def test_poisson_at_large_linear_predictors_and_past_overflow():
    # |η| up to ~80: everything stays finite and agrees; past exp's float32
    # range the terms are inf, and NaN where the mask is 0 (0·inf), as the
    # reference's are
    x, y, mask, beta = _inputs("poisson", 2, 300, 29, 7)
    x = x / np.linalg.norm(x, axis=2, keepdims=True)  # unit rows: |η| ≤ ‖β‖
    beta = 80.0 * x[:, 0] * np.array([[1.0], [-1.0]], np.float32)  # η = ±80 at row 0
    eta = np.einsum("pmd,pd->pm", x, beta)
    assert 79 < np.abs(eta).max() <= 80.001
    f, g = logistic.poisson_value_and_grad(*map(torch.from_numpy, (x, y, mask, beta)))
    assert bool(torch.isfinite(f).all()) and bool(torch.isfinite(g).all())
    ref_vg = jax.value_and_grad(ref_families.Poisson.loss)
    for p in range(2):
        rf, rg = ref_vg(*map(jnp.asarray, (beta[p], x[p], y[p], mask[p])))
        np.testing.assert_allclose(f[p].item(), float(rf), rtol=TOL)
        np.testing.assert_allclose(g[p].numpy(), np.asarray(rg), rtol=TOL,
                                   atol=TOL * np.abs(np.asarray(rg)).max())
    mask0 = mask.copy()
    mask0[0, :] = 0.0
    f, g = logistic.poisson_value_and_grad(
        *map(torch.from_numpy, (x, y, mask0, 1.3 * beta)))
    for p, m in ((0, mask0), (1, mask)):
        rf, rg = ref_vg(*map(jnp.asarray, (1.3 * beta[p], x[p], y[p], m[p])))
        assert np.isnan(f[p].item()) == np.isnan(float(rf))
        assert np.isinf(f[p].item()) == np.isinf(float(rf))
        np.testing.assert_array_equal(np.isnan(g[p].numpy()), np.isnan(np.asarray(rg)))


def test_wrappers_count_plain_calls_and_check_their_inputs():
    x, y, mask, beta = map(torch.from_numpy, _inputs("normal", 2, 40, 5, 3))
    before = (logistic.glm_value_and_grad_ref.calls, logistic.logistic_value_and_grad_ref.calls)
    logistic.normal_value(x, y, mask, beta)
    logistic.poisson_value_and_grad(x.bfloat16(), y, mask, beta)
    logistic.logistic_value(x, y, mask, beta)
    assert logistic.glm_value_and_grad_ref.calls == before[0] + 2
    assert logistic.logistic_value_and_grad_ref.calls == before[1] + 1
    # the kernel's launch counters stay where they were on the CPU
    assert logistic.normal_value.launches == 0 and logistic.poisson_value_and_grad.launches == 0
    for bad in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            logistic.normal_value(x.to(bad), y, mask, beta)
    with pytest.raises(TypeError, match="beta must be float32"):
        logistic.poisson_value(x, y, mask, beta.bfloat16())
    with pytest.raises(ValueError, match="unknown family"):
        logistic.glm_value_and_grad_ref("gamma", x, y, mask, beta)


@pytest.mark.parametrize("family", ["logistic", "normal", "poisson"])
def test_hessian_weights_and_predict_match_reference(family):
    eta = np.linspace(-6.0, 6.0, 41).astype(np.float32)
    port, ref = PORT[family], REF[family]
    np.testing.assert_allclose(port.hessian_weights(torch.from_numpy(eta)).numpy(),
                               np.asarray(ref.hessian_weights(jnp.asarray(eta))), rtol=1e-6)
    np.testing.assert_allclose(port.predict(torch.from_numpy(eta)).numpy(),
                               np.asarray(ref.predict(jnp.asarray(eta))), rtol=1e-6)


def test_families_route_through_k2_and_refuse_what_it_does_not_take():
    x, y, mask, beta = map(torch.from_numpy, _inputs("poisson", 2, 40, 5, 4))
    f, g = Poisson.loss_and_grad(beta, x, y, mask)
    rf, rg = logistic.glm_value_and_grad_ref("poisson", x, y, mask, beta)
    assert torch.equal(f, rf) and torch.equal(g, rg)
    assert torch.equal(Normal.loss(beta, x, y, mask),
                       logistic.glm_value_and_grad_ref("normal", x, y, mask, beta, grad=False)[0])
    Y = torch.stack([y, y])
    # K targets of the Normal family go through K2-OvR's Normal family
    f2, g2 = Normal.loss_and_grad(beta.repeat(2, 1), x, Y, mask)
    rf2, rg2 = multiclass.normal_ovr_value_and_grad_ref(x, Y, mask, beta.repeat(2, 1))
    assert torch.equal(f2, rf2) and torch.equal(g2, rg2)
    with pytest.raises(NotImplementedError, match="packed Poisson"):
        Poisson.loss(beta.repeat(2, 1), x, Y, mask)
    with pytest.raises(NotImplementedError, match="bf16 multi-class"):
        Logistic.loss_and_grad(beta.repeat(2, 1), x.bfloat16(), (Y > 2).float(), mask)
    with pytest.raises(NotImplementedError, match="bf16 multi-class"):
        multinomial(3).loss(torch.zeros(2, 15), x.bfloat16(), torch.zeros(2, 40), mask)
