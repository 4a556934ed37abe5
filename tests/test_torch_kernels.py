"""The Lloyd kernels, K2 (the logistic, normal and Poisson losses and
gradients, on float32 or bfloat16 x) and K2-OvR (its logistic and Normal
families, on K targets of their own or one shared target) and K2-MN (the
multi-class losses), K7 (MiniBatchKMeans' update and epoch) and K10 (the
guarded pairwise distances), K12 (the quantile sketch's histogram pass), K9
(GaussianNB's class moments) and K9b (its joint log-likelihood) against
their plain versions, on a card.

The kernels are CUDA C++ with no CPU mode, so these tests skip without a
card and ``nvcc``.  They import neither JAX nor the reference, so on a
machine with a card and without JAX they run as
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.

Tolerance: float32 with another summation order, so sums agree to 1e-5
of each cluster's Σ|mask·x| and inertia to rtol 1e-5 (both against the
plain reduce taken in float64, since float32 atomics carry an error of
that size themselves), and d² to 1e-5 of ‖x‖²+‖c‖²; a label may differ
only where the two smallest d² are that close.  K2's f and g agree with
the plain version to 1e-5 of their Σ|terms| (float64), the scale of the
float32 rounding of either summation order, for every family and for a
bf16 x (both read the same bf16 values and widen them to float32), where
the Σ|terms| of the normal and Poisson families and of bf16 x also carry
each row's η rounding through the loss's derivative (at Poisson's |η| ~
80 one row's exp(η) is most of the sum, and its η rounding, times
exp(η), is what two summation orders differ by); so do K2-OvR's and
K2-MN's against their plain versions taken in float64.  K7a rounds every
operation as its plain version does and must give the same bits; K7b's
epoch, whose sums run in another order, holds its centres to 1e-4 of their
largest entry, the mass to rtol 1e-5 and the mean inertia to rtol 1e-5, and
gives the same bits twice.  K10 holds d² to 1e-5·(‖x−a‖²+‖y−a‖²) (a the
anchor), √d² through its square and exp(−γd²) to 1e-5·γ·(‖x−a‖²+‖y−a‖²);
its flagged count equals the plain version's, and a self call's diagonal is
exactly 0.  The edge cases of K10's tiles add to the exp(−γd²) bound two
float32 ulps of the value, the rounding of exp itself (at d = 1 and a scale
near 1e-3 the d² term alone is below one ulp of a value near 1).  K12's
counts are uint32 and exact: they equal the plain version's, and two
launches give the same bits.  K9's sums run in another order than its
plain version's gemms: counts, means and variances agree to 1e-5 of the
larger of |plain| and the class's mean |x| (means) or its largest variance
(variances), and two launches give the same bits.  K9b rounds every
operation as its plain version and gives its bits.
"""

import shutil

import pytest
import torch

from dask_ml_tpu_torch.ops import logistic, lloyd, multiclass
from dask_ml_tpu_torch.ops.scatter import bucket_sum

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or shutil.which("nvcc") is None:
        pytest.skip("needs a CUDA card and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(n, d, k, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=device) * 3
    mask = torch.rand(n, generator=gen, device=device)
    mask[torch.rand(n, generator=gen, device=device) < 0.1] = 0.0
    centers = torch.randn(k, d, generator=gen, device=device) * 3
    cvalid = (torch.rand(k, generator=gen, device=device) < 0.7).float()
    cvalid[0] = 1.0
    return x, mask, centers, cvalid


def _label_ok(labels, ref_labels, x, centers, cvalid=None):
    d2 = ((x.double()[:, None, :] - centers.double()[None]) ** 2).sum(-1)
    if cvalid is not None:
        d2[:, cvalid <= 0] = float("inf")
    two = torch.topk(d2, min(2, d2.shape[1]), dim=1, largest=False).values
    scale = (x.double() ** 2).sum(1) + (centers.double() ** 2).sum(1)[ref_labels]
    tie = (two[:, -1] - two[:, 0]) < TOL * scale
    return bool(((labels == ref_labels) | tie).all())


def _case(d, k, n=10_007, edge=None, name=None):
    return pytest.param(d, k, n, edge, id=name or f"{d}-{k}")


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,n,edge", [
    _case(50, 8), _case(64, 64), _case(3, 1000), _case(130, 9), _case(130, 300),
    # the reduce's register path ends at k = 16; d % 4 != 0; d past one
    # 64-feature chunk with few clusters
    _case(50, 16), _case(50, 17), _case(3, 8), _case(3, 16), _case(130, 8),
    # n under one 256-row tile, and not a multiple of it
    _case(50, 8, 100, name="50-8-n100"), _case(64, 64, 300, name="64-64-n300"),
    # nothing weighted; a cluster no row is nearest to (both reduce paths)
    _case(50, 8, edge="zero_mask", name="50-8-zero_mask"),
    _case(50, 8, edge="empty_cluster", name="50-8-empty_cluster"),
    _case(64, 64, edge="empty_cluster", name="64-64-empty_cluster"),
])
def test_kernels_match_plain_versions(cuda, d, k, n, edge):
    x, mask, centers, cvalid = _inputs(n, d, k, d * k, cuda)
    if edge == "zero_mask":
        mask.zero_()
    if edge == "empty_cluster":
        centers[-1] = 1e3
    sums, counts, inertia = lloyd.lloyd_assign_reduce(x, mask, centers)
    kl, kd2, _ = lloyd.lloyd_assign(x, mask, centers)
    # float32 index_add_ sums in atomic order; hold the reduce to the plain
    # version taken in float64 over the kernel's labels
    m64 = mask.double()
    s64 = bucket_sum(x.double() * m64[:, None], kl, k)
    mag = bucket_sum(x.double().abs() * m64[:, None], kl, k)
    assert bool(((sums.double() - s64).abs() <= TOL * mag + 1e-6).all())
    torch.testing.assert_close(counts.double(), bucket_sum(m64, kl, k), rtol=TOL, atol=TOL)
    torch.testing.assert_close(inertia.double(), torch.sum(kd2.double() * m64),
                               rtol=TOL, atol=0)
    if edge == "zero_mask":
        assert not bool(sums.any()) and not bool(counts.any()) and float(inertia) == 0.0
    if edge == "empty_cluster":
        assert not bool((kl == k - 1).any())
        assert not bool(sums[-1].any()) and float(counts[-1]) == 0.0
    for cv in (None, cvalid):
        kl, kd2, ki = lloyd.lloyd_assign(x, mask, centers, cv)
        rl, rd2, ri2 = lloyd.lloyd_assign_ref(x, mask, centers, cv)
        torch.testing.assert_close(ki, ri2, rtol=TOL, atol=0)
        scale = (x * x).sum(1) + (centers * centers).sum(1).max()
        assert bool(((kd2 - rd2).abs() <= TOL * scale).all())
        assert _label_ok(kl, rl, x, centers, cv)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_reduce_rejects_misaligned_x(cuda):
    x, mask, centers, _ = _inputs(1000, 50, 8, 3, cuda)
    flat = torch.empty(1000 * 50 + 1, device=cuda)
    shifted = flat[1:].view(1000, 50)  # 4 bytes past an aligned start
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="16-byte boundary"):
        lloyd.lloyd_assign_reduce(shifted, mask, centers)


def _assign_case(n, d, k, n_valid, seed, device, dup=False):
    """Inputs with ``n_valid`` valid slots (slot 0 among them unless only
    one is valid, then the last).  ``dup``: candidates are rows of x, and
    some valid slots repeat an earlier valid one, so those rows tie exactly
    and must go to the earlier slot; returns the (earlier, later) pairs."""
    x, mask, centers, _ = _inputs(n, d, k, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    cvalid = torch.zeros(k, device=device)
    if n_valid == 1:
        cvalid[-1] = 1.0
    else:
        cvalid[0] = 1.0
        cvalid[1 + torch.randperm(k - 1, generator=gen, device=device)[: n_valid - 1]] = 1.0
    pairs = []
    if dup:
        centers = x[torch.randperm(n, generator=gen, device=device)[:k]].clone()
        valid = torch.nonzero(cvalid)[:, 0].tolist()
        for lo, hi in zip(valid[0:12:2], valid[1:12:2]):
            centers[hi] = centers[lo]
            pairs.append((lo, hi))
    return x, mask, centers, cvalid, pairs


@pytest.mark.cuda
@pytest.mark.parametrize("d,k,n_valid,dup", [
    (50, 8, 8, False), (50, 1729, 502, False), (3, 1000, 700, False),
    (130, 300, 210, False), (50, 1729, 1, False), (50, 1729, 502, True),
    (3, 40, 30, True)])
def test_assign_matches_plain_version(cuda, d, k, n_valid, dup):
    n = 10_007  # not a multiple of any row tile
    x, mask, centers, cvalid, pairs = _assign_case(n, d, k, n_valid, d + k, cuda, dup)
    kl, kd2, ki = lloyd.lloyd_assign(x, mask, centers, cvalid)
    assert lloyd.lloyd_assign.last_k == n_valid  # only the valid slots are computed
    rl, rd2, ri = lloyd.lloyd_assign_ref(x, mask, centers, cvalid)
    torch.testing.assert_close(ki, ri, rtol=TOL, atol=0)
    scale = (x * x).sum(1) + (centers * centers).sum(1).max()
    assert bool(((kd2 - rd2).abs() <= TOL * scale).all())
    assert bool((cvalid[kl] > 0).all())
    assert _label_ok(kl, rl, x, centers, cvalid)
    for lo, hi in pairs:  # exact ties go to the earlier valid slot
        assert not bool((kl == hi).any())
    if dup:
        assert bool(torch.isin(kl, torch.tensor([p[0] for p in pairs], device=cuda)).any())
    again = lloyd.lloyd_assign(x, mask, centers, cvalid)
    for u, v in zip((kl, kd2, ki), again):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_kernels_are_deterministic(cuda):
    x, mask, centers, _ = _inputs(50_003, 50, 8, 1, cuda)
    a = lloyd.lloyd_assign_reduce(x, mask, centers)
    b = lloyd.lloyd_assign_reduce(x, mask, centers)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.cuda
def test_wrapper_counts_its_launches(cuda):
    x, mask, centers, _ = _inputs(1000, 4, 3, 2, cuda)
    before = lloyd.lloyd_assign.launches
    lloyd.lloyd_assign(x, mask, centers)
    lloyd.lloyd_assign_ref(x, mask, centers)
    assert lloyd.lloyd_assign.launches == before + 1


# ------------------------------------------------------------------ K2

def _logistic_inputs(P, m, d, seed, device, pad_lane=False):
    """x, y, fractional mask, beta; ``pad_lane``: the last lane holds only
    pad rows (x zero, mask zero), as a shard of padding does."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(P, m, d, generator=gen, device=device)
    beta = torch.randn(P, d, generator=gen, device=device) / d ** 0.5
    y = (torch.rand(P, m, generator=gen, device=device) < 0.4).float()
    mask = torch.rand(P, m, generator=gen, device=device)
    mask[torch.rand(P, m, generator=gen, device=device) < 0.1] = 0.0
    if pad_lane:
        x[-1] = 0.0
        mask[-1] = 0.0
    return x, y, mask, beta


def _logistic_magnitudes(x, y, mask, beta):
    """Σ|terms| of f and of each g element, in float64: the scale of the
    float32 rounding of either summation order."""
    x, y, mask, beta = x.double(), y.double(), mask.double(), beta.double()
    eta = torch.einsum("pmd,pd->pm", x, beta)
    sp = torch.logaddexp(torch.zeros_like(eta), eta)
    f_mag = (mask * (sp.abs() + (y * eta).abs())).sum(1)
    g_mag = torch.einsum("pm,pmd->pd", (mask * (torch.sigmoid(eta) - y)).abs(), x.abs())
    return f_mag, g_mag


def _hold_logistic(f, g, x, y, mask, beta, lanes):
    rf, rg = logistic.logistic_value_and_grad_ref(x, y, mask, beta)
    f_mag, g_mag = _logistic_magnitudes(x, y, mask, beta)
    assert bool(((f - rf).abs()[lanes].double() <= TOL * f_mag[lanes] + 1e-6).all())
    if g is not None:
        assert bool(((g - rg).abs()[lanes].double() <= TOL * g_mag[lanes] + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("P,m,d", [(1, 1001, 3), (8, 1375, 29), (8, 4097, 130),
                                   (3, 777, 1), (2, 300, 2000)])
def test_logistic_matches_plain_version(cuda, P, m, d):
    x, y, mask, beta = _logistic_inputs(P, m, d, P * m + d, cuda, pad_lane=P > 1)
    lanes = torch.ones(P, dtype=torch.bool, device=cuda)
    f, g = logistic.logistic_value_and_grad(x, y, mask, beta)
    fv = logistic.logistic_value(x, y, mask, beta)
    torch.cuda.synchronize()
    _hold_logistic(f, g, x, y, mask, beta, lanes)
    assert torch.equal(f, fv)  # both variants compute f the same way
    if P > 1:  # the lane of pad rows sums to zero
        assert float(f[-1]) == 0.0 and not bool(g[-1].any())
    again = logistic.logistic_value_and_grad(x, y, mask, beta)
    assert torch.equal(f, again[0]) and torch.equal(g, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("grad", [True, False])
def test_logistic_leaves_inactive_lanes_unwritten(cuda, grad):
    P, m, d = 4, 2049, 29
    x, y, mask, beta = _logistic_inputs(P, m, d, 5, cuda)
    active = torch.tensor([True, False, True, True], device=cuda)
    if grad:
        f, g = logistic.logistic_value_and_grad(x, y, mask, beta, active)
    else:
        f, g = logistic.logistic_value(x, y, mask, beta, active), None
    torch.cuda.synchronize()
    assert float(f[1]) == 0.0 and (g is None or not bool(g[1].any()))  # never written
    assert bool((f[active] != 0).all())
    _hold_logistic(f, g, x, y, mask, beta, active)


@pytest.mark.cuda
def test_logistic_rejects_what_the_kernel_does_not_take(cuda):
    x, y, mask, beta = _logistic_inputs(2, 100, 29, 1, cuda)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            logistic.logistic_value_and_grad(x.to(dtype), y, mask, beta)
    logistic.logistic_value_and_grad(x.bfloat16(), y, mask, beta)  # the bf16 variant
    with pytest.raises(TypeError, match="beta must be float32"):
        logistic.logistic_value_and_grad(x, y, mask, beta.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        logistic.logistic_value_and_grad(x.transpose(1, 2).contiguous().transpose(1, 2),
                                         y, mask, beta)


@pytest.mark.cuda
def test_logistic_wrappers_count_their_launches(cuda):
    x, y, mask, beta = _logistic_inputs(2, 100, 5, 1, cuda)
    before = (logistic.logistic_value_and_grad.launches, logistic.logistic_value.launches)
    logistic.logistic_value_and_grad(x, y, mask, beta)
    logistic.logistic_value(x, y, mask, beta)
    logistic.logistic_value_and_grad_ref(x, y, mask, beta)
    assert (logistic.logistic_value_and_grad.launches,
            logistic.logistic_value.launches) == (before[0] + 1, before[1] + 1)


# ------------------------------------- K2's other families and bf16 x

# (P, m, d): m = 1001, 1002, 1003 put bf16 lane bases (58-byte rows at
# d = 29) off 16-byte boundaries; m = 37 is less than a tile; d = 1 and
# 130 change the rows a tile; d = 2000 takes row_kernel
GLM_SHAPES = [(3, 1001, 29), (3, 1002, 29), (3, 1003, 29), (2, 37, 29), (3, 777, 1),
              (2, 4097, 130), (2, 300, 2000)]
GLM_VARIANTS = [("normal", torch.float32), ("normal", torch.bfloat16),
                ("poisson", torch.float32), ("poisson", torch.bfloat16),
                ("logistic", torch.bfloat16)]


def _glm_inputs(family, P, m, d, seed, device, dtype):
    """x (float32 or bf16), y fitting the family, a weighted mask in [0, 3]
    with zeros, β (Poisson: scaled to |η| up to 80), lane 1 inactive."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(P, m, d, generator=gen, device=device).to(dtype)
    beta = torch.randn(P, d, generator=gen, device=device) / d ** 0.5
    if family == "logistic":
        y = (torch.rand(P, m, generator=gen, device=device) < 0.4).float()
    elif family == "normal":
        y = 3.0 * torch.randn(P, m, generator=gen, device=device)
    else:
        y = torch.poisson(torch.full((P, m), 2.0, device=device), generator=gen)
        eta = torch.einsum("pmd,pd->pm", x.float(), beta)
        beta = beta * (80.0 / eta.abs().amax(dim=1, keepdim=True))
    mask = 3.0 * torch.rand(P, m, generator=gen, device=device)
    mask[torch.rand(P, m, generator=gen, device=device) < 0.1] = 0.0
    active = torch.ones(P, dtype=torch.bool, device=device)
    active[1] = False
    return x, y, mask, beta, active


def _glm_magnitudes(family, x, y, mask, beta):
    """Σ|terms| of f and of each g element, in float64, with each row's η
    rounding carried through the loss: a row adds |ℓ'(η)|·s to f's and
    |w'(η)|·s·|x| to g's, s = Σ_j |x_j β_j|.  At Poisson's |η| ~ 80 one
    row's exp(η) is most of the sum, and the rounding of its η, times
    exp'(η) = exp(η), is what two summation orders differ by."""
    x, y, mask, beta = x.double(), y.double(), mask.double(), beta.double()
    eta = torch.einsum("pmd,pd->pm", x, beta)
    spread = torch.einsum("pmd,pd->pm", x.abs(), beta.abs())
    if family == "logistic":
        sig = torch.sigmoid(eta)
        f_terms = torch.logaddexp(torch.zeros_like(eta), eta).abs() + (y * eta).abs()
        w, dloss, dw = sig - y, sig - y, sig * (1.0 - sig)
    elif family == "normal":
        f_terms, w, dloss, dw = 0.5 * (y - eta) ** 2, eta - y, eta - y, torch.ones_like(eta)
    else:
        mu = torch.exp(eta)
        f_terms, w, dloss, dw = mu + (y * eta).abs(), mu - y, mu - y, mu
    f_mag = (mask * (f_terms + dloss.abs() * spread)).sum(1)
    g_mag = torch.einsum("pm,pmd->pd", mask * (w.abs() + dw * spread), x.abs())
    return f_mag, g_mag


@pytest.mark.cuda
@pytest.mark.parametrize("family,dtype", GLM_VARIANTS,
                         ids=[f"{f}-{str(t)[6:]}" for f, t in GLM_VARIANTS])
@pytest.mark.parametrize("P,m,d", GLM_SHAPES)
def test_glm_variants_match_plain_version(cuda, family, dtype, P, m, d):
    x, y, mask, beta, active = _glm_inputs(family, P, m, d, P * m + d, cuda, dtype)
    vg = getattr(logistic, f"{family}_value_and_grad")
    v = getattr(logistic, f"{family}_value")
    f, g = vg(x, y, mask, beta, active)
    fv = v(x, y, mask, beta, active)
    again = vg(x, y, mask, beta, active)
    torch.cuda.synchronize()
    assert torch.equal(f, fv) and torch.equal(f, again[0]) and torch.equal(g, again[1])
    assert float(f[1]) == 0.0 and not bool(g[1].any())  # lane 1 never written
    rf, rg = logistic.glm_value_and_grad_ref(family, x, y, mask, beta)
    f_mag, g_mag = _glm_magnitudes(family, x, y, mask, beta)
    assert bool(torch.isfinite(f[active]).all()) and bool(torch.isfinite(g[active]).all())
    assert bool(((f - rf).abs()[active].double() <= TOL * f_mag[active] + 1e-6).all())
    assert bool(((g - rg).abs()[active].double() <= TOL * g_mag[active] + 1e-6).all())


@pytest.mark.cuda
def test_glm_wrappers_count_their_launches(cuda):
    x, y, mask, beta, _ = _glm_inputs("normal", 2, 100, 5, 1, cuda, torch.bfloat16)
    for family in ("normal", "poisson"):
        vg = getattr(logistic, f"{family}_value_and_grad")
        v = getattr(logistic, f"{family}_value")
        before = (vg.launches, v.launches, logistic.glm_value_and_grad_ref.calls)
        vg(x, y, mask, beta)
        v(x, y, mask, beta)
        assert (vg.launches, v.launches, logistic.glm_value_and_grad_ref.calls) == (
            before[0] + 1, before[1] + 1, before[2])


# --------------------------------------------------------- K2-OvR, K2-MN

def _multiclass_inputs(mode, P, m, d, K, seed, device):
    """x, targets, fractional mask, beta, lanes; the last shard holds only
    pad rows when P > 1."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(P, m, d, generator=gen, device=device)
    mask = torch.rand(P, m, generator=gen, device=device)
    mask[torch.rand(P, m, generator=gen, device=device) < 0.1] = 0.0
    if P > 1:
        x[-1] = 0.0
        mask[-1] = 0.0
    if mode == "ovr":
        y = (torch.rand(K, P, m, generator=gen, device=device) < 0.4).float()
        beta = torch.randn(K * P, d, generator=gen, device=device) / d ** 0.5
        return x, y, mask, beta, K * P
    y = torch.randint(0, K, (P, m), generator=gen, device=device).float()
    beta = torch.randn(P, d * K, generator=gen, device=device) / d ** 0.5
    return x, y, mask, beta, P


def _multiclass_magnitudes(mode, x, y, mask, beta):
    """Σ|terms| of f and of each g element, in float64."""
    x, y, mask, beta = x.double(), y.double(), mask.double(), beta.double()
    P, m, d = x.shape
    if mode == "ovr":
        K = y.shape[0]
        eta = torch.einsum("pmd,kpd->kpm", x, beta.view(K, P, d))
        sp = torch.logaddexp(torch.zeros_like(eta), eta)
        f_mag = (mask * (sp.abs() + (y * eta).abs())).sum(2).reshape(K * P)
        w = (mask * (torch.sigmoid(eta) - y)).abs()
        return f_mag, torch.einsum("kpm,pmd->kpd", w, x.abs()).reshape(K * P, d)
    K = beta.shape[1] // d
    eta = torch.einsum("pmd,pdk->pmk", x, beta.view(P, d, K))
    c = y.long()  # truncation; a label outside [0, K) picks no class
    onehot = torch.nn.functional.one_hot(c.clamp(0, K - 1), K).double()
    onehot *= ((c >= 0) & (c < K))[..., None]
    f_mag = (mask * (torch.logsumexp(eta, 2).abs() + (eta * onehot).sum(2).abs())).sum(1)
    w = (mask[:, :, None] * (torch.softmax(eta, 2) - onehot)).abs()
    return f_mag, torch.einsum("pmd,pmk->pdk", x.abs(), w).reshape(P, d * K)


_MC = {"ovr": (multiclass.logistic_ovr_value_and_grad, multiclass.logistic_ovr_value,
               multiclass.logistic_ovr_value_and_grad_ref),
       "mn": (multiclass.multinomial_value_and_grad, multiclass.multinomial_value,
              multiclass.multinomial_value_and_grad_ref)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ovr", "mn"])
@pytest.mark.parametrize("P,m,d,K", [
    (1, 1001, 3, 2), (8, 1375, 29, 4), (8, 4097, 130, 3), (3, 777, 1, 16), (2, 300, 29, 100),
    (2, 300, 2000, 4),
    # shard bases and target rows off 16-byte boundaries (m = 1, 2, 3 mod 4),
    # fewer rows than a tile, K = 1, 5 and 16, more gradient columns than
    # threads (d = 600 at K = 16)
    (3, 1001, 29, 4), (2, 1002, 28, 16), (4, 1003, 29, 5), (2, 37, 29, 3), (3, 1000, 29, 1),
    (2, 1000, 29, 16), (2, 301, 300, 5), (2, 301, 600, 16),
    # K2-MN's tensor-core path: one whole n-tile of 8 classes and one class
    # past it, d = 1..7 mod 8 at the main path's m (the padded features of
    # the last k-step), and m below 16 rows and below a tile
    (2, 1001, 29, 8), (2, 1001, 29, 9), (2, 1375000, 25, 4), (2, 1375000, 26, 4),
    (2, 1375000, 27, 4), (2, 1375000, 28, 4), (2, 1375000, 29, 4), (2, 1375000, 30, 4),
    (2, 1375000, 31, 4), (3, 5, 29, 4), (2, 13, 28, 16), (2, 200, 28, 16)])
def test_multiclass_matches_plain_version(cuda, mode, P, m, d, K):
    vg, v, ref = _MC[mode]
    x, y, mask, beta, lanes = _multiclass_inputs(mode, P, m, d, K, P * m + d + K, cuda)
    for active in (None, torch.arange(lanes, device=cuda) % 3 != 1):
        _hold_multiclass(mode, x, y, mask, beta, lanes, active, cuda)


def _hold_multiclass(mode, x, y, mask, beta, lanes, active, device):
    """Both variants against the float64 plain version within TOL of
    Σ|terms|; the same f from both, the same bits again, inactive lanes
    unwritten."""
    vg, v, ref = _MC[mode]
    f, g = vg(x, y, mask, beta, active)
    fv = v(x, y, mask, beta, active)
    again = vg(x, y, mask, beta, active)
    torch.cuda.synchronize()
    on = torch.ones(lanes, dtype=torch.bool, device=device) if active is None else active
    assert not bool(f[~on].any()) and not bool(g[~on].any()) and not bool(fv[~on].any())
    assert torch.equal(f, fv)  # both variants compute f the same way
    assert torch.equal(f, again[0]) and torch.equal(g, again[1])
    rf, rg = ref(x.double(), y.double(), mask.double(), beta.double())
    f_mag, g_mag = _multiclass_magnitudes(mode, x, y, mask, beta)
    assert bool(((f.double() - rf).abs()[on] <= TOL * f_mag[on] + 1e-6).all())
    assert bool(((g.double() - rg).abs()[on] <= TOL * g_mag[on] + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("P,m,d,K", [(2, 3001, 29, 4), (2, 1003, 28, 16), (3, 777, 29, 9)])
def test_multinomial_labels_masks_and_large_logits(cuda, P, m, d, K):
    """K2-MN with labels outside [0, K) (-1 and K pick no class, 2.7
    truncates to 2), rows with mask 0 and logits of |η| up to ~80, where an
    unshifted exp would overflow float32."""
    x, y, mask, beta, lanes = _multiclass_inputs("mn", P, m, d, K, P * m + d, cuda)
    y[:, ::7] = -1.0
    y[:, 3::7] = float(K)
    y[:, 5::7] = 2.7
    beta *= 80.0 / 3.0  # η = x·β has a standard deviation near 27
    assert float((torch.einsum("pmd,pdk->pmk", x, beta.view(P, d, K))).abs().max()) > 80.0
    for active in (None, torch.arange(lanes, device=cuda) != 1):
        _hold_multiclass("mn", x, y, mask, beta, lanes, active, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("P,m,d,K", [(8, 1375000, 29, 4), (1, 1000000, 28, 16)])
def test_multinomial_intercept_column_at_the_fit_shapes(cuda, P, m, d, K):
    """K2-MN at the multinomial fits' shapes with a column of ones (the
    intercept) and every row unmasked: that column's gradient is the sum of
    the weights themselves, a large share of its Σ|terms|, so a sum whose
    rounding leans one way over a block's rows shows there first.  Class 0
    takes 70% of the rows, so that its weights mostly share a sign."""
    x, y, mask, beta, lanes = _multiclass_inputs("mn", P, m, d, K, d * K, cuda)
    x[:, :, -1] = 1.0
    mask.fill_(1.0)
    y[torch.rand(P, m, device=cuda) < 0.7] = 0.0
    _hold_multiclass("mn", x, y, mask, beta, lanes, None, cuda)


@pytest.mark.cuda
def test_multiclass_wrappers_count_their_launches(cuda):
    for mode, (vg, v, ref) in _MC.items():
        x, y, mask, beta, _ = _multiclass_inputs(mode, 2, 100, 5, 3, 1, cuda)
        before = (vg.launches, v.launches, ref.calls)
        vg(x, y, mask, beta)
        v(x, y, mask, beta)
        assert (vg.launches, v.launches, ref.calls) == (before[0] + 1, before[1] + 1, before[2])


# ------------------------------------------- K2-OvR: families, shared target

_OVR_FAMILIES = {
    "logistic": (multiclass.logistic_ovr_value_and_grad, multiclass.logistic_ovr_value,
                 multiclass.logistic_ovr_value_and_grad_ref),
    "normal": (multiclass.normal_ovr_value_and_grad, multiclass.normal_ovr_value,
               multiclass.normal_ovr_value_and_grad_ref)}


def _ovr_family_inputs(family, P, m, d, K, shared, seed, device):
    """x, mask, beta as ``_multiclass_inputs`` makes them; targets 0/1
    (logistic) or real (normal), K of their own or one expanded to K.  A
    shared target is a view one float past the start of its buffer, so
    that its first element is off a 16-byte boundary."""
    x, y, mask, beta, lanes = _multiclass_inputs("ovr", P, m, d, K, seed, device)
    if family == "normal":
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        y = torch.randn(K, P, m, generator=gen, device=device) * 2.0
    if shared:
        buf = torch.empty(P * m + 1, device=device)
        buf[1:] = y[0].reshape(-1)
        y = buf[1:].view(P, m).expand(K, P, m)
    return x, y, mask, beta, lanes


def _ovr_family_magnitudes(family, x, Y, mask, beta):
    """Σ|terms| of f and of each g element, in float64."""
    x, Y, mask, beta = x.double(), Y.double(), mask.double(), beta.double()
    P, m, d = x.shape
    K = Y.shape[0]
    eta = torch.einsum("pmd,kpd->kpm", x, beta.view(K, P, d))
    if family == "logistic":
        sp = torch.logaddexp(torch.zeros_like(eta), eta)
        f_mag = (mask * (sp.abs() + (Y * eta).abs())).sum(2).reshape(K * P)
        w = (mask * (torch.sigmoid(eta) - Y)).abs()
    else:
        f_mag = (mask * 0.5 * (Y - eta) ** 2).sum(2).reshape(K * P)
        w = (mask * (eta - Y)).abs()
    return f_mag, torch.einsum("kpm,pmd->kpd", w, x.abs()).reshape(K * P, d)


# The shared-target tensor-core path (tc_kernel, d <= 32 and L <= 16): every
# lane count of the sweeps and past an n-tile, d = 1, 8 (one whole k-step),
# 28, 29 (the sweeps') and 32 (the most it takes), m below a tile and m = 1,
# 2, 3 mod 4 (shard bases off 16-byte boundaries)
_TC_SHAPES = [(3, (37, 1001, 1002, 1003, 20_001)[(i + j) % 5], d, L)
              for i, L in enumerate((1, 2, 5, 8, 9, 16))
              for j, d in enumerate((1, 8, 28, 29, 32))]


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["logistic", "normal"])
@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("P,m,d,K", [
    (1, 1001, 3, 2), (8, 1375, 29, 8), (3, 777, 1, 16), (2, 300, 29, 100), (2, 300, 2000, 4),
    # off 16-byte boundaries (m = 1, 2, 3 mod 4), fewer rows than a tile,
    # K = 1 and 5, more gradient columns than threads, the sweep's P = 1
    (3, 1001, 29, 4), (2, 1002, 28, 16), (4, 1003, 29, 5), (2, 37, 29, 3), (3, 1000, 29, 1),
    (2, 301, 600, 16), (1, 100003, 28, 8)] + _TC_SHAPES)
def test_ovr_families_on_shared_and_own_targets_match_plain_version(cuda, family, shared, P, m,
                                                                     d, K):
    """Both families' variants within TOL of the float64 plain version's
    Σ|terms|, with all lanes and with every third lane inactive (unwritten,
    and the active lanes' f and g bit-equal to the all-active call's); the
    same f from both variants and the same bits twice; a shared target
    gives what its materialized copy gives, within TOL."""
    vg, v, ref = _OVR_FAMILIES[family]
    x, Y, mask, beta, lanes = _ovr_family_inputs(family, P, m, d, K, shared, P * m + d + K,
                                                 cuda)
    assert multiclass.shared_target(Y) == (shared and K > 1) or K == 1
    f_mag, g_mag = _ovr_family_magnitudes(family, x, Y, mask, beta)
    every = None
    for active in (None, torch.arange(lanes, device=cuda) % 3 != 1):
        f, g = vg(x, Y, mask, beta, active)
        fv = v(x, Y, mask, beta, active)
        again = vg(x, Y, mask, beta, active)
        torch.cuda.synchronize()
        on = torch.ones(lanes, dtype=torch.bool, device=cuda) if active is None else active
        assert not bool(f[~on].any()) and not bool(g[~on].any()) and not bool(fv[~on].any())
        assert torch.equal(f, fv)
        assert torch.equal(f, again[0]) and torch.equal(g, again[1])
        every = (f, g) if every is None else every
        assert torch.equal(f[on], every[0][on]) and torch.equal(g[on], every[1][on])
        rf, rg = ref(x.double(), Y.double(), mask.double(), beta.double())
        assert bool(((f.double() - rf).abs()[on] <= TOL * f_mag[on] + 1e-6).all())
        assert bool(((g.double() - rg).abs()[on] <= TOL * g_mag[on] + 1e-6).all())
        if shared:
            fc, gc = vg(x, Y.contiguous(), mask, beta, active)
            assert bool(((f - fc).abs()[on].double() <= TOL * f_mag[on] + 1e-6).all())
            assert bool(((g - gc).abs()[on].double() <= TOL * g_mag[on] + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["logistic", "normal"])
@pytest.mark.parametrize("L", [5, 8])
def test_ovr_shared_intercept_column_at_the_sweep_shape(cuda, family, L):
    """The shared-target path at the sweeps' (8, 916667, 29) with a column
    of ones (the intercept) and every row unmasked, as
    ``test_multinomial_intercept_column_at_the_fit_shapes`` holds K2-MN:
    that column's gradient is the sum of the weights themselves, so a sum
    whose rounding leans one way over a block's rows shows there first.
    The logistic target is 1 on 90% of the rows and the Normal one sits
    above η, so that the weights mostly share a sign."""
    vg, v, _ = _OVR_FAMILIES[family]
    x, Y, mask, beta, lanes = _ovr_family_inputs(family, 8, 916_667, 29, L, True, L, cuda)
    x[:, :, -1] = 1.0
    mask.fill_(1.0)
    y = Y[0]
    y.copy_((torch.rand(8, 916_667, device=cuda) < 0.9).float() if family == "logistic"
            else y.abs() + 3.0)
    f, g = vg(x, Y, mask, beta)
    assert torch.equal(f, v(x, Y, mask, beta))
    rf, rg = _OVR_FAMILIES[family][2](x.double(), Y.double(), mask.double(), beta.double())
    f_mag, g_mag = _ovr_family_magnitudes(family, x, Y, mask, beta)
    assert bool(((f.double() - rf).abs() <= TOL * f_mag + 1e-6).all())
    assert bool(((g.double() - rg).abs() <= TOL * g_mag + 1e-6).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d,K,shared,path", [
    (29, 8, True, 3), (32, 16, True, 3), (1, 1, True, 3), (33, 8, True, 0), (29, 17, True, 0),
    (29, 8, False, 0), (2000, 4, True, 1)])
def test_ovr_plan_takes_the_tensor_core_path_within_its_limits(cuda, d, K, shared, path):
    """Over one shared target of at most 32 features and 16 lanes K2-OvR
    plans tc_kernel (path 3); past either limit, and on K targets of
    their own, ovr_kernel (path 0), or row_kernel (1) past its shared
    memory; the same for both families."""
    for fam in multiclass._FAMILIES.values():
        plan = multiclass._plan(multiclass._load(), cuda, 0, 8, 916_667, d, K, fam, shared)
        assert plan[0] == path


@pytest.mark.cuda
def test_ovr_rejects_a_target_that_is_neither_contiguous_nor_shared(cuda):
    x, Y, mask, beta, _ = _multiclass_inputs("ovr", 2, 100, 5, 3, 1, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        multiclass.normal_ovr_value(x, Y.transpose(1, 2).contiguous().transpose(1, 2), mask,
                                    beta)
    with pytest.raises(ValueError, match="contiguous"):
        multiclass.logistic_ovr_value(x, Y[0][:, ::2].expand(3, 2, 50), mask[:, ::2].contiguous(),
                                      beta)


@pytest.mark.cuda
def test_ovr_family_wrappers_count_their_launches(cuda):
    for family, (vg, v, ref) in _OVR_FAMILIES.items():
        x, Y, mask, beta, _ = _ovr_family_inputs(family, 2, 100, 5, 3, True, 1, cuda)
        before = (vg.launches, v.launches, ref.calls)
        vg(x, Y, mask, beta)
        v(x, Y, mask, beta)
        assert (vg.launches, v.launches, ref.calls) == (before[0] + 1, before[1] + 1, before[2])


# -- K7 and K10 --------------------------------------------------------------

from dask_ml_tpu_torch.ops import minibatch, pairwise  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("k,d", [(8, 50), (3, 7), (100, 130), (5000, 3)]
                         + [(k, d) for k in (1, 8, 16, 64) for d in (3, 50, 64, 130)])
def test_mbk_step_matches_k1a_then_k7a_bitwise(cuda, k, d):
    # the fused step (K7a in K1a's last launch) against K1a followed by
    # K7a's plain version (bit-equal to the separate K7a kernel it replaces),
    # at a ragged row count, with a centre no row reaches (batch mass 0) and
    # masses past 2^24
    n = 4099
    gen = torch.Generator(device=cuda).manual_seed(k + d)
    x = torch.randn(n, d, generator=gen, device=cuda)
    mask = 2.0 * torch.rand(n, generator=gen, device=cuda)
    mask[::7] = 0.0
    centers = torch.randn(k, d, generator=gen, device=cuda)
    if k > 1:
        centers[0] += 1e3
    counts = torch.stack([torch.rand(k, generator=gen, device=cuda) * 2 ** 25,
                          torch.rand(k, generator=gen, device=cuda)])
    counts[:, -1] = 0.0  # a centre's first batch
    before = (minibatch.mbk_step.launches, lloyd.lloyd_assign_reduce.launches)
    got = minibatch.mbk_step(centers, counts, x, mask)
    again = minibatch.mbk_step(centers, counts, x, mask)
    sums, bmass, inertia = lloyd.lloyd_assign_reduce(x, mask, centers)
    want = minibatch.mbk_update_ref(sums, bmass, centers, counts)
    torch.cuda.synchronize()
    assert (minibatch.mbk_step.launches, lloyd.lloyd_assign_reduce.launches) == (
        before[0] + 2, before[1] + 1)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2], inertia)
    if k > 1:
        assert float(bmass[0]) == 0.0 and torch.equal(got[0][0], centers[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k,bs,n_batches,start", [
    (20003, 50, 8, 1024, 19, 5), (5003, 50, 3, 100, 40, 0), (4099, 7, 16, 333, 12, 77),
    (3001, 130, 8, 1024, 2, 1), (3000, 50, 8, 5, 30, 3), (2049, 255, 9, 64, 20, 9),
    # past K7b's shapes: the epoch steps through K1a and K7a
    (2000, 20, 17, 100, 6, 4)])
def test_mbk_epoch_matches_plain_version(cuda, n, d, k, bs, n_batches, start):
    gen = torch.Generator(device=cuda).manual_seed(n)
    truth = torch.randn(k, d, generator=gen, device=cuda) * 3
    x = truth[torch.randint(0, k, (n,), generator=gen, device=cuda)]
    x += torch.randn(n, d, generator=gen, device=cuda)
    mask = torch.rand(n, generator=gen, device=cuda) * 2
    mask[-5:] = 0.0
    centers, counts = x[:k].clone(), torch.zeros(2, k, device=cuda)
    launches, stepped = minibatch.mbk_epoch.launches, minibatch.mbk_epoch.stepped
    got = minibatch.mbk_epoch(centers, counts, x, mask, start, bs, n_batches)
    again = minibatch.mbk_epoch(centers, counts, x, mask, start, bs, n_batches)
    want = minibatch.mbk_epoch_ref(centers, counts, x, mask, start, bs, n_batches)
    torch.cuda.synchronize()
    fused = k <= 16 and d <= 255
    assert minibatch.mbk_epoch.launches == launches + 2 * fused
    assert minibatch.mbk_epoch.stepped == stepped + 2 * (not fused)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4 * float(want[0].abs().max()))
    torch.testing.assert_close(got[1].sum(0), want[1].sum(0), rtol=TOL, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=TOL, atol=0)


def _k10_scale(x, y):
    a = 0.5 * (x.double().mean(0) + y.double().mean(0))
    return ((x.double() - a) ** 2).sum(1)[:, None] + ((y.double() - a) ** 2).sum(1)[None, :]


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d,kind,self_pairs,offset", [
    (1000, 300, 50, "sq", False, 0.0), (1000, 300, 50, "euclid", False, 0.0),
    (777, 131, 3, "rbf", False, 0.0), (513, 513, 50, "sq", True, 0.0),
    (300, 200, 130, "sq", False, 1e3), (2000, 100, 50, "rbf", False, 1e3),
    (129, 1, 1, "euclid", False, 0.0)])
def test_sq_euclidean_safe_matches_plain_version(cuda, n, m, d, kind, self_pairs, offset):
    gen = torch.Generator(device=cuda).manual_seed(n + m + d)
    x = torch.randn(n, d, generator=gen, device=cuda) + offset
    y = x[:m] if self_pairs else torch.randn(m, d, generator=gen, device=cuda) + offset
    if offset:
        y[: m // 4] = x[: m // 4]  # repeated rows: the exact recompute runs
    gamma = 1.0 / d if kind == "rbf" else None
    got = pairwise.sq_euclidean_safe(x, y, 0, 0, self_pairs, kind, gamma)
    flagged = int(pairwise.sq_euclidean_safe.last_flagged)
    want, want_flagged = pairwise.sq_euclidean_safe_ref(x, y, 0, 0, self_pairs, kind, gamma)
    assert flagged == int(want_flagged)
    if offset:
        assert flagged >= m // 4  # at least the repeated rows
    scale = _k10_scale(x, y)
    g, w = got.double(), want.double()
    if kind == "euclid":
        g, w = g ** 2, w ** 2
    bound = TOL * scale * (gamma if kind == "rbf" else 1.0)
    assert bool(((g - w).abs() <= bound + 1e-12).all())
    if self_pairs:
        assert bool((torch.diagonal(got) == 0).all())


@pytest.mark.cuda
def test_sq_euclidean_safe_fills_a_column_block(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(700, 50, generator=gen, device=cuda)
    y = torch.randn(96, 50, generator=gen, device=cuda)
    big = torch.full((700, 300), -1.0, device=cuda)
    out = pairwise.sq_euclidean_safe(x, y, kind="euclid", out=big[:, 100:196])
    want, _ = pairwise.sq_euclidean_safe_ref(x, y, kind="euclid")
    assert out.data_ptr() == big[:, 100:196].data_ptr()
    assert bool(((out.double() ** 2 - want.double() ** 2).abs()
                 <= TOL * _k10_scale(x, y)).all())
    assert bool((big[:, :100] == -1).all()) and bool((big[:, 196:] == -1).all())


# -- K7b and K10 at the edges of their Hopper designs --------------------------


def _mbk_inputs(n, d, k, seed, device, rows_init=False):
    # rows_init: the centres are k of the data rows, as k-means++ and the
    # random init draw them.  Otherwise they start near the true blob centres:
    # no row lies within float32 rounding of two centres, and no window's
    # inertia is rounding noise (a row against itself), either of which two
    # right summation orders may settle differently
    gen = torch.Generator(device=device).manual_seed(seed)
    truth = torch.randn(k, d, generator=gen, device=device) * 3
    x = truth[torch.randint(0, k, (n,), generator=gen, device=device)]
    x += torch.randn(n, d, generator=gen, device=device)
    mask = torch.rand(n, generator=gen, device=device) * 2
    mask[-5:] = 0.0
    if rows_init:
        centers = x[torch.randperm(n, generator=gen, device=device)[:k]].clone()
    else:
        centers = truth + 0.5 * torch.randn(k, d, generator=gen, device=device)
    counts = torch.stack([torch.rand(k, generator=gen, device=device) * 3,
                          torch.zeros(k, device=device)])
    return x, mask, centers, counts


def _hold_mbk_epoch(x, mask, centers, counts, start, bs, n_batches):
    launches = minibatch.mbk_epoch.launches
    got = minibatch.mbk_epoch(centers, counts, x, mask, start, bs, n_batches)
    again = minibatch.mbk_epoch(centers, counts, x, mask, start, bs, n_batches)
    want = minibatch.mbk_epoch_ref(centers, counts, x, mask, start, bs, n_batches)
    torch.cuda.synchronize()
    assert minibatch.mbk_epoch.launches == launches + 2
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-4 * float(want[0].abs().max()))
    torch.testing.assert_close(got[1].sum(0), want[1].sum(0), rtol=TOL, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=TOL, atol=0)


def _fma(a, b, c):
    # float32 fmaf: the product is exact in float64, the sum rounded there,
    # then to float32 (a double rounding, off by an ulp about once in 2^29)
    return (a.double() * b.double() + c.double()).float()


def _butterfly(parts, masks):
    # parts (..., p): the sum a shuffle butterfly over p lanes, by the lane
    # masks in that order, gives every lane
    lanes = torch.arange(parts.shape[-1], device=parts.device)
    for m in masks:
        parts = parts + parts[..., lanes ^ m]
    return parts[..., 0]


def _k7b_assign(xb, centers):
    """Labels and d^2 of K7b's assign, in its order of sums: the centre norms
    over 32 lanes of a warp (a butterfly by lane masks 16 down to 1), |x|^2
    and x.c over four lanes of a row (masks 1 then 2), each lane every 32nd
    (fourth) feature in turn; d^2 =
    max((|x|^2 + |c|^2) - 2 x.c, 0), the first of equal centres."""
    n, d = xb.shape
    k = centers.shape[0]
    cparts = torch.zeros(k, 32, device=xb.device)
    for j in range(d):
        cparts[:, j % 32] = _fma(centers[:, j], centers[:, j], cparts[:, j % 32])
    cn = _butterfly(cparts, (16, 8, 4, 2, 1))
    xparts = torch.zeros(n, 4, device=xb.device)
    dparts = torch.zeros(n, k, 4, device=xb.device)
    for j in range(d):
        xj = xb[:, j]
        xparts[:, j % 4] = _fma(xj, xj, xparts[:, j % 4])
        dparts[:, :, j % 4] = _fma(xj[:, None], centers[None, :, j], dparts[:, :, j % 4])
    xn, dot = _butterfly(xparts, (1, 2)), _butterfly(dparts, (1, 2))
    d2 = torch.clamp_min((xn[:, None] + cn[None, :]) - 2.0 * dot, 0.0)
    labels = torch.argmin(d2, dim=1)  # first index among ties
    return labels, torch.gather(d2, 1, labels[:, None])[:, 0]


def _hold_mbk_steps(x, mask, centers, counts, start, bs, n_batches):
    # each window an epoch of one step, from the plain version's state at that
    # step, held against a plain step whose assign repeats K7b's order of sums
    # (so a row within float32 rounding of two centres, or a window whose only
    # weighted row is its own centre, settles as in the kernel); the sums and
    # the update are the plain version's
    n, k = x.shape[0], centers.shape[0]
    launches, stepped = minibatch.mbk_epoch.launches, minibatch.mbk_epoch.stepped
    for i in range(n_batches):
        off = minibatch.window_start(start, i, bs, n)
        got = minibatch.mbk_epoch(centers, counts, x, mask, off, bs, 1)
        if i == 0:
            again = minibatch.mbk_epoch(centers, counts, x, mask, off, bs, 1)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
        xb, wb = x[off:off + bs], mask[off:off + bs]
        labels, best = _k7b_assign(xb, centers)
        want = minibatch.mbk_update_ref(bucket_sum(xb * wb[:, None], labels, k),
                                        bucket_sum(wb, labels, k), centers, counts)
        inertia = float((wb * best).double().sum())
        torch.cuda.synchronize()
        what = f"step {i}, window at {off}"
        torch.testing.assert_close(got[0], want[0], rtol=0,
                                   atol=1e-4 * float(want[0].abs().max()), msg=what)
        torch.testing.assert_close(got[1].sum(0), want[1].sum(0), rtol=TOL, atol=0, msg=what)
        assert abs(float(got[2]) - inertia) <= TOL * abs(inertia), (what, float(got[2]), inertia)
        centers, counts, _ = minibatch.mbk_epoch_ref(centers, counts, x, mask, off, bs, 1)
    assert minibatch.mbk_epoch.launches == launches + n_batches + 1
    assert minibatch.mbk_epoch.stepped == stepped


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 8, 9, 16])
@pytest.mark.parametrize("d", [1, 50, 64, 255])
@pytest.mark.parametrize("bs", [1, 7, 1023, 1024, 8192])
def test_mbk_epoch_edges(cuda, bs, d, k):
    # rows a CTA from 1 to past one unit (bs 8192: 512 rows, several units), and
    # windows that wrap: the start lies near the end of the padded rows.  From
    # centres drawn from the rows, each window a step; then the windows in one
    # launch (the step chain inside the kernel), from centres near the blobs'
    n = bs + 3 * bs // 2 + 11 + k
    x, mask, centers, counts = _mbk_inputs(n, d, k, bs + d + k, cuda, rows_init=True)
    _hold_mbk_steps(x, mask, centers, counts, n - 5, bs, 6)
    x, mask, centers, counts = _mbk_inputs(n, d, k, bs + d + k, cuda)
    _hold_mbk_epoch(x, mask, centers, counts, n - 5, bs, 6)


@pytest.mark.cuda
def test_mbk_epoch_many_steps(cuda):
    # 6000 steps in one launch: each owner CTA has one inbox for the step
    # partials, reused every step, so a push of a step's partials that
    # overtook the owner's reads of the step before would show here
    x, mask, centers, counts = _mbk_inputs(40_000, 50, 8, 11, cuda)
    _hold_mbk_epoch(x, mask, centers, counts, 123, 64, 6000)


def _hold_k10(x, y, kind, row0=0, col0=0, self_pairs=False, out=None):
    gamma = 1.0 / x.shape[1] if kind == "rbf" else None
    launches = pairwise.sq_euclidean_safe.launches
    got = pairwise.sq_euclidean_safe(x, y, row0, col0, self_pairs, kind, gamma, out=out)
    flagged = int(pairwise.sq_euclidean_safe.last_flagged)
    again = pairwise.sq_euclidean_safe(x, y, row0, col0, self_pairs, kind, gamma)
    want, want_flagged = pairwise.sq_euclidean_safe_ref(x, y, row0, col0, self_pairs, kind, gamma)
    torch.cuda.synchronize()
    assert pairwise.sq_euclidean_safe.launches == launches + 2
    assert torch.equal(got, again)
    assert flagged == int(want_flagged)
    g, w = got.double(), want.double()
    if kind == "euclid":
        g, w = g ** 2, w ** 2
    bound = TOL * _k10_scale(x, y) * (gamma if kind == "rbf" else 1.0)
    if kind == "rbf":  # and exp's own float32 rounding, two ulps of the value
        bound = bound + 2.0 ** -22 * w.abs()
    assert bool(((g - w).abs() <= bound + 1e-12).all())
    if self_pairs:
        ii = row0 + torch.arange(x.shape[0], device=x.device)[:, None]
        jj = col0 + torch.arange(y.shape[0], device=x.device)[None, :]
        assert bool((got[ii == jj] == 0).all())
    return got, flagged


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 50, 64, 65, 130])
@pytest.mark.parametrize("m", [1, 100, 129, 257])
def test_sq_euclidean_safe_widths(cuda, m, d):
    # the narrow tile (m <= 104), y staged once (m <= 128), y tiles streamed,
    # and the wide kernel past 64 features
    gen = torch.Generator(device=cuda).manual_seed(m * 1000 + d)
    x = torch.randn(1000, d, generator=gen, device=cuda)
    y = torch.randn(m, d, generator=gen, device=cuda)
    for kind in ("sq", "euclid", "rbf"):
        _hold_k10(x, y, kind)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m", [(128 * 265 + 5, 1024), (128 * 7 + 1, 300), (33_001, 100)])
def test_sq_euclidean_safe_tile_runs(cuda, n, m):
    # tile counts that do not divide by the CTA count (about two a SM), and
    # fewer tiles than CTAs; x one float past a 16-byte boundary
    gen = torch.Generator(device=cuda).manual_seed(n)
    flat = torch.randn(n * 50 + 1, generator=gen, device=cuda)
    x = flat[1:].view(n, 50)
    y = torch.randn(m, 50, generator=gen, device=cuda)
    _hold_k10(x, y, "sq")


@pytest.mark.cuda
@pytest.mark.parametrize("row0,col0,m", [(0, 300, 513), (77, 0, 200), (1000, 1130, 129)])
def test_sq_euclidean_safe_self_diagonal_crosses_bands(cuda, row0, col0, m):
    # a self block whose global diagonal crosses band and tile edges at
    # offsets that are not multiples of 128
    gen = torch.Generator(device=cuda).manual_seed(row0 + col0)
    big = torch.randn(2000, 50, generator=gen, device=cuda)
    x = big[row0:row0 + 700].contiguous()
    y = big[col0:col0 + m].contiguous()
    _hold_k10(x, y, "euclid", row0, col0, True)


@pytest.mark.cuda
@pytest.mark.parametrize("offset,m", [(100, 96), (7, 100), (3, 257)])
def test_sq_euclidean_safe_column_blocks(cuda, offset, m):
    # out a column block of a wider matrix, at an offset that takes 16-byte
    # stores (100) or does not (7, 3)
    gen = torch.Generator(device=cuda).manual_seed(offset + m)
    x = torch.randn(701, 50, generator=gen, device=cuda)
    y = torch.randn(m, 50, generator=gen, device=cuda)
    big = torch.full((701, offset + m + 50), -1.0, device=cuda)
    got, _ = _hold_k10(x, y, "sq", out=big[:, offset:offset + m])
    assert got.data_ptr() == big[:, offset:].data_ptr()
    assert bool((big[:, :offset] == -1).all()) and bool((big[:, offset + m:] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [50, 130])
def test_sq_euclidean_safe_repeats_in_the_last_band(cuda, d):
    # rows of y repeated in x's last, partial band: the exact recompute runs there
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn(1000, d, generator=gen, device=cuda) + 1e3
    y = torch.randn(100, d, generator=gen, device=cuda) + 1e3
    x[-7:] = y[:7]
    got, flagged = _hold_k10(x, y, "sq")
    assert flagged >= 7
    assert bool((got[-7:].gather(1, torch.arange(7, device=cuda)[:, None]) == 0).all())


# K12, K9 and K9b
from dask_ml_tpu_torch.ops import histogram, naive_bayes  # noqa: E402


def _window_inputs(n, d, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=device)
    if d >= 3:
        x[:, 1] = 3.0  # a constant column
        x[n // 2, 2] = 1e9  # an outlier
    mask = (torch.rand(n, generator=gen, device=device) > 0.05).float()
    lo = torch.where(mask[:, None] > 0, x, float("inf")).amin(0)
    hi = torch.where(mask[:, None] > 0, x, -float("inf")).amax(0)
    return x, mask, lo, hi


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(10_007, 28), (4_099, 130), (777, 1), (5, 3), (2_000_003, 7)])
@pytest.mark.parametrize("narrow", [False, True])
def test_hist_pass_counts_equal_the_plain_version(cuda, n, d, narrow):
    x, mask, lo, hi = _window_inputs(n, d, n + d, cuda)
    if narrow:
        mid, half = 0.5 * (lo + hi), 0.05 * (hi - lo)
        lo, hi = mid - half, mid + half
    width = torch.clamp_min(hi - lo, 1e-30)
    got = histogram.hist_pass_counts(x, mask, lo, hi, width)
    again = histogram.hist_pass_counts(x, mask, lo, hi, width)
    want = histogram.hist_pass_counts_ref(x, mask, lo, hi, width)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, c) and torch.equal(a, b)


def _nb_inputs(n, d, k, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=device) * 2 + 1
    labels = torch.randint(0, k, (n,), generator=gen, device=device, dtype=torch.int32)
    w = torch.rand(n, generator=gen, device=device) * 2
    w[torch.rand(n, generator=gen, device=device) < 0.1] = 0.0
    return x, labels, w


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(10_007, 28, 2), (10_007, 28, 10), (4_099, 130, 3),
                                   (777, 1, 2), (5, 3, 4), (3_001, 29, 100)])
def test_class_moments_match_the_plain_version(cuda, n, d, k):
    x, labels, w = _nb_inputs(n, d, k, n + k, cuda)
    got = naive_bayes.class_moments(x, labels, w, k)
    again = naive_bayes.class_moments(x, labels, w, k)
    counts, means, var = naive_bayes.class_moments_ref(x, labels, w, k)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    scale = naive_bayes.class_sums_ref(x.abs(), labels, w, k)[1]
    assert bool(((got[0] - counts).abs() <= TOL * counts.abs().max()).all())
    assert bool(((got[1] - means).abs() <= TOL * torch.maximum(means.abs(), scale)).all())
    assert bool(((got[2] - var).abs() <= TOL * var.abs().amax(1, keepdim=True)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(10_007, 28, 2), (10_007, 28, 10), (4_099, 130, 3),
                                   (777, 1, 2), (5, 3, 4), (1_001, 600, 7)])
def test_gaussian_jll_gives_the_plain_version_s_bits(cuda, n, d, k):
    x, _, _ = _nb_inputs(n, d, k, n + d, cuda)
    gen = torch.Generator(device=cuda).manual_seed(k)
    theta = torch.randn(k, d, generator=gen, device=cuda)
    var = torch.rand(k, d, generator=gen, device=cuda) + 0.5
    prior = torch.softmax(torch.randn(k, generator=gen, device=cuda), 0)
    for predict in (False, True):
        got = naive_bayes.gaussian_jll(x, theta, var, prior, predict)
        assert torch.equal(got, naive_bayes.gaussian_jll_ref(x, theta, var, prior, predict))


@pytest.mark.cuda
def test_preprocessing_and_nb_wrappers_count_their_launches(cuda):
    x, labels, w = _nb_inputs(1000, 5, 3, 0, cuda)
    lo, hi = x.amin(0), x.amax(0)
    counters = (histogram.hist_pass_counts, naive_bayes.class_sums,
                naive_bayes.class_deviations, naive_bayes.gaussian_jll)
    before = [f.launches for f in counters]
    histogram.hist_pass_counts(x, w, lo, hi, hi - lo)
    counts, means, var = naive_bayes.class_moments(x, labels, w, 3)
    naive_bayes.gaussian_jll(x, means, var + 1, counts / counts.sum())
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 1]
    naive_bayes.class_moments_ref(x, labels, w, 3)
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1, 1]
