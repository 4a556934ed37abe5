"""The Lloyd kernels against their plain versions, on a card.

The kernels are CUDA C++ with no CPU mode, so these tests skip without a
card and ``nvcc``.  They import neither JAX nor the reference, so on a
machine with a card and without JAX they run as
``python -m pytest --noconftest -m cuda tests/test_torch_kernels.py``.

Tolerance: float32 with another summation order, so sums agree to 1e-5
of each cluster's Σ|mask·x| and inertia to rtol 1e-5 (both against the
plain reduce taken in float64, since float32 atomics carry an error of
that size themselves), and d² to 1e-5 of ‖x‖²+‖c‖²; a label may differ
only where the two smallest d² are that close.
"""

import shutil

import pytest
import torch

from dask_ml_tpu_torch.ops import lloyd
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


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(50, 8), (64, 64), (3, 1000), (130, 9), (130, 300)])
def test_kernels_match_plain_versions(cuda, d, k):
    n = 10_007  # not a multiple of the 256-row tile
    x, mask, centers, cvalid = _inputs(n, d, k, d * k, cuda)
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
    for cv in (None, cvalid):
        kl, kd2, ki = lloyd.lloyd_assign(x, mask, centers, cv)
        rl, rd2, ri2 = lloyd.lloyd_assign_ref(x, mask, centers, cv)
        torch.testing.assert_close(ki, ri2, rtol=TOL, atol=0)
        scale = (x * x).sum(1) + (centers * centers).sum(1).max()
        assert bool(((kd2 - rd2).abs() <= TOL * scale).all())
        assert _label_ok(kl, rl, x, centers, cv)
    torch.cuda.synchronize()


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
