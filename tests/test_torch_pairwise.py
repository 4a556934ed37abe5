"""The port's ``metrics/pairwise.py`` against the JAX reference's, on the CPU:
the reference on its 8 virtual devices, the port at 8 logical shards, the
same numpy inputs (made from a seed) for both.

Tolerances (float32 on both sides, other summation orders):
- d² within 1e-5·(‖x−a‖²+‖y−a‖²) entrywise, a the reference's anchor
  0.5·(mean x + mean y): the expansion's rounding is a few float32 ulps of
  that scale, whichever package computes it.  √d² is held through its
  square, exp(−γd²) to 1e-5·γ·(‖x−a‖²+‖y−a‖²).
- Entries the guard recomputes equal the exact Σ(x−y)², taken in float64
  from the same float32 inputs, to rtol 1e-5 (the recompute's own float32
  rounding over d ≤ 12 terms), and exactly 0 for repeated rows.
- A self call's diagonal is exactly 0.
- The ring equals the plain call within the d² tolerance (each ring step
  centres on its own anchor).
- ``pairwise_distances_argmin_min``: indices equal off near-ties (two
  smallest d² within 1e-5 of ‖x‖²+‖y‖²), distances within 1e-5 relative.
- The kernel functions (products, no guard) within 1e-5 of their largest
  magnitude.
"""

import numpy as np
import pytest
import torch

from dask_ml_tpu.core import shard_rows as ref_shard_rows
from dask_ml_tpu.metrics import pairwise as ref
from dask_ml_tpu_torch.core import mesh, shard_rows
from dask_ml_tpu_torch.metrics import pairwise as port
from dask_ml_tpu_torch.ops import pairwise as k10

TOL = 1e-5


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


def _data(seed, n=203, m=57, d=12, offset=0.0):
    rng = np.random.RandomState(seed)
    x = (rng.normal(size=(n, d)) * 2 + offset).astype(np.float32)
    y = (rng.normal(size=(m, d)) * 2 + offset).astype(np.float32)
    return x, y


def _near_duplicates(seed, n=150, m=40, d=6, offset=1e3):
    """Rows with a large common offset, a quarter of y repeating rows of x
    and a quarter within 1e-2 of one: the guard must recompute them."""
    x, y = _data(seed, n, m, d, offset)
    rng = np.random.RandomState(seed + 100)
    pick = rng.choice(n, m // 2, replace=False)
    y[: m // 4] = x[pick[: m // 4]]
    y[m // 4: m // 2] = x[pick[m // 4:]] + rng.uniform(-1e-2, 1e-2, (m // 2 - m // 4, d))
    return x, y


def _scale(x, y):
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    a = 0.5 * (x64.mean(0) + y64.mean(0))
    return ((x64 - a) ** 2).sum(1)[:, None] + ((y64 - a) ** 2).sum(1)[None, :]


def _exact(x, y):
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    return ((x64[:, None, :] - y64[None, :, :]) ** 2).sum(-1)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_sq_close(got, want, scale):
    gap = np.abs(_np(got).astype(np.float64) - _np(want).astype(np.float64))
    assert (gap <= TOL * scale).all(), float((gap / scale).max())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("squared", [True, False])
def test_euclidean_distances_match_reference(seed, squared):
    x, y = _data(seed)
    got = port.euclidean_distances(x, y, squared=squared)
    assert int(k10.sq_euclidean_safe.last_flagged) == 0  # well separated: the fast path
    want = ref.euclidean_distances(x, y, squared=squared)
    assert tuple(got.shape) == (203, 57) and got.dtype == torch.float32
    if not squared:
        got, want = _np(got) ** 2, _np(want) ** 2
    _assert_sq_close(got, want, _scale(x, y))
    _assert_sq_close(got, _exact(x, y), _scale(x, y))


@pytest.mark.parametrize("seed", [0, 3])
def test_flagged_entries_are_the_exact_sum(seed):
    x, y = _near_duplicates(seed)
    got = _np(port.euclidean_distances(x, y, squared=True)).astype(np.float64)
    flagged = int(k10.sq_euclidean_safe.last_flagged)
    want = np.asarray(ref.euclidean_distances(x, y, squared=True)).astype(np.float64)
    exact, scale = _exact(x, y), _scale(x, y)
    sure = exact < 0.5 * k10.SAFE_TAU * scale  # flagged in either package
    assert flagged >= sure.sum() >= 20
    for side in (got, want):
        np.testing.assert_allclose(side[sure], exact[sure], rtol=TOL, atol=0)
        assert (side[exact == 0] == 0).all()
    _assert_sq_close(got, want, scale)


@pytest.mark.parametrize("offset", [0.0, 1e3])
def test_self_call_diagonal_is_zero(offset):
    # 200 rows: no pad rows, whose zeros would pull a ring step's anchor
    # off data at a large offset (in both packages)
    x, _ = _data(2, n=200, offset=offset)
    got = _np(port.euclidean_distances(x))
    assert (np.diag(got) == 0).all()
    assert int(k10.sq_euclidean_safe.last_flagged) == 0  # the diagonal is not recomputed
    want = np.asarray(ref.euclidean_distances(x))
    _assert_sq_close(got ** 2, want ** 2, _scale(x, x))
    sx = shard_rows(x)
    ring = _np(port.euclidean_distances(sx, sx))
    assert ring.shape == (200, 200) and (np.diag(ring) == 0).all()
    _assert_sq_close(ring ** 2, got ** 2, _scale(x, x))
    rbf = _np(port.rbf_kernel(sx, sx))
    assert (np.diag(rbf) == 1).all()


@pytest.mark.parametrize("kind", ["sq", "euclid", "rbf", "cosine", "manhattan", "linear",
                                  "polynomial"])
def test_ring_equals_plain_call_and_reference(kind):
    x, y = _near_duplicates(4, n=203, m=61, offset=0.0)
    sx, sy = shard_rows(x), shard_rows(y)
    rx, ry = ref_shard_rows(x), ref_shard_rows(y)
    calls = {
        "sq": lambda mod, a, b: mod.euclidean_distances(a, b, squared=True),
        "euclid": lambda mod, a, b: mod.euclidean_distances(a, b),
        "rbf": lambda mod, a, b: mod.rbf_kernel(a, b, gamma=0.05),
        "cosine": lambda mod, a, b: mod.pairwise_distances(a, b, metric="cosine"),
        "manhattan": lambda mod, a, b: mod.pairwise_distances(a, b, metric="manhattan"),
        "linear": lambda mod, a, b: mod.linear_kernel(a, b),
        "polynomial": lambda mod, a, b: mod.polynomial_kernel(a, b, degree=2),
    }[kind]
    ring = _np(calls(port, sx, sy)).astype(np.float64)
    plain = _np(calls(port, x, y)).astype(np.float64)
    want = np.asarray(calls(ref, rx, ry)).astype(np.float64)
    assert ring.shape == plain.shape == want.shape == (203, 61)
    scale = _scale(x, y)
    if kind == "euclid":
        ring, plain, want = ring ** 2, plain ** 2, want ** 2
    if kind in ("sq", "euclid"):
        bound = TOL * scale
    elif kind == "rbf":
        bound = TOL * 0.05 * scale
    else:
        bound = TOL * np.abs(want).max()
    assert (np.abs(ring - plain) <= bound).all()
    assert (np.abs(ring - want) <= bound).all()


def test_callable_metric_runs_once_on_the_whole_operands():
    x, y = _data(5)
    seen = []

    def l_inf(a, b):
        seen.append((tuple(a.shape), tuple(b.shape)))
        return (a[:, None, :] - b[None, :, :]).abs().amax(-1)

    got = port.pairwise_distances(shard_rows(x), y, metric=l_inf)
    want = ref.pairwise_distances(ref_shard_rows(x), y,
                                  metric=lambda a, b: np.abs(np.asarray(a)[:, None, :]
                                                             - np.asarray(b)[None]).max(-1))
    assert seen == [((208, 12), (57, 12))]  # the padded rows, once
    assert tuple(got.shape) == (203, 57)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=0)
    with pytest.raises(ValueError, match="Unsupported metric"):
        port.pairwise_distances(x, y, metric="chebyshev")


@pytest.mark.parametrize("name", ["linear", "polynomial", "rbf", "sigmoid"])
@pytest.mark.parametrize("gamma", [None, 0.3])
def test_kernel_functions_match_reference(name, gamma):
    assert sorted(port.PAIRWISE_KERNEL_FUNCTIONS) == sorted(ref.PAIRWISE_KERNEL_FUNCTIONS)
    x, y = _data(6)
    x, y = x / 3, y / 3
    kw = {} if name == "linear" else {"gamma": gamma}
    for Y in (y, None):
        got = _np(port.PAIRWISE_KERNEL_FUNCTIONS[name](x, Y, **kw)).astype(np.float64)
        want = np.asarray(ref.PAIRWISE_KERNEL_FUNCTIONS[name](x, Y, **kw)).astype(np.float64)
        assert got.shape == want.shape
        if name == "rbf":
            g = 1.0 / x.shape[1] if gamma is None else gamma
            assert (np.abs(got - want) <= TOL * g * _scale(x, x if Y is None else y)).all()
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("seed", [0, 7])
def test_argmin_min_matches_reference(seed):
    x, y = _data(seed, n=501, m=33)
    idx, dist = port.pairwise_distances_argmin_min(shard_rows(x), y)
    ridx, rdist = ref.pairwise_distances_argmin_min(ref_shard_rows(x), y)
    idx, ridx = _np(idx), np.asarray(ridx)
    assert idx.shape == (501,) and idx.dtype == np.int64
    d2 = _exact(x, y)
    two = np.sort(d2, axis=1)[:, :2]
    tie = (two[:, 1] - two[:, 0]) < TOL * ((x.astype(np.float64) ** 2).sum(1)
                                           + (y.astype(np.float64) ** 2).sum(1)[ridx])
    assert not ((idx != ridx) & ~tie).any()
    np.testing.assert_allclose(_np(dist), np.asarray(rdist), rtol=TOL)


def test_plain_version_keeps_its_cube_bound(monkeypatch):
    """The exact recompute runs over row chunks sized by the (rows, m, d)
    cube; a bound of one row gives the same entries."""
    x, y = _near_duplicates(8)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    whole, flagged = k10.sq_euclidean_safe_ref(xt, yt)
    monkeypatch.setattr(k10, "_CUBE", 1)
    rows, flagged_rows = k10.sq_euclidean_safe_ref(xt, yt)
    assert int(flagged) == int(flagged_rows) > 0
    assert torch.equal(whole, rows)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_fills_out():
    x, y = _data(9, n=40, m=10)
    before = k10.sq_euclidean_safe.launches
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    big = torch.full((40, 30), -1.0)
    out = k10.sq_euclidean_safe(xt, yt, kind="euclid", out=big[:, 5:15])
    assert k10.sq_euclidean_safe.launches == before  # nothing launched on the CPU
    want, _ = k10.sq_euclidean_safe_ref(xt, yt, kind="euclid")
    assert torch.equal(out, want) and torch.equal(big[:, 5:15], want)
    assert (big[:, :5] == -1).all() and (big[:, 15:] == -1).all()
    with pytest.raises(ValueError, match="gamma"):
        k10.sq_euclidean_safe(xt, yt, kind="rbf")
    with pytest.raises(TypeError, match="float32"):
        k10.sq_euclidean_safe(xt.double(), yt)
