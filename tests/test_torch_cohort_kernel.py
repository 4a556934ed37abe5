"""K5 (``csrc/cohort.cu``: one SGD step of M models that share a block)
against its plain version, on a card.

The kernel is CUDA C++ with no CPU mode, so these tests skip without a
card and ``nvcc``.  They import neither JAX nor the reference, so on a
machine with a card and without JAX they run as
``python -m pytest --noconftest -m cuda tests/test_torch_cohort_kernel.py``.

Tolerance, lane by lane as ``test_torch_sgd_kernel.py`` holds K4: the plain
version is taken in float64 on the same inputs; each lane's mean loss and
Σ mask agree to rtol 1e-5, its updated coef and intercept to
1e-5·eta·max|g| plus 2^-22 of each element (the float32 rounding of the
stored c − eta·g), t exactly; hinge's rows within 1e-5 of its kink may take
the other side, each moving the gradient by at most mask·|x|/count.  The
kernel is deterministic: a repeat gives the same bits.  At M = 1 it is
also held against K4's ``sgd_update`` on the same inputs.
"""

import shutil

import pytest
import torch

from dask_ml_tpu_torch.ops import cohort, sgd

TOL = 1e-5
CLS = ("log_loss", "hinge", "squared_hinge", "modified_huber")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or shutil.which("nvcc") is None:
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, d, K, M, loss, seed, device, weighted=False, scale=1.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, d, generator=gen, device=device)
    if loss in CLS:
        idx = torch.randint(0, max(K, 2), (B,), generator=gen, device=device)
        y = (2.0 * torch.nn.functional.one_hot(idx, max(K, 2)).float() - 1.0)[:, -K:]
    else:
        y = torch.randn(B, 1, generator=gen, device=device) * 2
    mask = 2.0 * torch.rand(B, generator=gen, device=device)
    mask[torch.rand(B, generator=gen, device=device) < 0.1] = 0.0
    if weighted:
        masks = (mask[None] * (0.5 + torch.rand(M, 1, generator=gen, device=device))).contiguous()
        masks[M // 2] = 0.0
    else:
        masks = mask[None].expand(M, B)
    coef = scale * torch.randn(M, d, K, generator=gen, device=device) / d ** 0.5
    intercept = 0.1 * torch.randn(M, K, generator=gen, device=device)
    t = 3.0 + torch.arange(M, device=device, dtype=torch.float32)
    alpha = torch.logspace(-5, -2, M, device=device)
    eta0 = torch.linspace(0.01, 0.05, M, device=device)
    hypers = torch.stack([alpha, eta0, torch.full_like(alpha, 0.25), 1.0 / (alpha * eta0),
                          torch.full_like(alpha, 0.15), torch.linspace(0.1, 0.5, M, device=device),
                          torch.full_like(alpha, 0.2)], 1).contiguous()
    return x, y.contiguous(), masks, coef, intercept, t, hypers


def _hold(case, loss, penalty="l2", schedule="optimal", fit_intercept=True):
    x, y, masks, coef, intercept, t, hypers = case
    d64 = torch.float64
    c64, b64, t64, h64 = coef.to(d64), intercept.to(d64), t.to(d64), hypers.to(d64)
    out64 = torch.empty((masks.shape[0], 2), dtype=d64, device=x.device)
    kw = dict(loss=loss, penalty=penalty, schedule=schedule, fit_intercept=fit_intercept)
    cohort.cohort_step_ref(x.to(d64), y.to(d64), masks.to(d64), c64, b64, t64, h64, out=out64,
                           **kw)
    runs = []
    for _ in range(2):
        c, b, tt = coef.clone(), intercept.clone(), t.clone()
        runs.append((c, b, tt, cohort.cohort_step(x, y, masks, c, b, tt, hypers, **kw)))
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(*runs))
    c, b, tt, out = runs[0]
    eta = sgd.learning_rate(schedule, t.to(d64), h64.T)
    g = torch.cat([(coef.to(d64) - c64).flatten(1), intercept.to(d64) - b64], 1) / eta[:, None]
    allow = torch.zeros_like(eta)
    if loss == "hinge":
        z = y.to(d64)[None] * (torch.matmul(x.to(d64), coef.to(d64)) + intercept.to(d64)[:, None])
        near = ((z - 1.0).abs() <= 1e-5 * (1.0 + z.abs())) & (masks[:, :, None] > 0)
        count = torch.clamp(out64[:, 1], min=1.0)
        allow = eta * near.flatten(1).sum(1) * float(masks.max()) * float(x.abs().max()) / count
    for got, want in ((c.flatten(1), c64.flatten(1)), (b, b64)):
        tol = (TOL * eta * g.abs().amax(1) + allow)[:, None] + 2.0 ** -22 * want.abs()
        assert bool(((got.to(d64) - want).abs() <= tol).all())
    assert torch.equal(tt.to(d64), t64)
    assert bool(((out.to(d64) - out64).abs() <= TOL * out64.abs()).all())
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3, 10])
@pytest.mark.parametrize("M", [1, 2, 5, 34, 81])
@pytest.mark.parametrize("loss", CLS)
def test_classifier_losses_against_plain(cuda, loss, M, K):
    _hold(_inputs(4099, 64, K, M, loss, M * 10 + K, cuda), loss)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["squared_error", "huber"])
@pytest.mark.parametrize("d", [1, 64, 130])
def test_regression_losses_and_widths_against_plain(cuda, loss, d):
    _hold(_inputs(2053, d, 1, 9, loss, d, cuda, scale=3.0), loss)


@pytest.mark.cuda
@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("schedule", ["constant", "optimal", "invscaling", "adaptive"])
@pytest.mark.parametrize("penalty", ["l2", "l1", "elasticnet", None])
def test_penalties_and_schedules_against_plain(cuda, penalty, schedule, fit_intercept):
    _hold(_inputs(1031, 20, 3, 7, "log_loss", 5, cuda, weighted=True), "log_loss", penalty,
          schedule, fit_intercept)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 37, 64, 65])
def test_short_blocks_and_wide_cohorts_against_plain(cuda, B):
    _hold(_inputs(B, 64, 10, 81, "modified_huber", B, cuda, weighted=True), "modified_huber")


@pytest.mark.cuda
def test_strided_rows_margins_past_80_and_one_lane_like_k4(cuda):
    x, y, masks, coef, intercept, t, hypers = _inputs(65536, 64, 1, 9, "log_loss", 3, cuda,
                                                      scale=60.0)
    view = (x[5::16], y[5::16], masks[:, 5::16], coef, intercept, t, hypers)
    _hold(view, "log_loss")
    one = _inputs(3001, 130, 3, 1, "hinge", 4, cuda)
    c5 = _hold(one, "hinge", penalty="elasticnet")
    x, y, masks, coef, intercept, t, hypers = one
    c4, b4, t4 = coef[0].clone(), intercept[0].clone(), t[0].clone()
    sgd.sgd_update(x, y, masks[0], c4, b4, t4, hypers[0], loss="hinge", penalty="elasticnet",
                   schedule="optimal")
    eta = float(sgd.learning_rate("optimal", t[0].double(), hypers[0].double()))
    g = float((coef[0].double() - c4.double()).abs().max()) / eta
    assert float((c4 - c5[0]).abs().max()) <= 2 * (TOL * eta * g + 2.0 ** -22 * float(
        c4.abs().max()))


# The ring path's rows a tile (csrc/cohort.cu RING_R) and its column tiles:
# CT = 4 at M*K <= 4, 8 at <= 8, 12 at <= 12, else 16, tiled across the
# grid past 16
RING_R = 128
EDGE_COHORTS = [(4, 1), (5, 1), (8, 1), (9, 1), (12, 1), (13, 1), (16, 1), (17, 1), (2, 2),
                (4, 2), (3, 3), (4, 3), (8, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", EDGE_COHORTS)
def test_column_tile_edges_against_plain(cuda, M, K):
    _hold(_inputs(4099, 64, K, M, "log_loss", 40 + M * K, cuda), "log_loss")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 9])
@pytest.mark.parametrize("B", [RING_R - 1, RING_R, RING_R + 1])
def test_ragged_tiles_against_plain(cuda, B, M):
    _hold(_inputs(B, 64, 1, M, "hinge", B + M, cuda), "hinge")


@pytest.mark.cuda
@pytest.mark.parametrize("M", [3, 8, 11])
def test_one_row_past_the_grids_tiles_against_plain(cuda, M):
    # every block takes two tiles and one block one more, of one row
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _hold(_inputs(2 * sms * RING_R + 1, 64, 1, M, "log_loss", M, cuda), "log_loss")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 63, 64, 65, 130])
@pytest.mark.parametrize("M", [2, 5, 9])
def test_widths_against_plain(cuda, d, M):
    _hold(_inputs(3001, d, 1, M, "modified_huber", d + M, cuda), "modified_huber")


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(3, 1), (6, 1), (13, 1), (27, 1), (4, 3)])
def test_strided_rows_and_lane_masks_with_a_zero_lane_against_plain(cuda, M, K):
    x, y, masks, coef, intercept, t, hypers = _inputs(4 * 2053, 64, K, M, "log_loss", 70 + M,
                                                      cuda, weighted=True)
    assert bool((masks[M // 2] == 0).all())
    _hold((x[1::4], y[1::4], masks[:, 1::4], coef, intercept, t, hypers), "log_loss")


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [0, 1])
def test_more_column_tiles_than_resident_blocks_against_plain(cuda, extra):
    # the ring path's cooperative grid takes a block at least a column tile
    # of 16 and holds two blocks a SM: one column more than that takes the
    # tile path, not a cooperative launch the card cannot hold
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    M = 16 * 2 * sms + extra
    _hold(_inputs(300, 64, 1, M, "log_loss", 11 + extra, cuda), "log_loss")
