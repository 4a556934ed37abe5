"""K4 (``csrc/sgd.cu``: the SGD step, its value-only variant and the epoch)
against its plain version, on a card.

The kernel is CUDA C++ with no CPU mode, so these tests skip without a
card and ``nvcc``.  They import neither JAX nor the reference, so on a
machine with a card and without JAX they run as
``python -m pytest --noconftest -m cuda tests/test_torch_sgd_kernel.py``.

Tolerance: the plain version is taken in float64 on the same inputs; the
mean loss and Σ mask agree to rtol 1e-5, the updated coef and intercept to
1e-5·eta·max|g| plus 2^-22 of each element (the float32 rounding of the
stored c − eta·g), t exactly; hinge's rows within 1e-5 of its kink may
take the other side, each moving the gradient by at most mask·|x|/count.
The kernel is deterministic: a repeat gives the same bits.

At K = 1 and d <= 256 a step, and the loss alone, is one launch
(``step_kernel``: the rows streamed through a ring of tiles, the records
summed and the update applied by the last block to finish); its plan names
that path (plan word 0 is 3) and each launch leaves the device's ticket at
0.  It is held as above at row counts past and short of a tile, every width
of its two layouts, each loss, penalty and schedule, row-strided views
(16-byte copies) and rows off a 16-byte boundary (4-byte copies).

The epoch (``sgd_epoch``, n_mb steps in one launch) is held against the
plain version's steps in float64 from the same state: each step's loss and
Σ mask to rtol 1e-5, and the final coef and intercept to 1e-5 times the
sum over the steps of eta·max|g| (each step's own tolerance, summed), plus
2^-22 of each element a step, with the hinge allowance of each step;
t exactly.  The tensor-core path (K in 2..16, d <= 256) is held by the
step's tolerance at every K and d of its layout's edges.

K5′ (``ops/ensemble.py :: group_step``: ``sgd_group_step`` in the same
source, an ensemble's M steps in one launch, each member on its own window
of x) is held the same way a member at a time, on ragged windows with an
all-padding member, at widths of all three of its paths.
"""

import shutil

import pytest
import torch

from dask_ml_tpu_torch.ops import sgd

TOL = 1e-5
CLS = ("log_loss", "hinge", "squared_hinge", "modified_huber")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available() or shutil.which("nvcc") is None:
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, d, K, loss, seed, device, scale=1.0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, d, generator=gen, device=device)
    if loss in CLS:
        idx = torch.randint(0, max(K, 2), (B,), generator=gen, device=device)
        y = (2.0 * torch.nn.functional.one_hot(idx, max(K, 2)).float() - 1.0)[:, -K:]
    else:
        y = torch.randn(B, 1, generator=gen, device=device) * 2
    mask = 2.0 * torch.rand(B, generator=gen, device=device)
    mask[torch.rand(B, generator=gen, device=device) < 0.1] = 0.0
    coef = scale * torch.randn(d, K, generator=gen, device=device) / d ** 0.5
    intercept = 0.1 * torch.randn(K, generator=gen, device=device)
    return x, y.contiguous(), mask, coef, intercept


def _hyper(device, eta_scale=1.0):
    return torch.tensor([1e-3, 0.05, 0.25, 2e4, 0.15, 0.3, eta_scale], device=device)


def _hinge_allowance(x, y, mask, coef, intercept, eta, count):
    """What rows within 1e-5 of hinge's kink may move the update by."""
    f64 = torch.float64
    z = y.to(f64) * (x.to(f64) @ coef.to(f64) + intercept.to(f64))
    near = ((z - 1.0).abs() <= 1e-5 * (1.0 + z.abs())) & (mask[:, None] > 0)
    return eta * int(near.sum()) * float(mask.max()) * float(x.abs().max()) / max(count, 1.0)


def _hold(x, y, mask, coef, intercept, hyper, loss, penalty="l2", schedule="optimal",
          fit_intercept=True):
    f64 = torch.float64
    t0 = torch.tensor(7.0, device=x.device)
    c64, b64, t64 = coef.to(f64), intercept.to(f64), t0.to(f64)
    out64 = torch.empty(2, dtype=f64, device=x.device)
    sgd.sgd_update_ref(x.to(f64), y.to(f64), mask.to(f64), c64, b64, t64, hyper.to(f64),
                       loss=loss, penalty=penalty, schedule=schedule,
                       fit_intercept=fit_intercept, out=out64)
    before = sgd.sgd_update.launches
    runs = []
    for _ in range(2):
        c, b, t = coef.clone(), intercept.clone(), t0.clone()
        out = sgd.sgd_update(x, y, mask, c, b, t, hyper, loss=loss, penalty=penalty,
                             schedule=schedule, fit_intercept=fit_intercept)
        runs.append((c, b, t, out))
    assert sgd.sgd_update.launches == before + 2
    (c, b, t, out), (c2, b2, t2, out2) = runs
    assert torch.equal(c, c2) and torch.equal(b, b2) and torch.equal(out, out2)
    eta = float(sgd.learning_rate(schedule, t0.to(f64), hyper.to(f64)))
    g = torch.cat([(coef.to(f64) - c64).flatten(), (intercept.to(f64) - b64).flatten()]) / eta
    allow = 0.0
    if loss == "hinge":
        allow = _hinge_allowance(x, y, mask, coef, intercept, eta, float(out64[1]))
    for got, want in ((c, c64), (b, b64)):
        tol = TOL * eta * float(g.abs().max()) + 2.0 ** -22 * want.abs() + allow
        assert bool(((got.to(f64) - want).abs() <= tol).all())
    assert float(t) == float(t64) == 8.0
    lo = sgd.sgd_loss(x, y, mask, coef, intercept, hyper, loss=loss)
    for o in (out, lo):
        torch.testing.assert_close(o.to(f64), out64, rtol=TOL, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3, 10, 100])
@pytest.mark.parametrize("loss", CLS)
def test_classifier_losses_against_plain(cuda, loss, K):
    _hold(*_inputs(50_003, 64, K, loss, K, cuda), _hyper(cuda), loss)


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["squared_error", "huber"])
@pytest.mark.parametrize("d", [1, 28, 64, 130, 2000])
def test_regression_losses_and_widths_against_plain(cuda, loss, d):
    _hold(*_inputs(3001, d, 1, loss, d, cuda), _hyper(cuda), loss, penalty="elasticnet")


@pytest.mark.cuda
@pytest.mark.parametrize("penalty, schedule, fit_intercept", [
    (None, "constant", True), ("l1", "invscaling", True), ("elasticnet", "adaptive", False),
    ("l2", "optimal", False)])
def test_penalties_and_schedules_against_plain(cuda, penalty, schedule, fit_intercept):
    hyper = _hyper(cuda, 0.2 if schedule == "adaptive" else 1.0)
    _hold(*_inputs(4097, 130, 3, "log_loss", 3, cuda), hyper, "log_loss", penalty=penalty,
          schedule=schedule, fit_intercept=fit_intercept)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 37, 256])
def test_short_blocks_against_plain(cuda, B):
    _hold(*_inputs(B, 64, 10, "modified_huber", B, cuda), _hyper(cuda), "modified_huber")


@pytest.mark.cuda
def test_margins_past_80_and_strided_minibatch_against_plain(cuda):
    _hold(*_inputs(20_000, 64, 1, "log_loss", 5, cuda, scale=60.0), _hyper(cuda), "log_loss")
    x, y, mask, coef, intercept = _inputs(16 * 512, 64, 3, "hinge", 6, cuda)
    views = (x.view(-1, 16, 64)[:, 5], y.view(-1, 16, 3)[:, 5], mask.view(-1, 16)[:, 5])
    _hold(*views, coef, intercept, _hyper(cuda), "hinge")


@pytest.mark.cuda
def test_all_zero_mask_gives_count_one_and_no_nan(cuda):
    x, y, _, coef, intercept = _inputs(1000, 8, 1, "log_loss", 1, cuda)
    t = torch.tensor(0.0, device=cuda)
    c = coef.clone()
    out = sgd.sgd_update(x, y, torch.zeros(1000, device=cuda), c, intercept.clone(), t,
                         _hyper(cuda), loss="log_loss", penalty=None, schedule="constant")
    assert out.tolist() == [0.0, 0.0] and torch.equal(c, coef) and float(t) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 31, 257, 4097, 2 ** 18 + 13])
@pytest.mark.parametrize("d", [1, 3, 64, 65, 256])
def test_one_launch_step_rows_and_widths_against_plain(cuda, B, d):
    _hold(*_inputs(B, d, 1, "log_loss", B + d, cuda), _hyper(cuda), "log_loss")
    dev = torch.device("cuda", torch.cuda.current_device())
    plan, _ = sgd._plan(sgd._load(), dev, sgd.LOSSES["log_loss"], B, d, 1)
    assert plan[0] == 3
    assert int(sgd._ticket(dev)[0]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("loss", CLS + ("squared_error", "huber"))
@pytest.mark.parametrize("penalty, schedule", [
    (None, "constant"), ("l2", "optimal"), ("l1", "invscaling"), ("elasticnet", "adaptive")])
def test_one_launch_step_losses_penalties_schedules_against_plain(cuda, loss, penalty,
                                                                   schedule):
    hyper = _hyper(cuda, 0.2 if schedule == "adaptive" else 1.0)
    _hold(*_inputs(20_011, 64, 1, loss, 9, cuda), hyper, loss, penalty=penalty,
          schedule=schedule)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 64, 65, 256])
def test_one_launch_step_strided_and_unaligned_rows_against_plain(cuda, d):
    x, y, mask, coef, intercept = _inputs(16 * 1031, d, 1, "hinge", d, cuda)
    views = (x.view(-1, 16, d)[:, 5], y.view(-1, 16, 1)[:, 5], mask.view(-1, 16)[:, 5])
    _hold(*views, coef, intercept, _hyper(cuda), "hinge", penalty="elasticnet")
    wide = torch.zeros(9001, d + 4, device=cuda)  # rows start 4 bytes past a 16-byte boundary
    wide[:, 1:d + 1] = x[:9001]
    _hold(wide[:, 1:d + 1], y[:9001], mask[:9001], coef, intercept, _hyper(cuda), "hinge")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1000, 2 ** 18 + 13])
def test_one_launch_step_all_zero_mask(cuda, B):
    x, y, _, coef, intercept = _inputs(B, 64, 1, "log_loss", 2, cuda)
    zero = torch.zeros(B, device=cuda)
    t = torch.tensor(0.0, device=cuda)
    c, b = coef.clone(), intercept.clone()
    out = sgd.sgd_update(x, y, zero, c, b, t, _hyper(cuda), loss="log_loss", penalty=None,
                         schedule="constant")
    lo = sgd.sgd_loss(x, y, zero, coef, intercept, _hyper(cuda), loss="log_loss")
    assert out.tolist() == [0.0, 0.0] and lo.tolist() == [0.0, 0.0]
    assert torch.equal(c, coef) and torch.equal(b, intercept) and float(t) == 1.0


def _hold_epoch(xs, ys, ms, coef, intercept, hyper, loss, penalty="l2", schedule="optimal",
                fit_intercept=True):
    f64 = torch.float64
    n_mb = xs.shape[1]
    t0 = torch.tensor(7.0, device=xs.device)
    c64, b64, t64 = coef.to(f64), intercept.to(f64), t0.to(f64)
    h64 = hyper.to(f64)
    out64 = torch.empty((n_mb, 2), dtype=f64, device=xs.device)
    moves = allow = 0.0
    for i in range(n_mb):
        before = torch.cat([c64.flatten(), b64.flatten()])
        eta = float(sgd.learning_rate(schedule, t64, h64))
        if loss == "hinge":
            allow += _hinge_allowance(xs[:, i], ys[:, i], ms[:, i], c64, b64, eta,
                                      float(ms[:, i].sum()))
        sgd.sgd_update_ref(xs[:, i].to(f64), ys[:, i].to(f64), ms[:, i].to(f64), c64, b64, t64,
                           h64, loss=loss, penalty=penalty, schedule=schedule,
                           fit_intercept=fit_intercept, out=out64[i])
        moves += float((torch.cat([c64.flatten(), b64.flatten()]) - before).abs().max())
    before = (sgd.sgd_epoch.launches, sgd.sgd_update.launches)
    runs = []
    for _ in range(2):
        c, b, t = coef.clone(), intercept.clone(), t0.clone()
        out = sgd.sgd_epoch(xs, ys, ms, c, b, t, hyper, loss=loss, penalty=penalty,
                            schedule=schedule, fit_intercept=fit_intercept)
        runs.append((c, b, t, out))
    assert (sgd.sgd_epoch.launches, sgd.sgd_update.launches) == (before[0] + 2, before[1])
    (c, b, t, out), (c2, b2, t2, out2) = runs
    assert torch.equal(c, c2) and torch.equal(b, b2) and torch.equal(out, out2)
    for got, want in ((c, c64), (b, b64)):
        tol = TOL * moves + n_mb * 2.0 ** -22 * want.abs() + allow
        assert bool(((got.to(f64) - want).abs() <= tol).all())
    assert float(t) == float(t64) == 7.0 + n_mb
    torch.testing.assert_close(out.to(f64), out64, rtol=TOL, atol=0.0)
    return out


def _stacks(B, n_mb, d, K, loss, seed, device, scale=1.0):
    x, y, mask, coef, intercept = _inputs(B * n_mb, d, K, loss, seed, device, scale)
    return (x.view(B, n_mb, d), y.view(B, n_mb, K), mask.view(B, n_mb), coef, intercept)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 33, 64, 256])
@pytest.mark.parametrize("K", [2, 4, 10, 16])
def test_tensor_core_path_against_plain(cuda, K, d):
    _hold(*_inputs(10_007, d, K, "log_loss", K + d, cuda), _hyper(cuda), "log_loss")


@pytest.mark.cuda
@pytest.mark.parametrize("n_mb, B, d, K, loss, penalty, schedule", [
    (2, 4096, 64, 1, "log_loss", "l2", "optimal"),
    (16, 4096, 64, 1, "hinge", "elasticnet", "invscaling"),
    (3, 1001, 200, 1, "huber", "l1", "constant"),
    (16, 4096, 64, 10, "log_loss", "l2", "optimal"),
    (2, 1003, 33, 4, "modified_huber", None, "constant"),
    (4, 777, 256, 16, "squared_hinge", "l2", "invscaling"),
    (2, 513, 1, 2, "hinge", "l1", "optimal"),
    (3, 1000, 300, 1, "squared_error", "elasticnet", "optimal"),  # the row path
    (2, 500, 64, 20, "log_loss", "l2", "optimal"),                # the row path
])
def test_epoch_against_plain(cuda, n_mb, B, d, K, loss, penalty, schedule):
    _hold_epoch(*_stacks(B, n_mb, d, K, loss, n_mb + d + K, cuda), _hyper(cuda), loss,
                penalty=penalty, schedule=schedule)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 10])
def test_epoch_zero_mask_minibatch_and_margins_past_80(cuda, K):
    xs, ys, ms, coef, intercept = _stacks(2048, 16, 64, K, "log_loss", 40 + K, cuda, scale=60.0)
    ms[:, 15] = 0.0
    out = _hold_epoch(xs, ys, ms, coef, intercept, _hyper(cuda), "log_loss",
                      fit_intercept=False)
    assert out[15].tolist() == [0.0, 0.0]


@pytest.mark.cuda
def test_epoch_of_one_minibatch_raises(cuda):
    xs, ys, ms, coef, intercept = _stacks(64, 1, 8, 1, "log_loss", 0, cuda)
    with pytest.raises(ValueError, match="sgd_update"):
        sgd.sgd_epoch(xs, ys, ms, coef, intercept, torch.tensor(0.0, device=cuda),
                      _hyper(cuda), loss="log_loss", penalty="l2", schedule="optimal")


# ------------------------------------------------------------------- K5′

def _group_case(M, n, d, K, loss, seed, device):
    """x (n, d) cut into M ragged spans as the ensemble cuts it (windows as
    long as the longest span, the last pulled left over its neighbour),
    masks in [0, 2) with a tenth 0 and the last member's own rows all
    padding, a state and per-member hyperparameters."""
    x, y, mask, _, _ = _inputs(n, d, K, loss, seed, device)
    bounds = [n * i // M for i in range(M + 1)]
    spans = [(a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    size = max(b - a for a, b in spans)
    starts = tuple(min(a, n - size) for a, _ in spans)
    mask[spans[-1][0]:] = 0.0
    valid = torch.zeros(M, size, device=device)
    for i, ((lo, hi), st) in enumerate(zip(spans, starts)):
        valid[i, lo - st:hi - st] = 1.0
    masks = torch.stack([mask[s:s + size] for s in starts]) * valid
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    coef = torch.randn(M, d, K, generator=gen, device=device) / d ** 0.5
    intercept = 0.1 * torch.randn(M, K, generator=gen, device=device)
    hypers = torch.stack([_hyper(device)] * M)
    hypers[:, 0] *= torch.linspace(0.5, 2.0, M, device=device)
    return x, y, starts, masks, coef, intercept, hypers


@pytest.mark.cuda
@pytest.mark.parametrize("M, n, d, K, loss, penalty, schedule", [
    (2, 1999, 3, 1, "log_loss", "l2", "optimal"),
    (5, 20481, 64, 1, "hinge", "l1", "constant"),
    (3, 37033, 64, 10, "modified_huber", "elasticnet", "invscaling"),
    (4, 3993, 130, 1, "huber", None, "adaptive"),
    (3, 2331, 300, 1, "squared_error", "l2", "optimal"),
    (2, 1109, 20, 17, "squared_hinge", "l2", "constant"),
])
def test_group_step_against_plain(cuda, M, n, d, K, loss, penalty, schedule):
    """K5′ (one launch for the M members) against its plain version taken in
    float64: each member's loss and count rtol TOL, coef and intercept to
    TOL of the member's largest step plus their float32 rounding (hinge's
    kink rows allowed their jump), t exactly; a repeat gives the same bits."""
    from dask_ml_tpu_torch.ops import ensemble

    x, y, starts, masks, coef, intercept, hypers = _group_case(M, n, d, K, loss, M + d, cuda)
    t0 = torch.full((M,), 7.0, device=cuda)
    kw = dict(loss=loss, penalty=penalty, schedule=schedule)
    f64 = torch.float64
    ref = [v.to(f64) for v in (coef, intercept, t0)]
    out64 = ensemble.group_step_ref(x.to(f64), y.to(f64), starts, masks.to(f64), *ref,
                                    hypers.to(f64), **kw)
    before = ensemble.group_step.launches
    runs = []
    for _ in range(2):
        state = [v.clone() for v in (coef, intercept, t0)]
        runs.append(state + [ensemble.group_step(x, y, starts, masks, *state, hypers, **kw)])
    assert ensemble.group_step.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    c, b, t, out = runs[0]
    torch.testing.assert_close(out.to(f64), out64, rtol=TOL, atol=0.0)
    assert torch.equal(t.to(f64), ref[2])
    for m, s in enumerate(starts):
        eta = float(sgd.learning_rate(schedule, t0[m].to(f64), hypers[m].to(f64)))
        allow = 0.0
        if loss == "hinge":
            rows = slice(s, s + masks.shape[1])
            allow = _hinge_allowance(x[rows], y[rows], masks[m], coef[m], intercept[m], eta,
                                     float(out64[m, 1]))
        step = max(float((coef[m].to(f64) - ref[0][m]).abs().max()),
                   float((intercept[m].to(f64) - ref[1][m]).abs().max()))
        for got, want in ((c[m], ref[0][m]), (b[m], ref[1][m])):
            tol = TOL * step + 2.0 ** -22 * want.abs() + allow
            assert bool(((got.to(f64) - want).abs() <= tol).all())
