"""K4's epoch on the CPU: ``ops/sgd.py :: sgd_epoch_ref`` (the plain version
of the one-launch epoch) and ``linear_model/_sgd.py :: sgd_epoch`` through
it, against the reference's ``sgd_epoch`` (a ``lax.scan`` of ``sgd_step``)
on the same seeded numpy stacks.

Tolerance, as ``tests/test_torch_sgd.py :: test_sgd_epoch_matches_reference``:
each step's loss and the epoch loss to rtol 1e-5, coef and intercept to
1e-5·‖coef_ref‖∞, t equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dask_ml_tpu.linear_model import _sgd as ref_sgd
from dask_ml_tpu_torch.core import mesh
from dask_ml_tpu_torch.linear_model import _sgd
from dask_ml_tpu_torch.ops import sgd as k4
from dask_ml_tpu_torch.programs import pad_block

STEP_TOL = 1e-5
LOSSES = ("log_loss", "hinge", "squared_hinge", "modified_huber", "squared_error", "huber")


@pytest.fixture(autouse=True)
def _cpu():
    mesh.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    mesh.set_device(None)
    torch.set_num_threads(threads)


def _hyper():
    values = dict(alpha=1e-3, eta0=0.05, power_t=0.25, t0=37.0, l1_ratio=0.3, epsilon=0.5,
                  eta_scale=0.2)
    ref = {k: jnp.float32(v) for k, v in values.items()}
    port = torch.tensor([values[k] for k in k4.HYPER_KEYS], dtype=torch.float32)
    return ref, port


def _stack(seed, loss, n, K, n_mb, pad=False, d=5):
    """(x, y, mask) of n rows as (B, n_mb, ...) stacks, and a state; with
    ``pad`` the rows are bucket-padded first and the last minibatch's mask
    is all zero."""
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    if loss in k4.CLASSIFIER_LOSSES:
        y = -np.ones((n, K), np.float32)
        y[np.arange(n), rng.randint(0, K, n)] = 1.0
    else:
        y = (x @ rng.standard_normal(d) + 0.3 * rng.standard_normal(n)).astype(np.float32)[:, None]
    mask = rng.uniform(0.2, 2.0, n).astype(np.float32)
    mask[rng.uniform(size=n) < 0.1] = 0.0
    if pad:
        x, y, real = pad_block(x, y)
        mask = np.concatenate([mask, np.zeros(x.shape[0] - n, np.float32)]) * real
    B = x.shape[0] // n_mb
    stacks = [a.reshape(B, n_mb, *a.shape[1:]).copy() for a in (x, y, mask)]
    if pad:
        stacks[2][:, -1] = 0.0
    coef = (0.5 * rng.standard_normal((d, K))).astype(np.float32)
    intercept = (0.1 * rng.standard_normal(K)).astype(np.float32)
    return stacks, coef, intercept


def _states(coef, intercept, t):
    ref = {"coef": jnp.asarray(coef), "intercept": jnp.asarray(intercept), "t": jnp.float32(t)}
    port = {"coef": torch.tensor(coef), "intercept": torch.tensor(intercept),
            "t": torch.tensor(t, dtype=torch.float32)}
    return ref, port


def _hold(state, new_ref, n_mb, t0):
    scale = np.abs(np.asarray(new_ref["coef"])).max()
    for key in ("coef", "intercept"):
        np.testing.assert_allclose(state[key].numpy(), np.asarray(new_ref[key]), rtol=0,
                                   atol=STEP_TOL * scale)
    assert float(state["t"]) == float(new_ref["t"]) == t0 + n_mb


CASES = [(loss, n_mb, K) for loss in k4.CLASSIFIER_LOSSES
         for n_mb, K in ((2, 1), (3, 4), (16, 10))]
CASES += [(loss, n_mb, 1) for loss in ("squared_error", "huber") for n_mb in (2, 3, 16)]


@pytest.mark.parametrize("loss, n_mb, K", CASES)
def test_epoch_ref_and_sgd_epoch_match_reference(loss, n_mb, K):
    """Both the plain epoch and the estimators' ``sgd_epoch`` (which runs it
    on the CPU) against the reference, each step's loss against the
    reference's steps too."""
    (xs, ys, ms), coef, intercept = _stack(LOSSES.index(loss) + 10 * n_mb, loss, 48 * n_mb, K,
                                           n_mb)
    h_ref, h_port = _hyper()
    kw = dict(loss=loss, penalty="elasticnet", schedule="invscaling")
    s_ref, _ = _states(coef, intercept, 5.0)
    new_ref, loss_ref = ref_sgd.sgd_epoch(s_ref, *map(jnp.asarray, (xs, ys, ms)), h_ref, **kw)
    # the reference's steps one at a time, for each step's loss
    st = _states(coef, intercept, 5.0)[0]
    step_losses = []
    for i in range(n_mb):
        st, lo = ref_sgd.sgd_step(st, jnp.asarray(xs[:, i]), jnp.asarray(ys[:, i]),
                                  jnp.asarray(ms[:, i]), h_ref, fit_intercept=True, **kw)
        step_losses.append(float(lo))

    _, s_plain = _states(coef, intercept, 5.0)
    calls = k4.sgd_epoch_ref.calls
    out = k4.sgd_epoch_ref(*map(torch.tensor, (xs, ys, ms)), s_plain["coef"],
                           s_plain["intercept"], s_plain["t"], h_port, **kw)
    assert k4.sgd_epoch_ref.calls == calls + 1
    np.testing.assert_allclose(out[:, 0].numpy(), step_losses, rtol=STEP_TOL)
    np.testing.assert_allclose(out[:, 1].numpy(), ms.sum(axis=0), rtol=STEP_TOL)
    _hold(s_plain, new_ref, n_mb, 5.0)

    _, s_port = _states(coef, intercept, 5.0)
    s_port, loss_port = _sgd.sgd_epoch(s_port, *map(torch.tensor, (xs, ys, ms)), h_port, **kw)
    np.testing.assert_allclose(float(loss_port), float(loss_ref), rtol=STEP_TOL)
    _hold(s_port, new_ref, n_mb, 5.0)


@pytest.mark.parametrize("loss, K", [("log_loss", 4), ("hinge", 1), ("huber", 1)])
def test_padded_stack_with_an_empty_last_minibatch_matches_reference(loss, K):
    """203 rows padded to the 256-row bucket, 16 minibatches, the last one's
    mask all zero: its step moves the state by the penalty alone, its loss
    and count are 0, and the epoch loss weighs it by its zero count."""
    (xs, ys, ms), coef, intercept = _stack(7, loss, 203, K, 16, pad=True)
    assert xs.shape[:2] == (16, 16) and ms[:, -1].sum() == 0.0
    h_ref, h_port = _hyper()
    kw = dict(loss=loss, penalty="l2", schedule="invscaling")
    s_ref, s_port = _states(coef, intercept, 0.0)
    new_ref, loss_ref = ref_sgd.sgd_epoch(s_ref, *map(jnp.asarray, (xs, ys, ms)), h_ref, **kw)
    out = k4.sgd_epoch(*map(torch.tensor, (xs, ys, ms)), s_port["coef"], s_port["intercept"],
                       s_port["t"], h_port, **kw)
    assert out[-1].tolist() == [0.0, 0.0]
    _hold(s_port, new_ref, 16, 0.0)
    _, s_port = _states(coef, intercept, 0.0)
    s_port, loss_port = _sgd.sgd_epoch(s_port, *map(torch.tensor, (xs, ys, ms)), h_port, **kw)
    np.testing.assert_allclose(float(loss_port), float(loss_ref), rtol=STEP_TOL)
    _hold(s_port, new_ref, 16, 0.0)


def test_epoch_of_one_minibatch_is_sgd_update():
    """``_sgd.sgd_epoch`` over one minibatch is ``sgd_update``'s step (the
    epoch wrapper takes two or more), bit for bit."""
    (xs, ys, ms), coef, intercept = _stack(3, "log_loss", 64, 3, 1)
    _, h = _hyper()
    kw = dict(loss="log_loss", penalty="l1", schedule="optimal")
    _, s_epoch = _states(coef, intercept, 2.0)
    s_epoch, epoch_loss = _sgd.sgd_epoch(s_epoch, *map(torch.tensor, (xs, ys, ms)), h, **kw)
    _, s_step = _states(coef, intercept, 2.0)
    out = k4.sgd_update(torch.tensor(xs[:, 0]), torch.tensor(ys[:, 0]), torch.tensor(ms[:, 0]),
                        s_step["coef"], s_step["intercept"], s_step["t"], h, **kw)
    for key in ("coef", "intercept", "t"):
        assert torch.equal(s_epoch[key], s_step[key])
    assert float(epoch_loss) == float(out[0])
    with pytest.raises(ValueError, match="sgd_update"):
        k4.sgd_epoch(*map(torch.tensor, (xs, ys, ms)), s_step["coef"], s_step["intercept"],
                     s_step["t"], h, **kw)


def test_epoch_wrapper_rejects_what_the_kernel_cannot_take():
    (xs, ys, ms), coef, intercept = _stack(4, "log_loss", 64, 2, 4)
    xs, ys, ms = map(torch.tensor, (xs, ys, ms))
    coef, intercept = torch.tensor(coef), torch.tensor(intercept)
    _, h = _hyper()
    t = torch.tensor(0.0)
    kw = dict(loss="log_loss", penalty="l2", schedule="optimal")
    with pytest.raises(ValueError, match="stacks disagree"):
        k4.sgd_epoch(xs, ys[:8], ms, coef, intercept, t, h, **kw)
    with pytest.raises(ValueError, match=r"\(B, n_mb, d\)"):
        k4.sgd_epoch(xs[:, 0], ys, ms, coef, intercept, t, h, **kw)
    with pytest.raises(ValueError, match="out must be"):
        k4.sgd_epoch(xs, ys, ms, coef, intercept, t, h, out=torch.empty(3, 2), **kw)
    with pytest.raises(ValueError, match="0-d"):
        k4.sgd_epoch(xs, ys, ms, coef, intercept, None, h, **kw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        k4.sgd_epoch(xs.to("meta"), ys.to("meta"), ms.to("meta"), coef.to("meta"),
                     intercept.to("meta"), t.to("meta"), h.to("meta"), **kw)
