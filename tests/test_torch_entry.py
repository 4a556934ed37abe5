"""The port's entry points (``dask_ml_tpu_torch/entry.py``) against the
repository's ``__graft_entry__.py``, on the CPU: ``entry()``'s forward on
its example arguments within 1e-6 of the reference's, and
``dryrun_multichip`` at 8 logical shards, its scanned-SGD section's
``t_ > 2`` check and the packed C-grid's packed-against-sequential check,
and the packed cohort's, Hyperband's, the packed C-grid's, the ring
pairwise and the streaming MiniBatchKMeans sections among them."""

import os

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from dask_ml_tpu_torch.core import mesh
from dask_ml_tpu_torch.entry import dryrun_multichip, entry


@pytest.fixture(autouse=True)
def _cpu():
    mesh.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    mesh.set_device(None)
    torch.set_num_threads(threads)


def test_entry_forward_matches_reference():
    fn, args = entry()
    ref_fn, ref_args = ref_entry.entry()
    for a, r in zip(args, ref_args):
        assert a.dtype == torch.float32 and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    out = fn(*args)
    assert tuple(out.shape) == (256,)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_fn(*ref_args)), rtol=0, atol=1e-6)


def test_entry_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    mesh.set_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="set_device"):
        entry()


def test_dryrun_multichip_runs_its_sections(capsys, monkeypatch):
    monkeypatch.delenv("DASK_ML_TPU_TORCH_PACK", raising=False)
    monkeypatch.delenv("DASK_ML_TPU_TORCH_GRID_PACK", raising=False)
    ran = dryrun_multichip(8, device="cpu")
    assert ran == ["binary ADMM", "bf16 lbfgs", "KMeans init=random", "PCA via TSQR",
                   "packed OvR ADMM", "multinomial lbfgs", "class_weight balanced",
                   "scanned minibatch SGD", "packed SGD cohort", "Hyperband", "packed C-grid",
                   "ring pairwise", "MiniBatchKMeans partial_fit"]
    out = capsys.readouterr().out
    assert "dryrun_multichip(8) on cpu" in out and "packed OvR ADMM" in out
    assert "packed C-grid" in out and "ring pairwise" in out
    assert "MiniBatchKMeans partial_fit" in out
    assert "DASK_ML_TPU_TORCH_PACK" not in os.environ
    assert "DASK_ML_TPU_TORCH_GRID_PACK" not in os.environ
    assert mesh.get_n_shards() == 1  # the shard count was scoped to the dryrun


def test_dryrun_scanned_sgd_section_checks_the_minibatch_path(monkeypatch):
    """The eighth section fails when the fit takes one step an epoch (t_ ==
    2), as a fall back to the full batch would."""
    from dask_ml_tpu_torch.linear_model import _sgd

    monkeypatch.setattr(_sgd, "_minibatch_views", lambda *a, **k: None)
    with pytest.raises(AssertionError, match=r"minibatch path did not engage \(t_=2.0\)"):
        dryrun_multichip(8, device="cpu")


def test_dryrun_packed_grid_section_checks_packed_against_sequential(monkeypatch):
    """The eleventh section fails when the packed C-sweep's scores leave the
    per-candidate fits' by more than 1e-4."""
    from dask_ml_tpu_torch.model_selection import _search

    real = _search._sweep_accuracy
    monkeypatch.setattr(_search, "_sweep_accuracy",
                        lambda *args: real(*args) - 0.01)
    with pytest.raises(AssertionError, match="packed C-sweep is"):
        dryrun_multichip(8, device="cpu")


def test_dryrun_ring_section_checks_the_ring_shape(monkeypatch):
    """The twelfth section fails when the sharded×sharded call does not
    return (n, 8·n_shards): here the ring drops Y's last shard."""
    from dask_ml_tpu_torch.metrics import pairwise

    real = pairwise.ring_pairwise
    monkeypatch.setattr(pairwise, "ring_pairwise",
                        lambda X, Y, fn: real(X, Y, fn)[:, :-8])
    with pytest.raises(AssertionError, match=r"\(128, 56\)"):
        dryrun_multichip(8, device="cpu")


def test_dryrun_minibatch_section_streams_through_the_step(monkeypatch):
    """The thirteenth section steps the weighted block through the Sculley
    step: two ``partial_fit`` calls, the second on a mask of weights 2."""
    from dask_ml_tpu_torch.cluster import minibatch_kmeans

    masses = []
    real = minibatch_kmeans._mbk_step_fn

    def spy(centers, counts, xb, mask):
        masses.append(float(mask.sum()))
        return real(centers, counts, xb, mask)

    monkeypatch.setattr(minibatch_kmeans, "_mbk_step_fn", spy)
    dryrun_multichip(8, device="cpu")
    assert masses == [128.0, 256.0]
