"""The port's input pipeline (``dask_ml_tpu_torch/pipeline/``) on the CPU:
``stream_partial_fit`` at every depth, the staged protocol of the SGD
estimators, declined blocks, faults, the depth knob, the worker's
lifetime, and ``prefetch_blocks``.

Tolerances: across depths none (``coef_``, ``intercept_`` and ``t_``
bit-identical to depth 0 on blocks that all differ, ragged ones
included); against the reference's ``stream_partial_fit``, the SGD
tolerance of ``test_torch_sgd.py`` (‖Δ‖∞ ≤ 1e-4·‖coef_ref‖∞, ``t_``
equal).
"""

import queue
import threading

import numpy as np
import pytest
import torch

from dask_ml_tpu.linear_model import SGDClassifier as RefSGDClassifier
from dask_ml_tpu.pipeline import stream_partial_fit as ref_stream_partial_fit
from dask_ml_tpu_torch import SGDClassifier, SGDRegressor, pipeline
from dask_ml_tpu_torch.core import mesh
from dask_ml_tpu_torch.pipeline import core as pcore

TOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu():
    mesh.set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    mesh.set_device(None)
    torch.set_num_threads(threads)


def _blocks(seed, k=2, sizes=(300, 256, 411, 37, 256, 1000), d=5, regression=False):
    rng = np.random.RandomState(seed)
    W = rng.standard_normal((d, max(k, 1)))
    out = []
    for n in sizes:
        X = rng.standard_normal((n, d)).astype(np.float32)
        if regression:
            y = (X @ W[:, 0] + 0.1 * rng.standard_normal(n)).astype(np.float32)
        else:
            y = np.argmax(X @ W + 0.5 * rng.standard_normal((n, W.shape[1])), axis=1)
            if k == 2:
                y = (X @ W[:, 0] > 0).astype(np.int64)
        out.append((X, y))
    return out


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == pcore.PREFETCH_THREAD_NAME]


def _state(m):
    return np.asarray(m.coef_), np.asarray(m.intercept_), m.t_


def _assert_same_bits(a, b):
    for x, y in zip(_state(a), _state(b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", ["binary", "3-class", "regressor"])
def test_every_depth_gives_the_bits_of_depth_0(case):
    if case == "regressor":
        blocks, make, kw = _blocks(1, regression=True), SGDRegressor, {}
    else:
        k = 2 if case == "binary" else 3
        blocks, make, kw = _blocks(2, k=k), SGDClassifier, {"classes": list(range(k))}
    fits = {}
    for depth in (0, 1, 2, 4):
        model = make(random_state=0)
        pipeline.stream_partial_fit(model, blocks, depth=depth, fit_kwargs=kw)
        fits[depth] = model
        report = pipeline.pipeline_report()
        assert report["blocks"] == len(blocks) and report["depth"] == depth
        assert report["staged"] == (depth > 0)
    for depth in (1, 2, 4):
        _assert_same_bits(fits[depth], fits[0])
    assert fits[0].t_ == len(blocks)
    assert not _prefetch_threads()
    if case != "regressor":  # and the reference's stream, within its tolerance
        ref = RefSGDClassifier(random_state=0)
        ref_stream_partial_fit(ref, blocks, depth=2, fit_kwargs=kw)
        scale = TOL * np.abs(np.asarray(ref.coef_)).max()
        np.testing.assert_allclose(fits[2].coef_, np.asarray(ref.coef_), rtol=0, atol=scale)
        np.testing.assert_allclose(fits[2].intercept_, np.asarray(ref.intercept_), rtol=0,
                                   atol=scale)
        assert fits[2].t_ == ref.t_


class _Recorder:
    """A staged-protocol model that declines every third block and records
    the order in which blocks reach it, and by which route."""

    def __init__(self):
        self.seen = []

    def _pf_stage(self, X, y, stager=None, **kw):
        if int(X[0, 0]) % 3 == 2:
            return None
        return ("staged", int(X[0, 0]))

    def _pf_consume(self, staged):
        self.seen.append(staged)

    def partial_fit(self, X, y=None, **kw):
        self.seen.append(("serial", int(X[0, 0])))


def test_declined_blocks_keep_their_place_in_the_order():
    blocks = [(np.full((4, 2), i, np.float32), None) for i in range(10)]
    rec = _Recorder()
    pipeline.stream_partial_fit(rec, blocks, depth=2)
    assert rec.seen == [("serial" if i % 3 == 2 else "staged", i) for i in range(10)]
    # SGD: a tensor block (device-resident) and weighted blocks take partial_fit
    host = _blocks(3)
    mixed = host[:2] + [(torch.from_numpy(host[2][0]), torch.from_numpy(host[2][1]))] + host[3:]
    a, b = SGDClassifier(random_state=0), SGDClassifier(random_state=0)
    pipeline.stream_partial_fit(a, mixed, depth=2, fit_kwargs={"classes": [0, 1]})
    pipeline.stream_partial_fit(b, host, depth=0, fit_kwargs={"classes": [0, 1]})
    _assert_same_bits(a, b)
    even = _blocks(3, sizes=(256,) * 4)
    w = {"classes": [0, 1], "sample_weight": np.linspace(0.5, 2.0, 256)}
    fits = []
    for depth in (0, 2):
        fits.append(SGDClassifier(random_state=0))
        pipeline.stream_partial_fit(fits[-1], even, depth=depth, fit_kwargs=w)
    _assert_same_bits(*fits)
    assert fits[0]._pf_stage(*even[0], sample_weight=w["sample_weight"]) is None


def _faulty(n_ok, exc):
    def gen():
        for i, blk in enumerate(_blocks(4)):
            if i == n_ok:
                raise exc
            yield blk
    return gen()


@pytest.mark.parametrize("depth", [0, 2])
def test_a_parse_fault_and_a_stage_fault_surface_with_block_and_phase(depth):
    with pytest.raises(OSError, match="disk") as err:
        pipeline.stream_partial_fit(SGDClassifier(), _faulty(3, OSError(5, "disk")),
                                    depth=depth, fit_kwargs={"classes": [0, 1]})
    assert (err.value.pipeline_block, err.value.pipeline_phase) == (3, "parse")
    assert not _prefetch_threads()
    blocks = _blocks(4)
    blocks[2] = (blocks[2][0], np.full(blocks[2][0].shape[0], 7))  # a label not in classes
    model = SGDClassifier()
    with pytest.raises(ValueError, match="not in `classes`") as err:
        pipeline.stream_partial_fit(model, blocks, depth=depth, fit_kwargs={"classes": [0, 1]})
    if depth:  # the worker staged it: a stage fault
        assert (err.value.pipeline_block, err.value.pipeline_phase) == (2, "stage")
    assert model.t_ == 2.0  # the blocks before it were consumed, none after
    assert not _prefetch_threads()


def test_an_error_outside_parse_and_stage_surfaces_as_a_worker_fault(monkeypatch):
    def crash(src, stage, stats, blk):
        raise SystemExit  # not an Exception: escapes the parse/stage handlers

    monkeypatch.setattr(pcore, "_parse_and_stage", crash)
    with pytest.raises(SystemExit) as err:
        pipeline.stream_partial_fit(SGDClassifier(), _blocks(5), depth=2,
                                    fit_kwargs={"classes": [0, 1]})
    assert err.value.pipeline_phase == "worker"
    assert not _prefetch_threads()


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_a_worker_that_ends_without_reporting_raises(monkeypatch):
    class _Lossy(queue.Queue):
        def put(self, *args, **kwargs):
            raise RuntimeError("the message is lost")

    monkeypatch.setattr(pcore, "Queue", _Lossy)
    with pytest.raises(RuntimeError, match="without reporting at block 0"):
        pipeline.stream_partial_fit(SGDClassifier(), _blocks(5), depth=2,
                                    fit_kwargs={"classes": [0, 1]})
    assert not _prefetch_threads()


def test_resolve_depth_reads_the_knob_and_rejects_a_typo(monkeypatch):
    monkeypatch.delenv(pipeline.DEPTH_ENV, raising=False)
    assert pipeline.resolve_depth() == 2 and pipeline.resolve_depth(0) == 0
    monkeypatch.setenv(pipeline.DEPTH_ENV, "5")
    assert pipeline.resolve_depth() == 5 and pipeline.resolve_depth(1) == 1
    monkeypatch.setenv(pipeline.DEPTH_ENV, "two")
    with pytest.raises(ValueError, match="DASK_ML_TPU_TORCH_PREFETCH_DEPTH"):
        pipeline.resolve_depth()
    with pytest.raises(ValueError, match=">= 0"):
        pipeline.resolve_depth(-1)


def test_the_worker_is_joined_when_the_consumer_stops_early():
    started = threading.Event()

    def endless():
        while True:
            started.set()
            yield np.zeros((4, 2), np.float32), None

    class _Stop(Exception):
        pass

    def on_block(i, model):
        if i == 3:
            raise _Stop

    class _Model:
        def partial_fit(self, X, y=None):
            pass

    with pytest.raises(_Stop):
        pipeline.stream_partial_fit(_Model(), endless(), depth=4, on_block=on_block)
    assert started.is_set() and not _prefetch_threads()
    assert pipeline.pipeline_report()["blocks"] == 3


def test_prefetch_blocks_stages_on_the_worker_in_order():
    names = []

    def stage(x):
        names.append(threading.current_thread().name)
        return x * 2

    got = list(pipeline.prefetch_blocks(iter(range(20)), depth=3, stage=stage))
    assert got == [2 * i for i in range(20)]
    assert set(names) == {pcore.PREFETCH_THREAD_NAME}
    assert list(pipeline.prefetch_blocks(range(5), depth=0)) == list(range(5))
    gen = pipeline.prefetch_blocks(iter(range(100)), depth=2)
    assert next(gen) == 0
    gen.close()  # an abandoned stream joins its worker
    assert not _prefetch_threads()
    report = pipeline.pipeline_report()
    assert report["streams"] >= 3 and report["cumulative"]["blocks"] >= 25
    assert set(report) >= {"parse_s", "transfer_s", "compute_s", "stall_s", "wall_s",
                           "hidden_s", "host_buffers", "pinned_buffers"}
    pipeline.reset_pipeline_stats()
    assert pipeline.pipeline_report() == {"streams": 0}


def test_the_worker_sees_the_consumers_device_scope():
    seen = []

    def source():
        for _ in range(3):
            seen.append(mesh.get_device())
            yield np.zeros((4, 2), np.float32), None

    class _Model:
        def partial_fit(self, X, y=None):
            pass

    mesh.set_device(None)
    with mesh.use_device("cpu"):
        pipeline.stream_partial_fit(_Model(), source(), depth=2)
    assert seen == [torch.device("cpu")] * 3


def test_staging_needs_a_device_unless_the_cpu_was_asked_for(monkeypatch):
    mesh.set_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="set_device"):
        pipeline.stream_partial_fit(SGDClassifier(), _blocks(6), depth=2,
                                    fit_kwargs={"classes": [0, 1]})
    assert not _prefetch_threads()


def test_the_cpu_stager_copies_and_ready_passes_plain_blocks_through():
    stager = pipeline.Stager("cpu", 4)
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    staged = stager.put((a, np.ones(3, np.float32)))
    assert isinstance(staged, pipeline.Staged) and staged.event is None
    x, m = pipeline.ready(staged)
    a[0, 0] = 99.0  # the staged copy owns its memory
    assert x[0, 0] == 0.0 and x.dtype == torch.float32 and m.shape == (3,)
    plain = (torch.zeros(2),)
    assert pipeline.ready(plain) is plain
    assert stager.host_buffers == stager.pinned_buffers == 0


def test_source_buffers_are_lent_only_while_nobody_holds_them():
    stager = pipeline.Stager("cpu", 2)
    with pipeline.staging.reading_for(stager):
        a = pipeline.staging.host_empty((3, 2))
        b = pipeline.staging.host_empty((3, 2))
        assert a is not b  # a is held
        view = a[:, 0]
        del a
        c = pipeline.staging.host_empty((3, 2))
        assert c is not view.base and c is not b  # a's view still holds it
        del view, c
        assert pipeline.staging.host_empty((3, 2)) is stager._sources[0][1]
        held = [pipeline.staging.host_empty((5,)) for _ in range(4)]
        assert len(stager._sources) == 4  # slots + 2: further buffers are plain memory
        assert not any(h is s[1] for h in held[1:] for s in stager._sources)
    assert isinstance(pipeline.staging.host_empty((2,)), np.ndarray)  # no stager: np.empty


@pytest.mark.parametrize("depth", [0, 2])
def test_blocks_read_into_source_buffers_stay_whole_while_held(tmp_path, depth):
    from dask_ml_tpu_torch import io

    X = np.random.RandomState(7).standard_normal((5000, 6)).astype(np.float32)
    path = tmp_path / "x.f32"
    X.tofile(path)
    kept = []

    def blocks():
        for xb in io.stream_binary_blocks(str(path), 512, 6):
            kept.append(xb)  # the caller holds every block: none may be refilled
            yield xb, (xb[:, 0] > 0).astype(np.int64)

    model = SGDClassifier(random_state=0)
    pipeline.stream_partial_fit(model, blocks(), depth=depth, fit_kwargs={"classes": [0, 1]})
    np.testing.assert_array_equal(np.concatenate(kept), X)
    serial = SGDClassifier(random_state=0)
    for a in range(0, 5000, 512):
        serial.partial_fit(X[a:a + 512], (X[a:a + 512, 0] > 0).astype(np.int64), classes=[0, 1])
    _assert_same_bits(model, serial)
