#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dask_ml_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Environment: torch and CUDA versions, the card's name and power limit;
   TF32 off for matmul and cuDNN.
2. Build: every kernel source under ``dask_ml_tpu_torch/csrc`` with
   ``nvcc`` for sm_90a, all at once, timed.
3. Kernels against their plain versions on the card, at ragged row counts
   and (d, k) in {(50, 8), (64, 64), (3, 1000), (130, 300), (50, 1729)},
   with fractional masks and candidate holes; plus a bitwise repeat (the
   kernels are deterministic).  ``lloyd_assign`` also against 1729 slots
   with duplicated candidates (exact ties go to the earlier slot) and with
   a single valid slot; it computes only the valid slots.
4. The main path at BASELINE ``configs[1]``: make_blobs 100M x 50 float32
   with 8 centres, generated on the card from a seed;
   ``KMeans(n_clusters=8, random_state=0).fit(X)`` (k-means|| init), then
   ``predict(X)``.  Every kernel must have launched in that run; the fit
   must recover the centres.  A small explicit-init fit on the card must
   agree with the same fit on the CPU (the plain versions).
5. Each kernel held against its plain version again at the main path's
   shape (100M x 50, k=8: row*d passes 2^31 there and the reduce's float32
   chains are longest), then timed there beside its plain version and its
   bound; ``lloyd_assign`` also at the last k-means|| round's shape (all
   candidate slots, with holes; the kernel computes the valid ones), held
   and timed against its plain version taken over row chunks.  Then the
   ``kernels`` line, the card line and the result.

The script imports nothing of JAX or of the JAX package.  Without CUDA it
prints no result and exits 1.
"""

from __future__ import annotations

import json
import logging
import re
import subprocess
import sys
import time

# H100 SXM data-sheet peaks (dense): device memory rate and float32 on the
# CUDA cores, the unit both kernels run on.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

MAIN_ROWS = 100_000_000
MAIN_D = 50
MAIN_K = 8
CHECK_ROWS = 1_000_003  # not a multiple of the 256-row tile
# (3, 1000) tiles the centers; (130, 300) also chunks the features and
# keeps the reduce's partial in global scratch; (50, 1729) is the last
# k-means|| round's candidate slots
CHECK_SHAPES = ((50, 8), (64, 64), (3, 1000), (130, 300), (50, 1729))
TOL = 1e-5
CHUNK = 1 << 20  # rows per step where a float64 or plain pass would not fit


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_lines(report):
    """Each kernel's registers and spills from ``nvcc -Xptxas -v``, named
    by its kernel and tile (``assign_kernel<8,8,16,...>``)."""
    name, out = "?", []
    for line in report.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mangled = m.group(1)
            kern = re.search(r"\d([a-z_]+_kernel)", mangled)
            tile = re.findall(r"Li(\d+)E", mangled)
            name = (kern.group(1) if kern else mangled) + (f"<{','.join(tile)}>" if tile else "")
        elif "registers" in line or "spill" in line:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def check_inputs(torch, n, d, k, seed, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, d, generator=gen, device=device) * 3
    mask = torch.rand(n, generator=gen, device=device)
    mask[torch.rand(n, generator=gen, device=device) < 0.1] = 0.0
    centers = torch.randn(k, d, generator=gen, device=device) * 3
    cvalid = (torch.rand(k, generator=gen, device=device) < 0.7).float()
    cvalid[0] = 1.0
    return x, mask, centers, cvalid


def near_ties_only(torch, x, centers, got, want, cvalid, what):
    """Number of rows whose labels differ; raises unless each is a near-tie:
    a row whose two smallest d² are within TOL·(‖x‖²+‖c‖²), where the
    float32 expansion may pick either center."""
    rows = torch.nonzero(got != want)[:, 0]
    c64 = centers.double()
    cn = (c64 ** 2).sum(1)
    for s in range(0, rows.shape[0], 1 << 16):
        r = rows[s:s + (1 << 16)]
        xs = x[r].double()
        d2 = torch.cdist(xs, c64) ** 2
        if cvalid is not None:
            d2[:, cvalid <= 0] = float("inf")
        two = torch.topk(d2, min(2, d2.shape[1]), dim=1, largest=False).values
        scale = (xs ** 2).sum(1) + cn[want[r]]
        if not bool(((two[:, -1] - two[:, 0]) < TOL * scale).all()):
            raise AssertionError(f"labels differ off near-ties at {what}")
    return int(rows.shape[0])


def sq_norms(torch, x):
    """‖x‖² per row without an (n, d) temporary."""
    return torch.linalg.vector_norm(x, dim=1) ** 2


def hold_assign(torch, kernel, plain, x, centers, cvalid, what):
    """``lloyd_assign`` (``kernel``: labels, min d², inertia) against its
    plain version (``plain``): inertia rtol TOL, min d² within
    TOL·(‖x‖²+max‖c‖²), labels equal off near-ties, no hole chosen.
    Returns the largest absolute difference."""
    kl, kd2, ki = kernel
    rl, rd2, ri = plain
    torch.testing.assert_close(ki, ri, rtol=TOL, atol=0)
    scale = sq_norms(torch, x) + (centers * centers).sum(1).max()
    if not bool(((kd2 - rd2).abs() <= TOL * scale).all()):
        raise AssertionError(f"min_d2 differs at {what}")
    n_diff = near_ties_only(torch, x, centers, kl, rl, cvalid, what)
    if cvalid is not None and not bool((cvalid[kl] > 0).all()):
        raise AssertionError(f"a candidate hole won the argmin at {what}")
    log(f"  lloyd_assign        {what}: labels differing on near-ties {n_diff}")
    return max(float((kd2 - rd2).abs().max()), float((ki - ri).abs()))


def hold_reduce(torch, lloyd, x, mask, centers, labels, min_d2, what):
    """``lloyd_assign_reduce`` twice (the same bits both times) against the
    plain reduce taken in float64, over row chunks, on ``labels`` (the
    assign kernel's, which computes the same distances): sums within TOL
    of each cluster's Σ|mask·x|, counts and inertia rtol TOL.

    The float32 plain reduce is not the yardstick: its ``index_add_``
    accumulates in atomic order, with an error (~1e-5 of Σ|mask·x| at 10^6
    rows) as large as the tolerance.  Returns the largest absolute
    difference."""
    sums, counts, inertia = lloyd.lloyd_assign_reduce(x, mask, centers)
    again = lloyd.lloyd_assign_reduce(x, mask, centers)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip((sums, counts, inertia), again)):
        raise AssertionError(f"lloyd_assign_reduce is not deterministic at {what}")
    k, d = centers.shape
    s64 = torch.zeros(k, d, dtype=torch.float64, device=x.device)
    mag = torch.zeros_like(s64)
    c64 = torch.zeros(k, dtype=torch.float64, device=x.device)
    i64 = torch.zeros((), dtype=torch.float64, device=x.device)
    for s in range(0, x.shape[0], CHUNK):
        m = mask[s:s + CHUNK].double()
        lab = labels[s:s + CHUNK]
        xm = x[s:s + CHUNK].double() * m[:, None]
        s64.index_add_(0, lab, xm)
        mag.index_add_(0, lab, xm.abs())
        c64.index_add_(0, lab, m)
        i64 += torch.sum(min_d2[s:s + CHUNK].double() * m)
    worst = float(((sums.double() - s64).abs() / (mag + 1e-300)).max())
    if worst > TOL:
        raise AssertionError(f"sums differ by {worst:.3g} of Σ|mask·x| at {what}")
    torch.testing.assert_close(counts.double(), c64, rtol=TOL, atol=TOL)
    torch.testing.assert_close(inertia.double(), i64, rtol=TOL, atol=0)
    log(f"  lloyd_assign_reduce {what}: sums within {worst:.2e} of Σ|mask·x|, "
        f"deterministic")
    return max(float((sums.double() - s64).abs().max()),
               float((counts.double() - c64).abs().max()),
               float((inertia.double() - i64).abs()))


def compare_kernels(torch, lloyd, device):
    """Phase 3.  Returns the largest absolute difference per kernel."""
    err = {"lloyd_assign_reduce": 0.0, "lloyd_assign": 0.0}
    for d, k in CHECK_SHAPES:
        x, mask, centers, cvalid = check_inputs(torch, CHECK_ROWS, d, k, d * k, device)
        for cv in (None, cvalid):
            what = f"d={d} k={k} cvalid={'holes' if cv is not None else 'none'}"
            kernel = lloyd.lloyd_assign(x, mask, centers, cv)
            torch.cuda.synchronize()
            err["lloyd_assign"] = max(err["lloyd_assign"], hold_assign(
                torch, kernel, lloyd.lloyd_assign_ref(x, mask, centers, cv),
                x, centers, cv, what))
            if cv is None:
                labels, min_d2 = kernel[0], kernel[1]
        err["lloyd_assign_reduce"] = max(err["lloyd_assign_reduce"], hold_reduce(
            torch, lloyd, x, mask, centers, labels, min_d2, f"d={d} k={k}"))
        del x, mask, centers, kernel, labels, min_d2
        torch.cuda.synchronize()
    for what, n_valid, dup in (("duplicated candidates", 502, True),
                               ("one valid slot", 1, False)):
        err["lloyd_assign"] = max(err["lloyd_assign"], hold_candidates(
            torch, lloyd, device, 50, 1729, n_valid, dup, what))
    return err


def hold_candidates(torch, lloyd, device, d, slots, n_valid, dup, what):
    """``lloyd_assign`` against ``slots`` candidate rows of x with
    ``n_valid`` valid (one: the last slot).  ``dup``: six valid slots
    repeat an earlier valid one, and no row may go to the later copy.
    The kernel must compute ``n_valid`` centers, no more."""
    x, mask, _, _ = check_inputs(torch, CHECK_ROWS, d, slots, slots + n_valid, device)
    gen = torch.Generator(device=device).manual_seed(n_valid)
    cand = x[torch.randperm(CHECK_ROWS, generator=gen, device=device)[:slots]].clone()
    cvalid = torch.zeros(slots, device=device)
    if n_valid == 1:
        cvalid[-1] = 1.0
    else:
        cvalid[0] = 1.0
        cvalid[1 + torch.randperm(slots - 1, generator=gen, device=device)[:n_valid - 1]] = 1.0
    valid = torch.nonzero(cvalid)[:, 0].tolist()
    pairs = list(zip(valid[0:12:2], valid[1:12:2])) if dup else []
    for lo, hi in pairs:
        cand[hi] = cand[lo]
    kernel = lloyd.lloyd_assign(x, mask, cand, cvalid)
    torch.cuda.synchronize()
    if lloyd.lloyd_assign.last_k != n_valid:
        raise AssertionError(f"the kernel computed {lloyd.lloyd_assign.last_k} centers, "
                             f"not the {n_valid} valid of {slots} slots, at {what}")
    for lo, hi in pairs:
        if bool((kernel[0] == hi).any()):
            raise AssertionError(f"an exact tie went to slot {hi}, not {lo}, at {what}")
    err = hold_assign(torch, kernel, lloyd.lloyd_assign_ref(x, mask, cand, cvalid),
                      x, cand, cvalid, f"d={d} {slots} slots, {what}")
    log(f"  lloyd_assign        {what}: {slots} slots, {n_valid} valid, "
        f"{lloyd.lloyd_assign.last_k} computed")
    return err


def make_blobs(torch, n, d, k, seed, device):
    """make_blobs' defaults on the card: centres uniform in [-10, 10]^d,
    cluster_std 1.0, each row's centre drawn uniformly."""
    gen = torch.Generator(device=device).manual_seed(seed)
    centres = torch.rand(k, d, generator=gen, device=device) * 20 - 10
    which = torch.randint(0, k, (n,), generator=gen, device=device)
    x = torch.randn(n, d, generator=gen, device=device)
    step = 1 << 22
    for s in range(0, n, step):
        x[s:s + step] += centres[which[s:s + step]]
    del which
    return x, centres


class PhaseTimes(logging.Handler):
    """Reads the fit's own phase timers (``utils._timer``), the size of the
    k-means|| candidate set (slots, valid ones) and the centers that the
    kernel computed in the last k-means|| pass, which that log line follows."""

    def __init__(self, lloyd):
        super().__init__(logging.DEBUG)
        self.lloyd = lloyd
        self.seconds = {}
        self.candidates = None
        self.computed = None

    def emit(self, record):
        if record.msg.startswith("Finished %s in"):
            self.seconds[record.args[0]] = record.args[1]
        elif record.msg.startswith("k-means|| %d candidate slots"):
            self.candidates = record.args
            self.computed = self.lloyd.lloyd_assign.last_k


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(bytes_moved, flops):
    """The larger of the memory time and the float32 compute time."""
    t_mem, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations"


def small_fit(torch, device):
    """The same explicit-init fit on the card and on the CPU (the plain
    versions): equal n_iter_, centers and inertia within TOL."""
    from dask_ml_tpu_torch import KMeans
    from dask_ml_tpu_torch.core import use_device

    gen = torch.Generator().manual_seed(3)
    truth = torch.rand(6, 16, generator=gen) * 8 - 4
    which = torch.randint(0, 6, (20_011,), generator=gen)
    xs = truth[which] + torch.randn(20_011, 16, generator=gen)
    init = (truth + 2.0 * torch.randn(6, 16, generator=gen)).numpy()
    fits = {}
    for dev in ("cpu", device):
        with use_device(dev):
            fits[str(dev)] = KMeans(n_clusters=6, init=init).fit(xs.to(dev))
    cpu, card = fits["cpu"], fits[str(device)]
    if card.n_iter_ != cpu.n_iter_:
        raise AssertionError(f"n_iter_ {card.n_iter_} on the card, {cpu.n_iter_} on the CPU")
    torch.testing.assert_close(card.cluster_centers_.cpu(), cpu.cluster_centers_,
                               rtol=TOL, atol=TOL * float(xs.abs().max()))
    if abs(card.inertia_ - cpu.inertia_) > TOL * cpu.inertia_:
        raise AssertionError(f"inertia {card.inertia_} on the card, {cpu.inertia_} on the CPU")
    log(f"small fit 20011x16 k=6: card matches the CPU plain path (n_iter {card.n_iter_}, "
        f"inertia {card.inertia_:.8g} vs {cpu.inertia_:.8g})")


def main_path(torch, lloyd, device, n, d, k):
    """Phase 4: fit + predict on make_blobs, every launch counted."""
    from dask_ml_tpu_torch import KMeans

    t0 = time.perf_counter()
    X, truth = make_blobs(torch, n, d, k, 0, device)
    torch.cuda.synchronize()
    log(f"phase 4: make_blobs {n}x{d} k={k} on the card in {time.perf_counter() - t0:.2f} s")
    timer = PhaseTimes(lloyd)
    km_logger = logging.getLogger("dask_ml_tpu_torch.cluster.k_means")
    km_logger.addHandler(timer)
    km_logger.setLevel(logging.DEBUG)
    torch.cuda.reset_peak_memory_stats()
    lloyd.lloyd_assign_reduce.launches = 0
    lloyd.lloyd_assign.launches = 0
    t0 = time.perf_counter()
    est = KMeans(n_clusters=k, random_state=0).fit(X)
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t0
    t0 = time.perf_counter()
    labels = est.predict(X)
    torch.cuda.synchronize()
    t_predict = time.perf_counter() - t0
    launches = {"lloyd_assign_reduce": lloyd.lloyd_assign_reduce.launches,
                "lloyd_assign": lloyd.lloyd_assign.launches}
    km_logger.removeHandler(timer)
    t_init = timer.seconds.get("k-means|| initialization", float("nan"))
    t_lloyd = timer.seconds.get("Lloyd loop", float("nan"))
    log(f"fit {t_fit:.3f} s (k-means|| {t_init:.3f} s, Lloyd {t_lloyd:.3f} s, "
        f"n_iter {est.n_iter_}, {1e3 * t_lloyd / max(est.n_iter_, 1):.3f} ms per round "
        f"on the host clock), predict {t_predict:.3f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    log(f"launches on the main path: {launches}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"{name} was not launched on the main path")
    per_row = est.inertia_ / n
    if not per_row <= 1.05 * d:
        raise AssertionError(f"inertia_/n = {per_row} > 1.05 * {d}")
    gap = torch.cdist(truth, est.cluster_centers_).min(dim=1).values
    if not bool((gap <= 0.1).all()):
        raise AssertionError(f"centres not recovered: distances {gap.tolist()}")
    if labels.shape != (n,) or not bool(((labels >= 0) & (labels < k)).all()):
        raise AssertionError("predict returned malformed labels")
    log(f"inertia_/n {per_row:.4f} (<= {1.05 * d}), worst centre error {float(gap.max()):.5f}")
    if timer.candidates is None:
        raise AssertionError("the fit logged no k-means|| candidate set")
    slots, valid = timer.candidates
    log(f"last k-means|| pass: {slots} candidate slots, {valid} valid, "
        f"{timer.computed} computed by the kernel")
    if timer.computed != valid:
        raise AssertionError("the last k-means|| pass computed other centers than the valid ones")
    return X, est, launches, timer.candidates


def kernel_table(torch, lloyd, X, centers, launches, card):
    """Phase 5: each kernel held against its plain version at the main
    path's shapes, then timed there (CUDA events) beside its plain version
    and its bound.  ``max_abs_err`` is that check's."""
    (n, d), k = X.shape, centers.shape[0]
    mask = torch.ones(n, device=X.device)
    centers = centers.contiguous()
    what = f"{n}x{d} k={k}"
    log(f"phase 5: kernels vs plain versions at the main path's shape {what}, rtol {TOL}")
    kernel = lloyd.lloyd_assign(X, mask, centers)
    torch.cuda.synchronize()
    max_err = {"lloyd_assign": hold_assign(
        torch, kernel, lloyd.lloyd_assign_ref(X, mask, centers), X, centers, None, what)}
    max_err["lloyd_assign_reduce"] = hold_reduce(
        torch, lloyd, X, mask, centers, kernel[0], kernel[1], what)
    del kernel
    specs = [
        ("lloyd_assign_reduce", lambda: lloyd.lloyd_assign_reduce(X, mask, centers),
         lambda: lloyd.lloyd_assign_reduce_ref(X, mask, centers),
         n * d * 4 + n * 4 + k * d * 4 + (k * d + k + 1) * 4,
         n * (2 * d + 2 * d * k + 4 * k + 2 * d + 3),
         "dask_ml_tpu/cluster/k_means.py:88"),
        ("lloyd_assign", lambda: lloyd.lloyd_assign(X, mask, centers),
         lambda: lloyd.lloyd_assign_ref(X, mask, centers),
         n * d * 4 + n * 4 + k * d * 4 + n * 8 + n * 4 + 4,
         n * (2 * d + 2 * d * k + 4 * k + 2),
         "dask_ml_tpu/cluster/k_means.py:212"),
    ]
    out = []
    for name, kern, plain, nbytes, flops, replaces in specs:
        ms = time_ms(torch, kern, 10)
        plain_ms = time_ms(torch, plain, 3)
        b_ms, b_by = bound_ms(nbytes, flops)
        log(f"{name} at {what}: {ms:.4f} ms, {n / ms * 1e3:.4g} rows/s "
            f"(plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}: "
            f"{nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP) [{card}]")
        out.append({"name": name, "route": "cuda",
                    "source": "dask_ml_tpu_torch/csrc/lloyd.cu", "replaces": replaces,
                    "launches": launches[name], "max_abs_err": max_err[name],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None})
    return out


def candidate_pass(torch, lloyd, X, slots, valid, card):
    """``lloyd_assign`` at the last k-means|| round's shape: every row
    against ``slots`` candidate rows, ``valid`` of them valid (the fit's
    own counts), the rest holes.  Held against its plain version, which
    runs over row chunks (its (n, slots) distances would not fit), then
    both timed.  The wrapper drops the holes, so the kernel computes the
    ``valid`` slots only; the bound counts their work."""
    n, d = X.shape
    gen = torch.Generator(device=X.device).manual_seed(7)
    cand = X[torch.randint(0, n, (slots,), generator=gen, device=X.device)].contiguous()
    cvalid = torch.zeros(slots, device=X.device)
    cvalid[torch.randperm(slots, generator=gen, device=X.device)[:valid]] = 1.0
    mask = torch.ones(n, device=X.device)
    what = f"{n}x{d} against {slots} slots, {valid} valid"
    log(f"phase 5: lloyd_assign vs its plain version at the k-means|| shape {what}")
    kl, kd2, ki = lloyd.lloyd_assign(X, mask, cand, cvalid)
    torch.cuda.synchronize()
    computed = lloyd.lloyd_assign.last_k
    if computed != valid:
        raise AssertionError(f"the kernel computed {computed} centers, not the {valid} valid")

    def plain():
        parts = [lloyd.lloyd_assign_ref(X[s:s + CHUNK], mask[s:s + CHUNK], cand, cvalid)
                 for s in range(0, n, CHUNK)]
        return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
                torch.stack([p[2] for p in parts]).sum())

    err = hold_assign(torch, (kl, kd2, ki), plain(), X, cand, cvalid, what)
    del kl, kd2
    ms = time_ms(torch, lambda: lloyd.lloyd_assign(X, mask, cand, cvalid), 3)
    plain_ms = time_ms(torch, plain, 1)
    nbytes = n * d * 4 + n * 4 + slots * (d + 1) * 4 + n * 12 + 4
    flops = n * (2 * d + 2 * d * valid + 4 * valid + 2)
    b_ms, b_by = bound_ms(nbytes, flops)
    log(f"lloyd_assign at {what}: {computed} centers computed, {ms:.4f} ms "
        f"({flops / ms / 1e9:.2f} TFLOP/s, {b_ms / ms:.1%} of the bound; plain over "
        f"{CHUNK}-row chunks {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}; "
        f"max abs err {err:.6g}) [{card}]")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from dask_ml_tpu_torch.core import set_device
    from dask_ml_tpu_torch.ops import _build, lloyd

    # 1. environment
    card = card_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    set_device(device)

    # 2. build every kernel source, in parallel
    t0 = time.perf_counter()
    sources = sorted(p.stem for p in _build.SRC_DIR.glob("*.cu"))
    _build.build(sources)
    log(f"build: {sources} in {time.perf_counter() - t0:.1f} s")
    for src in sources:
        for line in ptxas_lines((_build.BUILD_DIR / f"{src}.ptxas.txt").read_text()):
            log(f"  ptxas {src}: {line}")

    # 3. kernels against their plain versions
    log(f"phase 3: kernels vs plain versions, n={CHECK_ROWS}, rtol {TOL}")
    log(f"phase 3 largest absolute differences: {compare_kernels(torch, lloyd, device)}")

    small_fit(torch, device)

    # 4. the main path
    X, est, launches, (slots, valid) = main_path(torch, lloyd, device, MAIN_ROWS,
                                                 MAIN_D, MAIN_K)

    # 5. kernels at the main path's shapes: check, time, plain time, bound
    out = kernel_table(torch, lloyd, X, est.cluster_centers_, launches, card)
    candidate_pass(torch, lloyd, X, slots, valid, card)
    del X
    torch.cuda.synchronize()

    print(json.dumps({"kernels": out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
