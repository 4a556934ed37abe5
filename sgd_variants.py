#!/usr/bin/env python3
"""Time variants of K4's CUDA source against each other on one card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 sgd_variants.py [--k1] [NAME ...]

Builds ``dask_ml_tpu_torch/csrc/sgd.cu`` ("current") and each named variant
of it (a text edit, listed in ``VARIANTS``, or with ``--k1`` in
``K1_VARIANTS``), all with ``nvcc`` at once into
``dask_ml_tpu_torch/_build/variants/``, prints each library's registers and
spills for the tensor-core instances (with ``--k1``: the K = 1 step's),
then times each through ``ops/sgd.py``'s wrappers, in turns (the list
forward, then backward).  By default at the 10-class shapes of
``chip_smoke.py`` phase 10c: the update and the loss of a 2^20 x 64 block
and a step of the epoch over its 16 minibatches (CUDA events over 20
calls; the epoch's time over its steps).  With ``--k1``: the K = 1 step at
12d's 2^18 x 64 block, 10c's 2^20 x 64 block and its minibatch view (rows
5::16) and the loss at 2^20,
each by CUDA events over 20 calls queued behind a device sleep and by its
device time (``torch.profiler``).  The variants that take work out give
wrong sums on purpose: they time what is left.  Without a card it exits 1.
"""

from __future__ import annotations

import sys

import variants

SRC = variants.CSRC / "sgd.cu"
ROWS, D, K, N_MB = 1 << 20, 64, 10, 16

_TERMS = "const Terms tr = L::terms(mg[c] + bias[k], yt[r * K + k], eps);"
_NO_TERMS = (_TERMS, "const Terms tr{mg[c] + bias[k], yt[r * K + k]};")
_MMA = """  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));"""
# name: (what it changes, [(text of the current source, its replacement)])
VARIANTS = {
    "no_terms": ("the loss terms replaced by (margin, target)", [_NO_TERMS]),
    "no_mma": ("every mma.sync replaced by one dependent add", [(
        _MMA, "  c[0] += __uint_as_float(a[0] ^ b0 ^ b1);")]),
    "skeleton": ("no products and no loss terms: the copies, the syncs and the sums", [
        ("      for (int st = 0; st < s.ks; ++st) {", "      for (int st = 0; st < 0; ++st) {"),
        ("          for (int ks = 0; ks < R / 8; ++ks) {", "          for (int ks = 0; ks < 0; ++ks) {"),
        _NO_TERMS]),
}

# the K = 1 step (step_kernel): what its fixed cost a call is made of
_K1_TICKET = "*flag = atomicInc(a.ticket, gridDim.x - 1) == gridDim.x - 1;"
K1_VARIANTS = {
    "k1_noticket": ("no finish: every block returns after its record", [
        (_K1_TICKET, "*flag = 0;")]),
    "k1_nosum": ("the last block sums no record", [
        ("for (int b = g * nbc / G; b < (g + 1) * nbc / G; ++b) {",
         "for (int b = g * nbc / G; b < 0; ++b) {")]),
    "k1_nocompute": ("the ring alone: no row is computed", [
        ("for (int g = warp; g * U < nrows; g += SWARPS) {",
         "for (int g = warp; g * U < 0; g += SWARPS) {")]),
    "k1_persm2": ("two blocks a SM, three stages", [
        ("constexpr int SK_STAGES = 4;", "constexpr int SK_STAGES = 3;"),
        ("constexpr int SK_PER_SM = 1;", "constexpr int SK_PER_SM = 2;")]),
    "k1_static16": ("16 bytes of static shared memory before the stages", [
        ("  extern __shared__ __align__(128) float sm[];\n  const int d = a.d, rec",
         "  __shared__ int pad16[4];\n"
         "  extern __shared__ __align__(16) float sm[];\n"
         "  if (threadIdx.x == 0) pad16[0] = a.d;\n"
         "  const int d = a.d, rec"),
        ("  cp_async_wait_all();\n\n  // the block's record",
         "  cp_async_wait_all();\n  if (pad16[0] != a.d) __trap();\n\n  // the block's record")]),
    "k1_runs": ("a block's tiles a contiguous run, not every nb-th", [
        ("  const long long first = blockIdx.x, step = gridDim.x;\n"
         "  const long long nloc = (tiles - 1 - blockIdx.x) / gridDim.x + 1;",
         "  const long long first = tiles * blockIdx.x / gridDim.x, step = 1;\n"
         "  const long long nloc = tiles * (blockIdx.x + 1) / gridDim.x - first;")]),
    "k1_rowbulk": ("a strided view's rows by a bulk copy a row, not 16-byte cp.async", [
        ("    const int q4 = d / 4;\n"
         "    for (int e = threadIdx.x; e < nrows * q4; e += ST) {\n"
         "      const int r = e / q4, j = 4 * (e - r * q4);\n"
         "      cp_async16(xs + r * s.ds + j, a.x + (r0 + r) * a.xs + j);\n"
         "    }",
         "    if (threadIdx.x == 0) mbar_expect(bar, (unsigned)(nrows * d * 4));\n"
         "    if (threadIdx.x < 32)\n"
         "      for (int r = threadIdx.x; r < nrows; r += 32)\n"
         "        bulk_copy(xs + r * s.ds, a.x + (r0 + r) * a.xs, (unsigned)(d * 4), bar);"),
        ("    if (a.xmode == X_TILE) mbar_wait(", "    if (a.xmode != X_FLOATS) mbar_wait(")]),
    "k1_t512": ("512 threads a block", [
        ("constexpr int ST = 256;", "constexpr int ST = 512;")]),
    "k1_r64": ("64-row tiles at d <= 64", [
        ("s.R = d <= 64 ? 128 : 32;", "s.R = d <= 64 ? 64 : 32;")]),
    "k1_nofence": ("no release fence before the ticket (timing only: unordered)", [
        ("    fence_acq_rel_gpu();\n    *flag = atomicInc", "    *flag = atomicInc")]),
    # %globaltimer (ns) of each block's start and end of its rows, and of the
    # last block's ticket, sums and end, into the scratch past the records
    "k1_probe": ("timestamps of the blocks and of the finish", [
        ('asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");',
         'asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");\n'
         '  unsigned long long pt0;\n'
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(pt0));'),
        ("  float* red = sm + s.red;\n  float* mine = red + warp * rec;",
         "  unsigned long long pt1;\n"
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(pt1));\n'
         "  unsigned* probe = reinterpret_cast<unsigned*>(a.part + (long long)gridDim.x * "
         "((rec + 3) & ~3));\n"
         "  if (threadIdx.x == 0) {\n"
         "    probe[2 * blockIdx.x] = (unsigned)pt0;\n"
         "    probe[2 * blockIdx.x + 1] = (unsigned)pt1;\n"
         "  }\n"
         "  float* red = sm + s.red;\n  float* mine = red + warp * rec;"),
        ("  __syncthreads();\n  if (!*flag) return;\n",
         "  __syncthreads();\n  if (!*flag) return;\n"
         "  unsigned long long pt2;\n"
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(pt2));\n'),
        ("  const float cnt = red[1];",
         "  unsigned long long pt3;\n"
         '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(pt3));\n'
         "  const float cnt = red[1];"),
        ("    *a.t = tv + 1.f;\n  }\n}",
         "    *a.t = tv + 1.f;\n"
         "    unsigned long long pt4;\n"
         '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(pt4));\n'
         "    probe[2 * nb] = (unsigned)pt2;\n"
         "    probe[2 * nb + 1] = (unsigned)pt3;\n"
         "    probe[2 * nb + 2] = (unsigned)pt4;\n"
         "  }\n}"),
        ("p->loss_blocks) * stride;", "p->loss_blocks) * stride + 4096;")]),
}

K1_VARIANTS["k1_probe_noticket"] = (
    "k1_probe with no finish", K1_VARIANTS["k1_probe"][1] + K1_VARIANTS["k1_noticket"][1])


def build(names):
    """Every named source compiled at once; prints the tensor-core instances'
    registers and spills; returns {name: library path}."""
    import chip_smoke

    text = SRC.read_text()
    table = {**VARIANTS, **K1_VARIANTS}
    built = variants.compile_all({
        f"sgd_{name}": variants.edited(text, table.get(name, ("", []))[1], name, SRC.name)
        for name in names})
    out = {}
    for name in names:
        so, err = built[f"sgd_{name}"]
        for line in sorted(set(chip_smoke.ptxas_lines(err))):
            if ("tc_kernel<2>" in line or "epoch_kernel<2,2,1>" in line
                    or "step_kernel<LogLoss,2" in line):
                print(f"{name}: {line}")
        out[name] = so
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sgd_variants: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    k1 = "--k1" in sys.argv
    args = [a for a in sys.argv[1:] if a != "--k1"]
    names = ["current"] + (args or list(K1_VARIANTS if k1 else VARIANTS))
    libs = build(names)
    import chip_smoke as cs
    from dask_ml_tpu_torch.core import set_device
    from dask_ml_tpu_torch.ops import sgd

    card = cs.card_line()
    device = torch.device("cuda")
    set_device(device)
    if k1:
        return time_k1(torch, cs, sgd, libs, names, device, card)
    x, y, mask, coef, intercept = cs.sgd_inputs(torch, ROWS, D, K, "log_loss", 1, device)
    hyper = cs.sgd_hyper(torch, device)
    stacks = (x.view(-1, N_MB, D), y.view(-1, N_MB, K), mask.view(-1, N_MB))
    kw = dict(loss="log_loss", penalty="l2", schedule="optimal")
    for name in variants.in_turns(names):
        variants.swap(sgd, "sgd", libs[name], sgd._plans, sgd._scratch)
        c, b, t = coef.clone(), intercept.clone(), torch.tensor(5.0, device=device)
        up = cs.time_ms(torch, lambda: sgd.sgd_update(x, y, mask, c, b, t, hyper, **kw), 20)
        lo = cs.time_ms(torch, lambda: sgd.sgd_loss(x, y, mask, c, b, hyper, loss="log_loss"), 20)
        ep = cs.time_ms(torch, lambda: sgd.sgd_epoch(*stacks, c, b, t, hyper, **kw), 20) / N_MB
        print(f"{name:9s} K={K}: update {up:.4f} ms, loss {lo:.4f} ms (2^20 x {D}); epoch "
              f"{ep:.4f} ms a step (16 x 65536 x {D}) [{card}]", flush=True)
    return 0


def time_k1(torch, cs, sgd, libs, names, device, card):
    """The K = 1 step at 2^18 and 2^20 rows x 64, the loss at 2^20 and the
    step on 10c's minibatch view (rows 5::16 of 2^20), each variant in
    turns, and "(b)": the current source's epoch kernel run as an epoch of
    one minibatch (``chip_smoke.k4_epoch_step``; the steps only):
    CUDA events over 20 calls queued behind a device sleep, and the device
    time a call (``chip_smoke.k4_split``)."""
    hyper = cs.sgd_hyper(torch, device)
    kw = dict(loss="log_loss", penalty="l2", schedule="optimal")
    cases = {rows: cs.sgd_inputs(torch, rows, D, 1, "log_loss", 1, device)
             for rows in (1 << 18, ROWS)}
    view = cs.minibatch_view(cases[ROWS], N_MB)  # 10c's sgd_update_minibatch: rows 5::16
    for name in variants.in_turns(names + ["(b)"]):
        variants.swap(sgd, "sgd", libs.get(name, libs["current"]), sgd._plans, sgd._scratch)
        update = cs.k4_epoch_step(torch, sgd) if name == "(b)" else sgd.sgd_update
        parts = []
        for rows, (x, y, mask, coef, intercept) in cases.items():
            c, b, t = coef.clone(), intercept.clone(), torch.tensor(5.0, device=device)
            calls = [("update", lambda: update(x, y, mask, c, b, t, hyper, **kw))]
            if rows == ROWS and name != "(b)":
                calls.append(("loss", lambda: sgd.sgd_loss(x, y, mask, c, b, hyper,
                                                           loss="log_loss")))
            if name.startswith("k1_probe"):
                print_probe(torch, sgd, calls[0][1], rows, device)
            for what, fn in calls:
                ms = cs.queued_ms(torch, fn, 20)
                split = cs.k4_split(torch, fn)
                dev = "not measured" if split is None else \
                    f"{split['kernel_ms'] + split['finish_ms'] + split['gap_ms']:.4f}"
                parts.append(f"{what} 2^{rows.bit_length() - 1} {ms:.4f} (device {dev})")
        x, y, mask, coef, intercept = view
        c, b, t = coef.clone(), intercept.clone(), torch.tensor(5.0, device=device)
        fn = lambda: update(x, y, mask, c, b, t, hyper, **kw)  # noqa: E731
        split = cs.k4_split(torch, fn)
        dev = "not measured" if split is None else \
            f"{split['kernel_ms'] + split['finish_ms'] + split['gap_ms']:.4f}"
        parts.append(f"update rows 5::16 {cs.queued_ms(torch, fn, 20):.4f} (device {dev})")
        print(f"{name:12s} K=1, ms: {'; '.join(parts)} [{card}]", flush=True)
    return 0


def print_probe(torch, sgd, fn, rows, device):
    """``k1_probe``'s timestamps after one step of ``rows`` rows: each block's
    start and end of its rows, relative to the first start (µs: first,
    median, last), and the last block's ticket, sums and end, relative to
    the last end of rows."""
    import numpy as np

    fn()
    torch.cuda.synchronize()
    key = next(k for k in sgd._plans if k[2] == rows and k[4] == 1 and not k[5])
    nb, rec = int(sgd._plans[key][3]), 3 + D
    raw = sgd._scratch[device.index if device.index is not None else 0]
    words = raw[nb * ((rec + 3) & ~3):].view(torch.int32).cpu().numpy().astype(np.int64)
    starts, ends = words[0:2 * nb:2], words[1:2 * nb:2]
    t0 = starts.min()
    us = lambda v: (v - t0) % 2 ** 32 / 1e3  # noqa: E731
    last_end = us(ends).max()
    fin = [us(words[2 * nb + i]) - last_end for i in range(3)]
    print(f"  probe 2^{rows.bit_length() - 1}: {nb} blocks; starts {np.min(us(starts)):.2f}, "
          f"{np.median(us(starts)):.2f}, {np.max(us(starts)):.2f} us; ends of rows "
          f"{np.min(us(ends)):.2f}, {np.median(us(ends)):.2f}, {last_end:.2f} us; after the last "
          f"end: ticket {fin[0]:.2f}, sums {fin[1]:.2f}, end {fin[2]:.2f} us", flush=True)


if __name__ == "__main__":
    sys.exit(main())
