#!/usr/bin/env python3
"""Time variants of K2-MN's CUDA source against each other on one card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 multiclass_variants.py [--parent PATH] [NAME ...]

Builds ``dask_ml_tpu_torch/csrc/multiclass.cu`` ("current"), each named
variant of it (a text edit, listed in ``VARIANTS``) and, with ``--parent``,
another copy of the source (an earlier tree's whose C interface takes
the mode, the family and the target's class stride), all with ``nvcc`` at
once
into ``dask_ml_tpu_torch/_build/variants/``.  Then it times both K2-MN
variants of each library through ctypes, in turns (the list forward, then
backward), at the multinomial fit's (8, 1.375M, 29), K=4 and at
(1, 1M, 28), K=16: CUDA events over 20 calls, and the MN kernel's and
finalize's own device time from a ``torch.profiler`` window.  Each line
also gives the largest difference of f and g from the first library's,
relative to their largest magnitude, and the launch plan's first words.
The variants that take the compute out give wrong sums on purpose: they
time the copy ring alone.  Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import variants

SRC = variants.CSRC / "multiclass.cu"
SHAPES = {"K4": (8, 1_375_000, 29, 4), "K16": (1, 1_000_000, 28, 16)}
REPS = 20

_FWD_THREE = """#pragma unroll
    for (int n = 0; n < NN; ++n) {
      mma8(acc_lh[n], al, bh[s][n][0], bh[s][n][1]);
      mma8(acc_hl[n], ah, bl[s][n][0], bl[s][n][1]);
      mma8(acc[n], ah, bh[s][n][0], bh[s][n][1]);
    }"""
# name: (what it changes, [(text of the current source, its replacement)])
VARIANTS = {
    "ring": ("each 16-row group returns at once: the copy ring alone", [(
        "  const bool va = FULL || g < nrows, vb = FULL || g + 8 < nrows;\n",
        "  const bool va = FULL || g < nrows, vb = FULL || g + 8 < nrows;\n"
        "  if (nrows > -1) {\n    lsum += lab[g];\n    return;\n  }\n")]),
    "one_acc": ("the forward's three passes into one accumulator", [(
        _FWD_THREE, """#pragma unroll
    for (int n = 0; n < NN; ++n) mma3(acc[n], ah, al, bh[s][n], bl[s][n]);""")]),
    "rows128": ("128-row tiles and as many stages as fit (6 at d = 29)", [(
        "    if ((MN_BUDGET - slab) / (4 * ovr_stage_floats(R, d, 1)) < 3) R /= 2;",
        "    R /= 2;")]),
}


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def build(sources):
    """{name: CDLL}: every source compiled at once."""
    libs = {}
    vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name, (so, _) in variants.compile_all(sources).items():
        lib = ctypes.CDLL(str(so))
        lib.multiclass_plan.argtypes = [i32, i32, ll, ll, i32, i32, i32, vp]
        lib.multiclass_value_and_grad.argtypes = [i32, i32, vp, vp, vp, vp, vp, ll, ll, i32,
                                                  i32, ll, i32, vp, vp, vp, vp, vp]
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="another multiclass.cu to time beside")
    ap.add_argument("names", nargs="*", help=f"variants to time, of {sorted(VARIANTS)}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("multiclass_variants: no CUDA device", file=sys.stderr)
        return 1
    src = SRC.read_text()
    sources = {}
    if args.parent:
        sources["parent"] = args.parent.read_text()
    sources["current"] = src
    for name in args.names:
        sources[name] = variants.edited(src, VARIANTS[name][1], name, SRC.name)
        print(f"{name}: {VARIANTS[name][0]}")
    print(f"card: {card_line()}", flush=True)
    libs = build(sources)

    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for key, (P, m, d, K) in SHAPES.items():
        data[key] = (torch.randn(P, m, d, generator=gen, device="cuda"),
                     torch.randint(0, K, (P, m), generator=gen, device="cuda").float(),
                     torch.ones(P, m, device="cuda"),
                     torch.randn(P, d * K, generator=gen, device="cuda") / d ** 0.5,
                     torch.ones(P, dtype=torch.bool, device="cuda"), K)

    def events_ms(fn):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / REPS

    def device_ms(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA) / 1e3 / REPS

    first = {}
    for name in variants.in_turns(libs):
        lib, row = libs[name], []
        for key, (x, y, mask, B, act, K) in data.items():
            P, m, d = x.shape
            plan = (ctypes.c_longlong * 8)()
            if lib.multiclass_plan(1, 0, P, m, d, K, 0, plan):
                raise RuntimeError(f"{name}: multiclass_plan failed")
            scratch = torch.empty(plan[6], device="cuda")
            f, g = torch.zeros(P, device="cuda"), torch.zeros_like(B)

            def call(grad):
                err = lib.multiclass_value_and_grad(
                    1, 0, x.data_ptr(), y.data_ptr(), mask.data_ptr(), B.data_ptr(),
                    act.data_ptr(), P, m, d, K, 0, int(grad), plan, scratch.data_ptr(),
                    f.data_ptr(), g.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call(True)
            torch.cuda.synchronize()
            ref = first.setdefault(key, (f.clone(), g.clone()))
            df = float((f - ref[0]).abs().max() / ref[0].abs().max())
            dg = float((g - ref[1]).abs().max() / ref[1].abs().max())
            row.append(f"{key} vg {events_ms(lambda: call(True)):.4f} "
                       f"({device_ms(lambda: call(True)):.4f}) v "
                       f"{events_ms(lambda: call(False)):.4f} "
                       f"({device_ms(lambda: call(False)):.4f}) ms, "
                       f"Δf {df:.1e} Δg {dg:.1e}, plan {list(plan)[:5]}")
        print(f"{name:8s} " + " | ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
