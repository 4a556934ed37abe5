#!/usr/bin/env python3
"""Time variants of K2-MN's and K2-OvR's CUDA source against each other on
one card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 multiclass_variants.py [--parent PATH] [NAME ...]

Builds ``dask_ml_tpu_torch/csrc/multiclass.cu`` ("current"), each named
variant of it (a text edit, listed in ``VARIANTS``) and, with ``--parent``,
another copy of the source (an earlier tree's whose C interface takes
the mode, the family and the target's class stride), all with ``nvcc`` at
once
into ``dask_ml_tpu_torch/_build/variants/``.  Then it times both variants
(value and gradient, value only) of each library through ctypes, in turns
(the list forward, then backward), at each shape of ``SHAPES``: K2-MN at
the multinomial fit's (8, 1.375M, 29), K=4 and at (1, 1M, 28), K=16,
K2-OvR over one shared target at the sweeps' (8, 916667, 29), L=8 with
the logistic family (13a's) and L=5 with the Normal one (13c's), and
K2-OvR on targets of its own at the packed fit's (8, 1.375M, 29), K=4
and bench.py's A/B (1, 1M, 28), K=16: CUDA
events over 20 calls, and the kernels' own device time (every device
event of a ``torch.profiler`` window).  Each line also gives the largest
difference of f and g from the first library's, relative to their
largest magnitude, and the launch plan's first words.  The variants that
take the compute out give wrong sums on purpose: they time the copy ring
alone.  With ``--sass`` it first prints, for each library, the SASS
instructions of each ``tc_kernel`` instance at d = 29 and one n-tile, by
opcode (``cuobjdump``).  Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import variants

SRC = variants.CSRC / "multiclass.cu"
# name: (mode: 1 K2-MN, 0 K2-OvR; family: 0 logistic, 1 normal; K2-OvR's
# target: one shared by the lanes or K of their own; (P, m, d); classes or
# lanes)
SHAPES = {"K4": (1, 0, False, (8, 1_375_000, 29), 4),
          "K16": (1, 0, False, (1, 1_000_000, 28), 16),
          "L8": (0, 0, True, (8, 916_667, 29), 8), "L5": (0, 1, True, (8, 916_667, 29), 5),
          "O4": (0, 0, False, (8, 1_375_000, 29), 4),
          "O16": (0, 0, False, (1, 1_000_000, 28), 16)}
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
        "  if (nrows > -1) {\n    lsum[0][0] += lab[g];\n    return;\n  }\n")]),
    "one_acc": ("the forward's three passes into one accumulator", [(
        _FWD_THREE, """#pragma unroll
    for (int n = 0; n < NN; ++n) mma3(acc[n], ah, al, bh[s][n], bl[s][n]);""")]),
    "noterms": ("the shared path's terms by the Normal family's whatever the family", [(
        "          const RowTerms rt = Fam::terms(acc[n][2 * r + c], yv, mv);",
        "          const RowTerms rt = Normal::terms(acc[n][2 * r + c], yv, mv);")]),
    "fastterms": ("the logistic terms by __expf, __logf and __fdividef (informational)", [(
        """    const float e = expf(-fabsf(eta));
    const float sp = fmaxf(eta, 0.f) + log1pf(e);
    const float sig = eta >= 0.f ? 1.f / (1.f + e) : e / (1.f + e);""",
        """    const float e = __expf(-fabsf(eta));
    const float sp = fmaxf(eta, 0.f) + __logf(1.f + e);
    const float sig = eta >= 0.f ? __fdividef(1.f, 1.f + e) : __fdividef(e, 1.f + e);""")]),
    "cpasync": ("the shared path's misaligned runs by the threads' cp.async, as ovr_kernel's",
                [("  constexpr bool ANY = Terms::PER_LANE;", "  constexpr bool ANY = false;")]),
    "mn_bulk": ("K2-MN's runs staged by bulk copy too, as the shared path's are",
                [("  constexpr bool ANY = Terms::PER_LANE;", "  constexpr bool ANY = true;")]),
    "one_gacc": ("the gradient's passes into one accumulator for every family", [(
        "  constexpr int GP = Terms::GRAD3 && NN == 1 ? 3 : 1;", "  constexpr int GP = 1;")]),
    "three_gacc": ("the gradient's passes into three accumulators for both families", [(
        "  constexpr int GP = Terms::GRAD3 && NN == 1 ? 3 : 1;",
        "  constexpr int GP = Terms::PER_LANE && NN == 1 ? 3 : 1;")]),
    "nocopy": ("the compute alone: the ring filled once, never refilled (the tiles computed "
               "on stale stages)", [(
        """      stage_tile<ANY>(smem + s * stage_floats, bar + s, xl + tn * R * d, rn * d, yl + tn * R,
                      0, ml + tn * R, rn, R, 1, yoff, 1u);""",
        """      if (threadIdx.x == 0 && rn > 0) mbar_arrive_tx(bar + s, 0u);
      mbar_arrive_cp_async(bar + s);""")]),
    "rows128": ("128-row tiles and as many stages as fit (6 at d = 29)", [(
        "  if ((TC_BUDGET - slab) / (4 * ovr_stage_floats(R, d, 1)) < 3) R /= 2;",
        "  R /= 2;")]),
}


def sass_counts(so):
    """{tc_kernel instance at NKS = 4, NN = 1: (instructions, Counter of
    opcodes)} of the library ``so``, from ``cuobjdump -sass``."""
    import collections
    import re

    from dask_ml_tpu_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = part.split("\n", 1)
        m = re.search(r"tc_kernel\w*?(7Softmax|8Logistic|6Normal)\w*?Li4ELi1ELb([01])E", name)
        if not m:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)", body)
        out[f"{m.group(1).lstrip('0123456789')}{'_grad' if m.group(2) == '1' else ''}"] = (
            len(ops), collections.Counter(ops))
    return out


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
    ap.add_argument("--sass", action="store_true",
                    help="print the tc_kernel instances' SASS instructions by opcode first")
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
    if args.sass:
        for name in sources:
            for inst, (n, ops) in sass_counts(variants.OUT / f"lib{name}.so").items():
                print(f"sass {name} {inst}: {n} instructions, " + ", ".join(
                    f"{op} {ops[op]}" for op in ("HMMA", "MUFU", "LDS", "STS", "FFMA", "FADD",
                                                 "FMUL", "SHFL", "BAR", "BRA")), flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for key, (mode, fam, shared, (P, m, d), K) in SHAPES.items():
        x = torch.randn(P, m, d, generator=gen, device="cuda")
        if mode == 1:  # class indices, B (P, d*K), a lane a shard
            y = torch.randint(0, K, (P, m), generator=gen, device="cuda").float()
            B = torch.randn(P, d * K, generator=gen, device="cuda") / d ** 0.5
        else:  # targets (0/1 or real), one or K; B (K*P, d), a lane a (k, shard)
            y = torch.rand((P, m) if shared else (K, P, m), generator=gen, device="cuda")
            y = (y < 0.4).float() if fam == 0 else 2.0 * y
            B = torch.randn(K * P, d, generator=gen, device="cuda") / d ** 0.5
        lanes = P if mode == 1 else K * P
        data[key] = (mode, fam, shared, x, y, torch.ones(P, m, device="cuda"), B,
                     torch.ones(lanes, dtype=torch.bool, device="cuda"), K)

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
        for key, (mode, fam, shared, x, y, mask, B, act, K) in data.items():
            P, m, d = x.shape
            ystride = 0 if mode == 1 or shared else P * m
            plan = (ctypes.c_longlong * 8)()
            if lib.multiclass_plan(mode, fam, P, m, d, K, int(shared), plan):
                raise RuntimeError(f"{name}: multiclass_plan failed")
            scratch = torch.empty(plan[6], device="cuda")
            f, g = torch.zeros(act.shape[0], device="cuda"), torch.zeros_like(B)

            def call(grad):
                err = lib.multiclass_value_and_grad(
                    mode, fam, x.data_ptr(), y.data_ptr(), mask.data_ptr(), B.data_ptr(),
                    act.data_ptr(), P, m, d, K, ystride, int(grad), plan, scratch.data_ptr(),
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
