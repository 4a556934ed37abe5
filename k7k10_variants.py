#!/usr/bin/env python3
"""Time variants of K7's and K10's CUDA sources against each other on one card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 k7k10_variants.py [NAME ...]

Builds ``dask_ml_tpu_torch/csrc/minibatch.cu``, ``pairwise.cu`` and
``lloyd.cu`` ("current") and each named variant (a text edit of one of
them, listed in ``VARIANTS``), all with ``nvcc`` at once into
``dask_ml_tpu_torch/_build/variants/``, prints each library's registers and
spills, then times each through its wrapper (``ops/minibatch.py ::
mbk_epoch`` and ``mbk_step``, ``ops/pairwise.py :: sq_euclidean_safe``), in
turns (the list forward, then backward), at ``chip_smoke.py`` phase 14c's
shapes on make_blobs rows: K7b over 1024 steps of 1024 rows of 2^20 x 50 at
k = 8, K10 ``sq`` at 2^20 x 1024 and ``rbf`` at 10M x 100, K7a (K1a with
the update as its epilogue, ``lloyd.cu``) on 14b's block of 2^20 x 50 at
k = 8 and over 1024 steps of the stepped epoch at k = 64 (``time_ms`` over
10 calls; the step's also ``queued_ms``).  Each variant but a skeleton is
held against its plain version first (K7a bitwise against K1a then K7a's
plain version); the
skeletons (``SKELETONS``) drop a part of the work and are timed unheld.  The
probes (``PROBES``) add ``clock64`` timers to thread 0 of every CTA and
print the cycles of each phase a step (K7b) or a tile (K10), summed over
the CTAs and divided by the steps or tiles they ran.  Without a card it
exits 1.
"""

from __future__ import annotations

import ctypes
import sys

import variants

REPS = 10

# clock64 timers of thread 0 of a CTA, summed over the CTAs into g_prof;
# g_prof[15] counts the CTAs that flushed
PROF_HEADER = r"""
__device__ unsigned long long g_prof[16];
#define PROF_DECL unsigned long long _pt = clock64(); unsigned long long _acc[12] = {0};
#define PROF(i) { const unsigned long long _n = clock64(); _acc[i] += _n - _pt; _pt = _n; }
#define PROF_FLUSH() if (threadIdx.x == 0) { for (int _i = 0; _i < 12; ++_i) atomicAdd(&g_prof[_i], _acc[_i]); atomicAdd(&g_prof[15], 1ull); }
extern "C" int prof_read(void* host) { return (int)cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof)); }
extern "C" int prof_zero() { static unsigned long long z[16]; return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }
"""
INCLUDES_END = "#include <stdint.h>\n"

K7B_PHASES = ("assign", "barrier after the assign", "reduce", "barrier after it",
              "merge, partials sent", "owner: inbox wait", "owner: update, centres sent",
              "copies, barrier", "centres wait")
K7B_PROBE = [
    (INCLUDES_END, INCLUDES_END + PROF_HEADER),
    ("  for (long long unit = 0; unit < total; ++unit) {\n",
     "  PROF_DECL\n  for (long long unit = 0; unit < total; ++unit) {\n"),
    ("    __syncthreads();  // every row's label and weight are written\n",
     "    PROF(0)\n    __syncthreads();  // every row's label and weight are written\n    PROF(1)\n"),
    ("    __syncthreads();  // every row group's partial is written\n",
     "    PROF(2)\n    __syncthreads();  // every row group's partial is written\n    PROF(3)\n"),
    ("    const unsigned parity = (unsigned)(step & 1);\n",
     "    PROF(4)\n    const unsigned parity = (unsigned)(step & 1);\n"),
    ("      mbar_wait(bar_in, parity);\n", "      mbar_wait(bar_in, parity);\n      PROF(5)\n"),
    ("    issue();  // into the stage the last unit read\n",
     "    PROF(6)\n    issue();  // into the stage the last unit read\n"),
    ("    if (last) {\n      // every centre of the step has come in;",
     "    PROF(7)\n    if (last) {\n      // every centre of the step has come in;"),
    ("      mbar_wait(bar_ctr, parity);\n", "      mbar_wait(bar_ctr, parity);\n      PROF(8)\n"),
    ("  cp_async_wait<0>();\n\n  inert = warp_sum(inert);",
     "  PROF_FLUSH()\n  cp_async_wait<0>();\n\n  inert = warp_sum(inert);"),
]
K10_PHASES = ("copies landed, barrier", "band centred and transposed", "products",
              "epilogue and stores")
K10_PROBE = [
    (INCLUDES_END, INCLUDES_END + PROF_HEADER),
    ("  unsigned nflag = 0;\n  for (long long tile = t0; tile < t1; ++tile) {\n",
     "  unsigned nflag = 0;\n  PROF_DECL\n  for (long long tile = t0; tile < t1; ++tile) {\n"),
    ("    __syncthreads();  // this tile's copies have landed, from every thread; the last tile "
     "is done\n",
     "    __syncthreads();  // this tile's copies have landed, from every thread; the last tile "
     "is done\n    PROF(0)\n"),
    ("    if (!resident && tile + 1 < t1)\n", "    PROF(1)\n    if (!resident && tile + 1 < t1)\n"),
    ("    nflag += epilogue<TX, KIND>(a, acc, xs, ys, xn_s, yn_s, ty, tx, r0, c0);\n",
     "    PROF(2)\n    nflag += epilogue<TX, KIND>(a, acc, xs, ys, xn_s, yn_s, ty, tx, r0, c0);\n"
     "    PROF(3)\n"),
    ("  cp_async_wait_all();\n  if (nflag) atomicAdd(nflag_s, nflag);",
     "  PROF_FLUSH()\n  cp_async_wait_all();\n  if (nflag) atomicAdd(nflag_s, nflag);"),
]

# name: (source, what it changes, [(text of the current source, its replacement)])
VARIANTS = {
    "k7probe": ("minibatch", "clock64 timers of K7b's phases", K7B_PROBE),
    "k7sw": ("minibatch", "the reduce adds a row by a warp-uniform switch on its label",
             [("#pragma unroll\n        for (int c = 0; c < KR; ++c)\n          if (lab == c) racc[c] "
               "+= v;\n",
               "#define K7_CASE(i) case i: if constexpr (i < KR) racc[i] += v; break;\n"
               "        switch (lab) {\n"
                    "          K7_CASE(0)\n"
                    "          K7_CASE(1)\n"
                    "          K7_CASE(2)\n"
                    "          K7_CASE(3)\n"
                    "          K7_CASE(4)\n"
                    "          K7_CASE(5)\n"
                    "          K7_CASE(6)\n"
                    "          K7_CASE(7)\n"
                    "          K7_CASE(8)\n"
                    "          K7_CASE(9)\n"
                    "          K7_CASE(10)\n"
                    "          K7_CASE(11)\n"
                    "          K7_CASE(12)\n"
                    "          K7_CASE(13)\n"
                    "          K7_CASE(14)\n"
                    "          K7_CASE(15)\n"
               "        }\n")]),
    "k7q8": ("minibatch", "eight threads a row pair in the assign, not four",
             [("constexpr int Q = 4;", "constexpr int Q = 8;")]),
    "k7q16": ("minibatch", "sixteen threads a row pair in the assign, not four",
              [("constexpr int Q = 4;", "constexpr int Q = 16;")]),
    "k10probe": ("pairwise", "clock64 timers of band_kernel's phases", K10_PROBE),
    "k10st": ("pairwise", "plain stores in band_kernel's epilogue, not streaming (__stcs)",
              [("        __stcs(reinterpret_cast<float4*>(orow + gc0), make_float4(v[0], v[1], v[2], "
                "v[3]));\n      } else {\n#pragma unroll\n        for (int u = 0; u < 4; ++u)\n"
                "          if (gc0 + u < a.m) __stcs(orow + gc0 + u, v[u]);\n      }\n    }\n  }\n"
                "  return nflag;",
                "        *reinterpret_cast<float4*>(orow + gc0) = make_float4(v[0], v[1], v[2], "
                "v[3]);\n      } else {\n#pragma unroll\n        for (int u = 0; u < 4; ++u)\n"
                "          if (gc0 + u < a.m) orow[gc0 + u] = v[u];\n      }\n    }\n  }\n"
                "  return nflag;")]),
    "k10wide": ("pairwise", "the 128-column tile for m <= 104 too",
                [("int tile_cols(long long m) { return m <= NARROW_TX * TN ? NARROW_TX * TN : "
                  "WIDE_BN; }", "int tile_cols(long long) { return WIDE_BN; }")]),
    "k10nost": ("pairwise", "skeleton: band_kernel's epilogue computes but stores nothing",
                [("      if (a.vec && gc0 + 3 < a.m) {\n        __stcs(reinterpret_cast<float4*>(orow + "
                  "gc0), make_float4(v[0], v[1], v[2], v[3]));\n      } else {\n#pragma unroll\n"
                  "        for (int u = 0; u < 4; ++u)\n          if (gc0 + u < a.m) __stcs(orow + gc0 + "
                  "u, v[u]);\n      }\n    }\n  }\n  return nflag;",
                  "      if (v[0] == -1.f) {\n        __stcs(reinterpret_cast<float4*>(orow + "
                  "gc0), make_float4(v[0], v[1], v[2], v[3]));\n      }\n    }\n  }\n"
                  "  return nflag;")]),
    "k10fexp": ("pairwise", "skeleton: __expf (ex2.approx) in place of expf",
                [("return KIND == 0 ? d2 : KIND == 1 ? sqrtf(d2) : expf(neg_gamma * d2);",
                  "return KIND == 0 ? d2 : KIND == 1 ? sqrtf(d2) : __expf(neg_gamma * d2);")]),
    "k7a_unroll4": ("lloyd", "the fused finish's sums 4 loads deep, not 32",
                    [("#pragma unroll 32", "#pragma unroll 4")]),
    "k7a_unroll16": ("lloyd", "the fused finish's sums 16 loads deep, not 32",
                     [("#pragma unroll 32", "#pragma unroll 16")]),
    "k7a_nohelp": ("lloyd", "skeleton: no mass sums beside the element sums",
                   [("      if (mass) {\n#pragma unroll 32", "      if (false) {\n#pragma unroll 32")]),
    "k7a_noupdate": ("lloyd", "skeleton: the element sums alone, as finalize_kernel",
                     [("    if (t >= FU || e >= rec) continue;\n    out[e] = sum;",
                       "    if (t >= FU || e >= rec) continue;\n    out[e] = sum;\n    continue;")]),
    "k7a_late": ("lloyd", "the fused finish reads the old state after its sums",
                 [("    float hi = mass ? counts[c] : 0.f, lo = mass ? counts[k + c] : 0.f;\n"
                   "    const float old = t < FU && e < kd ? centers[e] : 0.f;\n",
                   "    float hi = 0.f, lo = 0.f;\n"),
                  ("        inv_s[t - FU] = kahan_inv(sum, hi, lo);",
                   "        hi = counts[c];\n        lo = counts[k + c];\n"
                   "        inv_s[t - FU] = kahan_inv(sum, hi, lo);"),
                  ("      new_centers[e] = sculley(old, sum, bm_s[i], inv_s[i]);",
                   "      new_centers[e] = sculley(centers[e], sum, bm_s[i], inv_s[i]);"),
                  ("    } else if (mass) {\n      kahan_inv(sum, hi, lo);",
                   "    } else if (mass) {\n      hi = counts[c];\n      lo = counts[k + c];\n"
                   "      kahan_inv(sum, hi, lo);")]),
}
SKELETONS = ("k10fexp", "k10nost", "k7a_nohelp", "k7a_noupdate")
PROBES = {"k7probe": K7B_PHASES, "k10probe": K10_PHASES}


def build(names):
    """Every named variant compiled at once; prints each one's registers and
    spills; returns {name: (source, library path)}."""
    sources = {}
    for name in names:
        src, _, edits = VARIANTS[name]
        sources[name] = variants.edited((variants.CSRC / f"{src}.cu").read_text(), edits, name,
                                        f"{src}.cu")
    out = {}
    for name, (so, err) in variants.compile_all(sources).items():
        for line in err.splitlines():
            if "Used" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
        out[name] = (VARIANTS[name][0], so)
    return out


def use(src, lib_path):
    """Point the wrapper of ``src`` at the library at ``lib_path``."""
    from dask_ml_tpu_torch.ops import lloyd, minibatch, pairwise

    module = {"minibatch": minibatch, "pairwise": pairwise, "lloyd": lloyd}[src]
    return variants.swap(module, src, lib_path)


def main():
    import torch

    if not torch.cuda.is_available():
        print("k7k10_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from dask_ml_tpu_torch.core import set_device
    from dask_ml_tpu_torch.ops import _build, lloyd, minibatch, pairwise

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    set_device(device)
    card = cs.card_line()
    names = sys.argv[1:] or list(VARIANTS)
    _build.build(["minibatch", "pairwise", "lloyd"])
    libs = {"current minibatch": ("minibatch", _build._library("minibatch")),
            "current pairwise": ("pairwise", _build._library("pairwise")),
            "current lloyd": ("lloyd", _build._library("lloyd"))}
    libs.update(build(names))

    X, truth = cs.make_blobs(torch, cs.SPECTRAL_ROWS, cs.MAIN_D, cs.MBK_K, 0, device)
    x1, m1 = X[:cs.STREAM_ROWS], torch.ones(cs.STREAM_ROWS, device=device)
    k7 = (truth + 0.5, torch.zeros(2, cs.MBK_K, device=device), x1, m1, cs.EPOCH_CHECK_START,
          cs.MBK_BATCH, cs.EPOCH_CHECK_STEPS)
    px, py = X[:cs.PAIR_ROWS], X[-cs.PAIR_M:]
    sample = cs.spectral_sample(torch, X)
    pair = torch.stack([torch.full((cs.MBK_K,), 2.0 ** 25, device=device),
                        torch.full((cs.MBK_K,), 0.25, device=device)])
    k7a = (truth + 0.5, pair, x1, m1)
    c64 = X[cs.STREAM_ROWS:cs.STREAM_ROWS + 64].clone()
    k7a64 = (c64, torch.zeros(2, 64, device=device), x1, m1, cs.EPOCH_CHECK_START, cs.MBK_BATCH,
             cs.EPOCH_CHECK_STEPS)
    k10 = {"sq": (px, py, 0, 0, False, "sq", None),
           "rbf": (X, sample, 0, 0, False, "rbf", 1.0 / cs.MAIN_D)}

    def runs(label):
        src = libs[label][0]
        if src == "minibatch":
            return {"K7b 1024 steps": lambda: minibatch.mbk_epoch(*k7)}
        if src == "lloyd":
            return {"K7a step": lambda: minibatch.mbk_step(*k7a),
                    "K7a k=64 1024": lambda: minibatch.mbk_epoch(*k7a64)}
        return {f"K10 {k}": (lambda a=a: pairwise.sq_euclidean_safe(*a)) for k, a in k10.items()}

    def hold(label):
        src = libs[label][0]
        if src == "minibatch":
            got, want = minibatch.mbk_epoch(*k7), minibatch.mbk_epoch_ref(*k7)
            err = float((got[0] - want[0]).abs().max()) / float(want[0].abs().max())
            return err <= 1e-5, f"centres within {err:.3g} of max|c|"
        if src == "lloyd":
            got = minibatch.mbk_step(*k7a)
            sums, bmass, inertia = lloyd.lloyd_assign_reduce(x1, m1, k7a[0])
            want = (*minibatch.mbk_update_ref(sums, bmass, *k7a[:2]), inertia)
            ok = all(torch.equal(a, b) for a, b in zip(got, want))
            return ok, f"{'bit-equal' if ok else 'not bit-equal'} to K1a then K7a's plain version"
        worst = 0.0
        for a in k10.values():
            got = pairwise.sq_euclidean_safe(*a)
            want, _ = pairwise.sq_euclidean_safe_ref(*a)
            worst = max(worst, float((got - want).abs().max()))
            del got, want
        return True, f"max abs difference {worst:.3g}"

    order = list(libs)
    times = {label: {} for label in order}
    held = {}
    for label in order:
        lib = use(*libs[label])
        if label.startswith("current") or label not in SKELETONS:
            ok, what = hold(label)
            held[label] = ok
            print(f"{label}: {what}{'' if ok else ' -- FAILS its hold, not timed'}", flush=True)
    for label in variants.in_turns(order):
        if not held.get(label, True):
            continue
        lib = use(*libs[label])
        probe = label in PROBES
        if probe:
            lib.prof_read.argtypes = [ctypes.c_void_p]
            lib.prof_zero()
        for what, fn in runs(label).items():
            if probe:
                lib.prof_zero()
            ms = cs.time_ms(torch, fn, REPS)
            times[label].setdefault(what, []).append(ms)
            if what == "K7a step":
                times[label].setdefault("K7a step queued", []).append(
                    cs.queued_ms(torch, fn, REPS))
                per = cs.by_kernel(cs.device_events(torch, fn, REPS), REPS)
                times[label].setdefault("K7a finish", []).append(
                    per.get("finalize_update_kernel", (float("nan"), 0))[0])
            if probe:
                buf = (ctypes.c_ulonglong * 16)()
                lib.prof_read(ctypes.addressof(buf))
                if what.startswith("K7b"):  # a CTA's thread 0, a step
                    per, unit = buf[15] * cs.EPOCH_CHECK_STEPS, "a step (thread 0 of a CTA)"
                else:  # thread 0 of the CTA that ran it, a tile
                    n, m = k10[what.split()[1]][0].shape[0], k10[what.split()[1]][1].shape[0]
                    bn = 104 if m <= 104 else 128
                    per = (REPS + 1) * -(-n // 128) * -(-m // bn)
                    unit = f"a tile ({buf[15] // (REPS + 1)} CTAs)"
                phases = PROBES[label]
                parts = ", ".join(f"{p} {buf[i] / per:.0f}" for i, p in enumerate(phases))
                total = sum(buf[i] for i in range(len(phases))) / per
                print(f"  {label} {what}: cycles {unit}: {parts} (total {total:.0f})", flush=True)
    for label in order:
        for what, ms in times[label].items():
            print(f"{label:18s} {what:16s} " + ", ".join(f"{v:.4f}" for v in ms)
                  + f" ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
