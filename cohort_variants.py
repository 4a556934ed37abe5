#!/usr/bin/env python3
"""Time variants of K5's CUDA source against each other on one card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 cohort_variants.py [NAME ...]

Builds ``dask_ml_tpu_torch/csrc/cohort.cu`` ("current") and each named
variant of it (a text edit, listed in ``VARIANTS``), all with ``nvcc`` at
once into ``dask_ml_tpu_torch/_build/variants/``, prints each library's
registers and spills for the record kernel, then times each through
``ops/cohort.py``'s wrapper, in turns (the list forward, then backward),
at the search's block (2^20 x 64) and the cohort sizes of ``chip_smoke.py``
phase 11d (CUDA events over 20 calls).  Each variant is held against the
float64 plain version first, as phase 11a holds K5 (``hold_cohort``), at
each shape.  Without a card it exits 1.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "dask_ml_tpu_torch" / "csrc" / "cohort.cu"
OUT = REPO / "dask_ml_tpu_torch" / "_build" / "variants"
ROWS, D = 1 << 20, 64
SHAPES = ((81, 1), (27, 1), (9, 1), (2, 1), (8, 10))

_UNCAP = ("__global__ void __launch_bounds__(T, 2) record_kernel(",
          "__global__ void __launch_bounds__(T) record_kernel(")
_SIMPLE = ("""#pragma unroll
  for (int k0 = 0; k0 < PER; k0 += XB) {
    float v[XB];
#pragma unroll
    for (int k = 0; k < XB; ++k) {""", """#pragma unroll 1
  for (int k0 = 0; k0 < PER; k0 += XB) {
    float v[XB];
#pragma unroll 1
    for (int k = 0; k < XB; ++k) {""")
# name: (what it changes, [(text of the current source, its replacement)])
VARIANTS = {
    "uncapped": ("registers not capped (190: one block a SM)", [_UNCAP]),
    "xb8": ("x's loads 8 at a time", [("constexpr int PER = R * DC / T, XB = 16;",
                                       "constexpr int PER = R * DC / T, XB = 8;")]),
    "xb4": ("x's loads 4 at a time", [("constexpr int PER = R * DC / T, XB = 16;",
                                       "constexpr int PER = R * DC / T, XB = 4;")]),
    "serial": ("x's staging loop not unrolled (a load, then its store)", [_SIMPLE]),
}


def build(names):
    """Every named source compiled with nvcc at once; prints the record
    kernel's registers and spills; returns {name: library path}."""
    sys.path.insert(0, str(REPO))
    import chip_smoke
    from dask_ml_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = SRC.read_text()
        for old, new in VARIANTS.get(name, ("", []))[1]:
            if old not in text:
                raise SystemExit(f"variant {name}: its text is not in {SRC.name}")
            text = text.replace(old, new)
        cu, so = OUT / f"cohort_{name}.cu", OUT / f"libcohort_{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), _build.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-o", str(so), str(cu)], stderr=subprocess.PIPE, text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        for line in sorted(set(chip_smoke.ptxas_lines(err))):
            if "record_kernel" in line:
                print(f"{name}: {line}")
        out[name] = so
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("cohort_variants: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    names = ["current"] + (sys.argv[1:] or list(VARIANTS))
    libs = build(names)
    import chip_smoke as cs
    from dask_ml_tpu_torch.core import set_device
    from dask_ml_tpu_torch.ops import _build, cohort, sgd

    card = cs.card_line()
    device = torch.device("cuda")
    set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = {(M, K): cs.cohort_inputs(torch, ROWS, D, K, M, "log_loss", 500 + M, device)
             for M, K in SHAPES}
    hypers = {(M, K): cs.cohort_hypers(torch, M, device, "log_loss", "optimal")
              for M, K in SHAPES}
    kw = dict(loss="log_loss", penalty="l2", schedule="optimal")
    held = set()
    for name in names + names[::-1]:
        _build._libs["cohort"] = ctypes.CDLL(str(libs[name]))
        cohort._lib = None
        cohort._plans.clear()
        cohort._scratch.clear()
        times = []
        for key in SHAPES:
            x, y, masks, coef, intercept, t = cases[key]
            if name not in held:
                cs.hold_cohort(torch, cohort, sgd, cases[key], hypers[key],
                               f"{name} M={key[0]} K={key[1]}", "log_loss")
            c, b, tt = coef.clone(), intercept.clone(), t.clone()
            times.append(cs.time_ms(torch, lambda: cohort.cohort_step(
                x, y, masks, c, b, tt, hypers[key], **kw), 20))
        held.add(name)
        print(f"{name:12s} " + ", ".join(f"M={M} K={K} {ms:.4f}" for (M, K), ms in
                                        zip(SHAPES, times)) + f" ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
