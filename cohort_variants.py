#!/usr/bin/env python3
"""Time variants of K5's CUDA source against each other on one card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 cohort_variants.py [NAME ...]

Builds ``dask_ml_tpu_torch/csrc/cohort.cu`` ("current") and each named
variant of it (a text edit of one of the ring path's shape constants or
of its plan, listed in ``VARIANTS``), all with ``nvcc`` at once into
``dask_ml_tpu_torch/_build/variants/``, prints each library's registers and
spills for the record kernels, then times each through ``ops/cohort.py``'s
wrapper, in turns (the list forward, then backward), at the search's block
(2^20 x 64) and the cohort sizes of ``chip_smoke.py`` phase 11d
(``queued_ms`` over 20 calls).  Each variant is held against the float64
plain version first, as phase 11a holds K5 (``hold_cohort``), at each
shape; one that fails its hold is reported and not timed.  The skeletons
(``SKELETONS``) drop a part of the work and are timed without a hold.
Without a card it exits 1.
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


def _switch(name, old, new):
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


# name: (what it changes, [(text of the current source, its replacement)])
VARIANTS = {
    "s3": ("three stages in the ring, not two", [_switch("RING_S", 2, 3)]),
    "r64": ("64 rows a tile, not 128 (2 rows a group where CT <= 8)",
            [_switch("RING_R", 128, 64)]),
    "noloss": ("skeleton: the loss terms replaced by (margin, y*epsilon)",
               [("const Terms tr = L::terms(v[u] + cc.x, ys[row * K + k], cc.y);",
                 "const Terms tr = {v[u] + cc.x, ys[row * K + k] * cc.y};")]),
    "nograd": ("skeleton: the gradient's products dropped (its mask*dl loads kept)",
               [("for (int u = 0; u < TC; ++u) g[f][u] = fmaf(xr[f], wv[u], g[f][u]);",
                 "for (int u = 0; u < TC; ++u) g[f][u] += wv[u];")]),
    "noshfl": ("skeleton: the margins' shuffle sums dropped",
               [("      halve<V / 2>(v, lane, 4);\n      halve<V / 4>(v, lane, 2);\n"
                 "      halve<V / 8>(v, lane, 1);\n", "")]),
    "nofin": ("skeleton: the ring path's records alone (no finish)",
              [("  coop_finish(a);\n}", "}")]),
    "ct16": ("CT = 16 at M*K = 5..8, not 8", [_switch("CT8_MAX_C", 8, 4)]),
    "no12": ("CT = 16 (four slices of 4) at M*K = 9..12, not 12 (four of 3)",
             [_switch("CT12_MAX_C", 12, 8)]),
    "tile": ("M*K > 16 on the tile path (256 x 16 tiles), not the ring's column tiles",
             [("  if (d <= DC && K <= RING_MAX_K) {",
               "  if (d <= DC && K <= RING_MAX_K && C <= 16) {")]),
}


SKELETONS = ("noloss", "nograd", "noshfl", "nofin")


def build(names):
    """Every named source compiled with nvcc at once; prints the record
    kernels' registers and spills; returns {name: library path}."""
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
            if "LogLoss" in line and "registers" in line:
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
    shapes = cs.COHORT_TIMES
    cases = {(M, K): cs.cohort_inputs(torch, ROWS, D, K, M, "log_loss", 500 + M, device)
             for M, K in shapes}
    hypers = {(M, K): cs.cohort_hypers(torch, M, device, "log_loss", "optimal")
              for M, K in shapes}
    kw = dict(loss="log_loss", penalty="l2", schedule="optimal")
    held, failed = set(), set()
    for name in names + names[::-1]:
        if name in failed:
            continue
        _build._libs["cohort"] = ctypes.CDLL(str(libs[name]))
        cohort._lib = None
        cohort._plans.clear()
        cohort._scratch.clear()
        times = []
        for key in shapes:
            x, y, masks, coef, intercept, t = cases[key]
            if name not in held and name not in SKELETONS:
                try:
                    cs.hold_cohort(torch, cohort, sgd, cases[key], hypers[key],
                                   f"{name} M={key[0]} K={key[1]}", "log_loss")
                except (AssertionError, RuntimeError) as exc:
                    print(f"{name}: not held, not timed: {exc}", flush=True)
                    failed.add(name)
                    break
            c, b, tt = coef.clone(), intercept.clone(), t.clone()
            times.append(cs.queued_ms(torch, lambda: cohort.cohort_step(
                x, y, masks, c, b, tt, hypers[key], **kw), 20))
        if name in failed:
            continue
        held.add(name)
        print(f"{name:8s} " + ", ".join(f"M={M} K={K} {ms:.4f}" for (M, K), ms in
                                       zip(shapes, times)) + f" ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
