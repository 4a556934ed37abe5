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

import sys

import variants

SRC = variants.CSRC / "cohort.cu"
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
    """Every named source compiled at once; prints the record kernels'
    registers and spills; returns {name: library path}."""
    import chip_smoke

    text = SRC.read_text()
    built = variants.compile_all({
        f"cohort_{name}": variants.edited(text, VARIANTS.get(name, ("", []))[1], name,
                                          SRC.name)
        for name in names})
    out = {}
    for name in names:
        so, err = built[f"cohort_{name}"]
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
    from dask_ml_tpu_torch.ops import cohort, sgd

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
    for name in variants.in_turns(names):
        if name in failed:
            continue
        variants.swap(cohort, "cohort", libs[name], cohort._plans, cohort._scratch)
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
