#!/usr/bin/env python3
"""Time variants of K4's CUDA source against each other on one card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 sgd_variants.py [NAME ...]

Builds ``dask_ml_tpu_torch/csrc/sgd.cu`` ("current") and each named variant
of it (a text edit, listed in ``VARIANTS``), all with ``nvcc`` at once into
``dask_ml_tpu_torch/_build/variants/``, prints each library's registers and
spills for the tensor-core instances, then times each through
``ops/sgd.py``'s wrappers, in turns (the list forward, then backward), at
the 10-class shapes of ``chip_smoke.py`` phase 10c: the update and the loss
of a 2^20 x 64 block and a step of the epoch over its 16 minibatches (CUDA
events over 20 calls; the epoch's time over its steps).  The variants that
take work out give wrong sums on purpose: they time what is left.  Without
a card it exits 1.
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


def build(names):
    """Every named source compiled at once; prints the tensor-core instances'
    registers and spills; returns {name: library path}."""
    import chip_smoke

    text = SRC.read_text()
    built = variants.compile_all({
        f"sgd_{name}": variants.edited(text, VARIANTS.get(name, ("", []))[1], name, SRC.name)
        for name in names})
    out = {}
    for name in names:
        so, err = built[f"sgd_{name}"]
        for line in sorted(set(chip_smoke.ptxas_lines(err))):
            if "tc_kernel<2>" in line or "epoch_kernel<2,2,1>" in line:
                print(f"{name}: {line}")
        out[name] = so
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sgd_variants: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    names = ["current"] + (sys.argv[1:] or list(VARIANTS))
    libs = build(names)
    import chip_smoke as cs
    from dask_ml_tpu_torch.core import set_device
    from dask_ml_tpu_torch.ops import sgd

    card = cs.card_line()
    device = torch.device("cuda")
    set_device(device)
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


if __name__ == "__main__":
    sys.exit(main())
