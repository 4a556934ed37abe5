"""What the kernel-variant harnesses (``sgd_variants.py``,
``cohort_variants.py``, ``multiclass_variants.py``, ``k7k10_variants.py``)
share: a variant is a CUDA source of ``dask_ml_tpu_torch/csrc/`` with text
edits; every variant is compiled with ``nvcc`` at once into
``dask_ml_tpu_torch/_build/variants/``; a built library is swapped in under
its wrapper in ``dask_ml_tpu_torch/ops/``; and the variants are timed in
turns, the list forward then backward.  Nothing here needs a card until a
library is loaded.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent
CSRC = REPO / "dask_ml_tpu_torch" / "csrc"
OUT = REPO / "dask_ml_tpu_torch" / "_build" / "variants"


def edited(text, edits, name, where):
    """``text`` with each (old, new) of ``edits`` applied; exits where an
    old text is not in it (the source moved on since the variant was
    written)."""
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"variant {name}: its text is not in {where}")
        text = text.replace(old, new)
    return text


def compile_all(sources):
    """{name: CUDA source text} compiled with ``nvcc`` for sm_90a, one
    process each, all started together; returns {name: (library path,
    ptxas report)}."""
    sys.path.insert(0, str(REPO))
    from dask_ml_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(text)
        cmd = [_build._nvcc(), _build.ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{err}")
        out[name] = (so, err)
    return out


def swap(module, src, so, *caches):
    """Point ``module``, the wrapper of ``csrc/<src>.cu``, at the library
    ``so``, and empty its plan and scratch ``caches``; returns the library."""
    from dask_ml_tpu_torch.ops import _build

    _build._libs[src] = ctypes.CDLL(str(so))
    module._lib = None
    for cache in caches:
        cache.clear()
    return _build._libs[src]


def in_turns(names):
    """The order of timing: ``names`` forward, then backward."""
    return list(names) + list(names)[::-1]
