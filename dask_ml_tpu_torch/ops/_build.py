"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``_build/`` beside
the package (git-ignored), and loaded with ``ctypes``.  A library is
named by the hash of its source, so an edited source is rebuilt and an
unchanged one is loaded as it is.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found: put the CUDA toolkit's bin on PATH or set CUDA_HOME"
        )
    return str(path)


def _library(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(names) -> dict:
    """Compile the named sources, one ``nvcc`` each, all started together,
    and load them; returns {name: ctypes.CDLL}.  ``nvcc``'s register and
    spill report goes to ``_build/<name>.ptxas.txt``."""
    with _lock:
        jobs = {}
        for name in names:
            out = _library(name)
            if name in _libs or out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                           text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in jobs.items():
            _, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}.cu ({proc.returncode}):\n{err}")
                continue
            (BUILD_DIR / f"{name}.ptxas.txt").write_text(err)
            os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(_library(name)))
        return {n: _libs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build([name])[name]
