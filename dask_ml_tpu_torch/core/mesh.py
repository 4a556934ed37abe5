"""Device policy: the port's counterpart of ``dask_ml_tpu/core/mesh.py``.

The reference places rows on a ``jax.sharding.Mesh`` and pads them to a
multiple of its data-axis size.  The port runs on one device and keeps a
*logical* shard count in its place: rows are padded to a multiple of
``n_shards`` so that pad+mask shapes match the reference's, and a later
multi-process slice can split them.

The default device is ``cuda``.  Without CUDA, ``get_device`` raises
unless the caller has asked for the CPU (``set_device("cpu")``): the port
never falls back to the CPU on its own.  A torch tensor handed to an entry
point keeps its own device whatever the policy says.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_default = {"device": None, "n_shards": 1}
_scoped = threading.local()


def _stack() -> list:
    stack = getattr(_scoped, "stack", None)
    if stack is None:
        stack = _scoped.stack = []
    return stack


def get_device() -> torch.device:
    """The active device: the innermost ``use_device``, else the process
    default, else ``cuda``.  Raises when that is ``cuda`` and there is
    none."""
    for device, _ in reversed(_stack()):
        if device is not None:
            return device
    device = _default["device"]
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dask_ml_tpu_torch runs on CUDA and none is available; "
                "call dask_ml_tpu_torch.core.set_device('cpu') to run on "
                "the CPU"
            )
        return torch.device("cuda")
    return device


def set_device(device) -> None:
    """Replace the process-default device (None resets to ``cuda``)."""
    _default["device"] = None if device is None else torch.device(device)


def get_n_shards() -> int:
    """The logical row-shard count rows are padded to a multiple of."""
    for _, n_shards in reversed(_stack()):
        if n_shards is not None:
            return n_shards
    return _default["n_shards"]


def set_n_shards(n_shards: int) -> None:
    """Replace the process-default logical shard count (default 1)."""
    _default["n_shards"] = _check_shards(n_shards)


def _check_shards(n_shards):
    if n_shards is not None and (int(n_shards) != n_shards or n_shards < 1):
        raise ValueError(f"n_shards must be a positive int, got {n_shards!r}")
    return None if n_shards is None else int(n_shards)


@contextlib.contextmanager
def use_device(device=None, n_shards=None):
    """Scope a device and/or a logical shard count to a ``with`` block."""
    entry = (None if device is None else torch.device(device),
             _check_shards(n_shards))
    stack = _stack()
    stack.append(entry)
    try:
        yield entry[0]
    finally:
        stack.pop()


def current_scope() -> tuple:
    """This thread's ``use_device`` scopes, innermost last, to hand to a
    thread that works for it (:func:`adopt_scope`)."""
    return tuple(_stack())


@contextlib.contextmanager
def adopt_scope(scope):
    """Run a ``with`` block under scopes taken by :func:`current_scope` on
    another thread."""
    stack = _stack()
    depth = len(stack)
    stack.extend(scope)
    try:
        yield
    finally:
        del stack[depth:]
