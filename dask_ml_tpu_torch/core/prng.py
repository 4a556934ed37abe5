"""Random state: the port's counterpart of ``dask_ml_tpu/core/prng.py``.

``jax.random`` keys become explicit ``torch.Generator``s.  The two give
different numbers from the same seed, so the port is held to the
reference by the quality of what it draws, not by its bits.
"""

from __future__ import annotations

import numbers

import numpy as np
import torch

from .mesh import get_device


def as_generator(random_state, device=None) -> torch.Generator:
    """Normalize ``random_state`` (None | int | RandomState | Generator)
    into a ``torch.Generator`` on ``device`` (default: the active one).

    ``None`` is seed 0, deterministic like the reference's ``as_key``.
    """
    if isinstance(random_state, torch.Generator):
        return random_state
    if random_state is None:
        seed = 0
    elif isinstance(random_state, numbers.Integral):
        seed = int(random_state)
    elif isinstance(random_state, np.random.RandomState):
        seed = int(random_state.randint(0, 2**31 - 1))
    else:
        raise ValueError(
            f"Cannot interpret {type(random_state).__name__!r} as a random "
            "state; pass None, an int seed, a numpy RandomState, or a "
            "torch.Generator."
        )
    device = torch.device(device) if device is not None else get_device()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen
