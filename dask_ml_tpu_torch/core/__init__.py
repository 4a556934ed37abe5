"""Device policy, padded row collections and random state."""

from .mesh import get_device, get_n_shards, set_device, set_n_shards, use_device
from .prng import as_generator
from .sharded import (
    ShardedRows,
    masked_mean,
    masked_sum,
    masked_var,
    pad_rows,
    shard_rows,
    unshard,
)

__all__ = [
    "ShardedRows", "as_generator", "get_device", "get_n_shards",
    "masked_mean", "masked_sum", "masked_var", "pad_rows", "set_device",
    "set_n_shards", "shard_rows", "unshard", "use_device",
]
