"""The per-epoch shuffle as key-derived permutations: the port of
``dask_ml_tpu/data/shuffle.py``, bit-identical to it.

An epoch's order is a pure function of (key, epoch), so no shuffle buffer
exists and a resumed or restarted stream replays the same order:

* ``epoch_key   = fold_in(key, epoch)``;
* ``shard order = permutation(fold_in(epoch_key, SHARD_ORDER_SALT))``;
* ``block order = permutation(fold_in(epoch_key, shard))`` for each shard.

``fold_in`` is a pure-numpy Threefry-2x32 equal bit for bit to
``jax.random.fold_in`` on the same ``uint32[2]`` key data, and
``permutation`` seeds numpy's counter-based Philox generator with the
folded 64 bits.  Keys are ``uint32[2]`` arrays or integer seeds.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "key_from_seed",
    "as_key",
    "threefry2x32",
    "fold_in",
    "permutation",
    "EpochPlan",
    "epoch_plan",
]

_M32 = 0xFFFFFFFF
#: Threefry-2x32 key-schedule parity constant (Salmon et al. 2011),
#: the same value jax's prng.py uses.
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

#: fold_in salt for the epoch's SHARD-ORDER permutation — distinct from
#: every shard index (shard keys fold the shard's small nonnegative
#: index), so the shard-order key can never collide with a shard key.
SHARD_ORDER_SALT = 0x5EED5


def key_from_seed(seed: int) -> np.ndarray:
    """A ``uint32[2]`` key from an integer seed — bit-identical to
    ``jax.random.PRNGKey(seed)``'s key data under the default threefry
    impl (hi word, lo word)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([(s >> 32) & _M32, s & _M32], dtype=np.uint32)


def as_key(key) -> np.ndarray:
    """``key`` as the host ``uint32[2]`` form: an int seed, or any array of
    two unsigned 32-bit words (e.g. ``jax.random.key_data`` of a key)."""
    if key is None:
        return key_from_seed(0)
    if isinstance(key, (int, np.integer)):
        return key_from_seed(int(key))
    arr = np.asarray(key)
    if not np.issubdtype(arr.dtype, np.integer):
        raise TypeError(
            f"a shuffle key must be an int seed or a uint32[2] array, got dtype {arr.dtype} "
            "(pass a typed JAX key through jax.random.key_data)")
    arr = arr.astype(np.uint32).reshape(-1)
    if arr.shape != (2,):
        raise ValueError(
            f"a shuffle key must be an int seed or a uint32[2] key, got "
            f"shape {arr.shape}")
    return arr.copy()


def threefry2x32(key2: np.ndarray, msg2) -> np.ndarray:
    """One Threefry-2x32 block (20 rounds) in pure Python/numpy —
    bit-identical to jax's ``threefry_2x32`` for a single counter pair.
    Scalar Python-int arithmetic: the per-call cost is irrelevant (a few
    folds per epoch/shard) and it cannot overflow-warn or touch a
    device."""
    ks0, ks1 = int(key2[0]) & _M32, int(key2[1]) & _M32
    ks2 = ks0 ^ ks1 ^ _PARITY
    x0, x1 = int(msg2[0]) & _M32, int(msg2[1]) & _M32
    x0 = (x0 + ks0) & _M32
    x1 = (x1 + ks1) & _M32
    sched = ((ks1, ks2), (ks2, ks0), (ks0, ks1), (ks1, ks2), (ks2, ks0))
    for r in range(5):
        for d in _ROTATIONS[r % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << d) | (x1 >> (32 - d))) & _M32
            x1 ^= x0
        a, b = sched[r]
        x0 = (x0 + a) & _M32
        x1 = (x1 + b + r + 1) & _M32
    return np.array([x0, x1], dtype=np.uint32)


def fold_in(key2, data: int) -> np.ndarray:
    """Fold an integer into a key — bit-identical to
    ``jax.random.fold_in(key, data)`` (the folded value becomes the
    Threefry counter, exactly jax's construction), pure host."""
    k = as_key(key2)
    d = int(data) & 0xFFFFFFFFFFFFFFFF
    return threefry2x32(k, ((d >> 32) & _M32, d & _M32))


def permutation(key2, n: int) -> np.ndarray:
    """A deterministic permutation of ``range(n)`` derived from the key:
    the folded 64 bits seed a counter-based Philox generator, so the
    result is a pure value of (key, n) — identical across runs, reader
    counts, and processes."""
    k = as_key(key2)
    n = int(n)
    if n < 0:
        raise ValueError(f"permutation length must be >= 0, got {n}")
    seed = (int(k[0]) << 32) | int(k[1])
    return np.random.Generator(np.random.Philox(key=seed)).permutation(n)


class EpochPlan:
    """One epoch's fully-determined visit order over a sharded dataset.

    ``order`` is the flat global sequence of ``(shard, block)`` pairs —
    the ONE order every consumer sees regardless of how many reader
    threads produce it (the merge queue releases blocks by their
    position in this list).  ``shard_order[p]`` is the shard streamed
    at order position ``p``; ``block_orders[s]`` the intra-shard visit
    order of shard ``s``'s blocks; ``starts[p]`` the global sequence
    number of position ``p``'s first block.
    """

    __slots__ = ("epoch", "shard_order", "block_orders", "starts",
                 "n_blocks")

    def __init__(self, epoch: int, shard_order, block_orders):
        self.epoch = int(epoch)
        self.shard_order = list(int(s) for s in shard_order)
        self.block_orders = [np.asarray(o) for o in block_orders]
        starts = [0]
        for s in self.shard_order:
            starts.append(starts[-1] + len(self.block_orders[s]))
        self.starts = starts
        self.n_blocks = starts[-1]

    def order(self):
        """Yield the global ``(shard, block)`` sequence."""
        for s in self.shard_order:
            for b in self.block_orders[s]:
                yield s, int(b)

    def locate(self, seq: int) -> tuple[int, int]:
        """The ``(order position, intra-shard offset)`` of global block
        ``seq`` — what a resuming stream or a replaying reader needs to
        find its place without walking the whole order."""
        seq = int(seq)
        if not 0 <= seq < self.n_blocks:
            raise IndexError(f"seq {seq} outside [0, {self.n_blocks})")
        # starts is ascending; linear scan is fine at shard counts
        for p in range(len(self.shard_order)):
            if seq < self.starts[p + 1]:
                return p, seq - self.starts[p]
        raise AssertionError("unreachable")  # pragma: no cover


def epoch_plan(key, epoch: int, blocks_per_shard,
               *, shuffle: bool = True) -> EpochPlan:
    """Derive epoch ``epoch``'s plan for shards of the given block
    counts.  ``shuffle=False`` returns the identity order (shards in
    manifest order, blocks in file order) — the converter-verification
    and sequential-scan mode."""
    n_shards = len(blocks_per_shard)
    if not shuffle:
        return EpochPlan(
            epoch, range(n_shards),
            [np.arange(int(b)) for b in blocks_per_shard])
    ek = fold_in(as_key(key), int(epoch))
    shard_order = permutation(fold_in(ek, SHARD_ORDER_SALT), n_shards)
    block_orders = [
        permutation(fold_in(ek, s), int(blocks_per_shard[s]))
        for s in range(n_shards)
    ]
    return EpochPlan(epoch, shard_order, block_orders)
