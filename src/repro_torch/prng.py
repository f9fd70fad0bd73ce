"""PRNG keys of the model's key tree, as host integers (port of the two
parts of `jax.random` that the reference's train path uses: ``key(seed)``
and ``fold_in``, for JAX's default threefry2x32 implementation).

A key is a pair of uint32 words ``(k0, k1)``, the reference's
``jax.random.key_data``.  Keys depend only on the step, microbatch, layer
and matmul indices, so they stay Python integers: no device work and no
host sync.  `kernels.td_vmm.ref.derive_seed` turns a key into the noise
seed of one td matmul.
"""
from __future__ import annotations

import functools

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(key: tuple[int, int], x0: int, x1: int) -> tuple[int, int]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as
    `jax._src.prng.threefry2x32_p` computes it for one counter pair."""
    ks = (key[0] & MASK32, key[1] & MASK32,
          (key[0] ^ key[1] ^ _PARITY) & MASK32)
    x = [(x0 + ks[0]) & MASK32, (x1 + ks[1]) & MASK32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & MASK32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & MASK32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & MASK32
    return x[0], x[1]


def key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)`` for a uint32 seed: the words (0, seed)."""
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed {seed} is not a uint32")
    return 0, int(seed)


@functools.lru_cache(maxsize=1 << 16)
def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(k, data)``: threefry of the counter (0, data)
    under k."""
    if not 0 <= data <= MASK32:
        raise ValueError(f"fold_in data {data} is not a uint32")
    return threefry2x32(k, 0, int(data))
