"""Counter-based random numbers, bit-exact with ``jax.random``'s default
generator.

The JAX package draws its RT samples from ``jax.random`` (threefry2x32, with
``jax_threefry_partitionable=True`` as in JAX 0.9): ``PRNGKey``, ``fold_in``
and ``uniform(key, (2, r))``. A ``torch.Generator`` cannot give those bits,
so the port carries the generator itself and its soft shadows, AO and
reflection samples draw the same numbers as the reference.

A key is a pair of Python ints (two uint32 words); key derivation runs on
the host. ``uniform`` hashes a counter per element on the tensors' device,
with uint32 arithmetic emulated in int64 (``& 0xFFFFFFFF`` after every add
and shift), so it runs unchanged on the CPU and on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0: int, k1: int, x0, x1):
    """The Threefry-2x32 block (20 rounds) on two counter words, which may be
    Python ints or int64 tensors holding uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    return (0, int(seed) & _M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def uniform(key: Key, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in f32 [0, 1): element ``i`` of the
    row-major flat array hashes the counter (0, i), its two output words are
    XORed, and the top 23 bits become the mantissa of a float in [1, 2)."""
    n = 1
    for s in shape:
        n *= int(s)
    if n >= 1 << 32:
        raise ValueError("uniform: more than 2^32 elements")
    count = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(count), count)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return (bits.to(torch.int32).view(torch.float32) - 1.0).reshape(shape)
