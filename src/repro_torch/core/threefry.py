"""The Threefry-2x32 counter generator and the bit layout of
``jax.random``'s default key under ``jax_threefry_partitionable=True``
(the default from jax 0.5 on), written so that the micro-simulator's plain
version and its CUDA kernel draw the reference's random numbers bit for
bit.

  * ``prng_key(seed)`` is ``jax.random.PRNGKey(seed)`` with 64-bit
    types off (jax's default, the reference's mode): the seed is cut to
    32 bits, so the words are (0, seed & 0xFFFFFFFF).
  * ``split(key)`` is ``jax.random.split(key)`` (two keys): the hash of
    the counters (hi, lo) = (0, 0) and (0, 1); the first pair of words is
    the next key of the chain, the second the subkey a tick draws from.
  * ``uniform(key, shape)`` is ``jax.random.uniform(key, shape)`` in
    float32: element i (row-major) hashes the counter (i >> 32, i &
    0xFFFFFFFF), takes the xor of the two output words, keeps its top 23
    bits as the mantissa of a float in [1, 2) and subtracts 1.

``threefry2x32`` takes Python ints or int64 tensors that hold uint32
values (torch on the CPU has no uint32 shifts or adds), broadcasting its
four arguments, and masks every add and shift back to 32 bits.  The
20 rounds and key injections are ``jax/_src/prng.py``'s
``_threefry2x32_lowering``.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
#: the key-schedule parity constant of Threefry
PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds: key (k1, k2), counters (x1, x2);
    returns the two output words.  Arguments are Python ints or int64
    tensors of uint32 values, broadcast against each other."""
    ks = (k1, k2, k1 ^ k2 ^ PARITY)
    x1 = (x1 + ks[0]) & MASK
    x2 = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK
    return x1, x2


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` (64-bit types off) as a pair of
    ints."""
    return 0, seed & MASK


def split(key: tuple) -> tuple:
    """``jax.random.split(key)``: (next key, subkey), each a pair of
    ints."""
    k1, k2 = key
    a1, a2 = threefry2x32(k1, k2, 0, 0)
    b1, b2 = threefry2x32(k1, k2, 0, 1)
    return (a1, a2), (b1, b2)


def split_chain(key: tuple, steps: int) -> tuple:
    """`steps` successive ``key, sub = split(key)``: (the last key, the
    subkeys in order)."""
    subs = []
    for _ in range(steps):
        key, sub = split(key)
        subs.append(sub)
    return key, subs


def random_bits(keys, shape, device=None):
    """The 32-bit words of ``jax.random.bits(key, shape)`` for each key:
    `keys` is a list of (k1, k2) pairs; returns int64 (len(keys), *shape)
    holding uint32 values."""
    n = 1
    for d in shape:
        n *= d
    i = torch.arange(n, dtype=torch.int64, device=device)
    k = torch.tensor(keys, dtype=torch.int64, device=device).reshape(-1, 2)
    y1, y2 = threefry2x32(k[:, :1], k[:, 1:], i >> 32, i & MASK)
    return (y1 ^ y2).reshape(len(keys), *shape)


def uniform(keys, shape, device=None):
    """``jax.random.uniform(key, shape)`` (float32, [0, 1)) for each key
    of `keys`: (len(keys), *shape).  The top 23 bits of each word become
    the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(keys, shape, device=device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return torch.clamp_min(f - 1.0, 0.0)
