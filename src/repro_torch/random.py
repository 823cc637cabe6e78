"""Counter-based PRNG: threefry2x32 as jax.random computes it, in torch.

Seeded sampling keys every row with fold_in(PRNGKey(seed), position) and
draws Gumbel noise from that key (launch/steps.py make_sample_fn), so a
request's sampled tokens are a pure function of (seed, position) and never
of its batch row. The JAX package does the same with jax.random; this
module reproduces jax's bits exactly (jax_threefry_partitionable=True, the
default since jax 0.5), so a seeded request draws the same noise in both
packages (tests/test_torch_sampling.py holds the bits to jax's bit for bit
and the float noise to 1 ulp).

A key is a pair (k1, k2) of int64 tensors holding uint32 values; every
uint32 operation is done in int64 and masked back to 32 bits, which keeps
it portable to every device torch supports. Keys broadcast: a batch of
per-row keys of shape [T] draws [T, n] noise in one call.
"""
from __future__ import annotations

from typing import Tuple

import torch

Key = Tuple[torch.Tensor, torch.Tensor]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(key: Key, x1: torch.Tensor, x2: torch.Tensor) -> Key:
    """The Threefry-2x32 block cipher (20 rounds) on counter pairs."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def PRNGKey(seed: torch.Tensor) -> Key:
    """jax.random.PRNGKey of int32 seeds: the key is (0, seed as uint32)."""
    seed = seed.to(torch.int64) & _MASK
    return torch.zeros_like(seed), seed


def fold_in(key: Key, data: torch.Tensor) -> Key:
    """jax.random.fold_in: hash the uint32 `data` under `key`."""
    data = data.to(torch.int64) & _MASK
    return threefry2x32(key, torch.zeros_like(data), data)


def random_bits(key: Key, n: int) -> torch.Tensor:
    """32 random bits for each of n counters per key: [..., n] int64."""
    k1, k2 = (k.unsqueeze(-1) for k in key)
    counts = torch.arange(n, dtype=torch.int64, device=k1.device)
    y1, y2 = threefry2x32((k1, k2), torch.zeros_like(counts), counts)
    return y1 ^ y2


def uniform(key: Key, n: int) -> torch.Tensor:
    """jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)."""
    bits = (random_bits(key, n) >> 9) | 0x3F800000  # mantissa, exponent 0
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats * (1.0 - _TINY) + _TINY, _TINY)


def gumbel(key: Key, n: int) -> torch.Tensor:
    """jax.random.gumbel(key, (n,), float32) in its default "low" mode."""
    return -torch.log(-torch.log(uniform(key, n)))
