"""Threefry-2x32 counter RNG in the layout of ``jax.random`` with
partitionable threefry: element i of a draw comes from the counter pair
(i >> 32, i & 0xFFFFFFFF), so a draw depends only on its flat index.

Frozen copy of sycl_ray_tracing_tpu_torch/ops/rng.py at commit e337019,
with keys as (word, word) integer pairs; ``uniform`` takes the dtype the
reference computes in.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k1: int, k2: int, x0, x1):
    """20 rounds of Threefry-2x32 of counter words (x0, x1) under key
    (k1, k2); words are ints or int64 tensors holding 32-bit values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key_of_seed(seed: int) -> tuple:
    """The key of a seed of up to 64 bits: words (seed >> 32, seed & MASK),
    as ``jax.random.PRNGKey`` makes them."""
    return ((int(seed) >> 32) & MASK, int(seed) & MASK)


def fold_in(key: tuple, data: int) -> tuple:
    """``jax.random.fold_in``: the hash of counter (0, data) under key."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK)


def uniform(key: tuple, shape, device, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1): 23 random mantissa
    bits under exponent 0, minus 1."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], idx >> 32, idx & MASK)
    bits = (b0 ^ b1).reshape(tuple(shape))
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    out = torch.clamp_min(fbits.view(torch.float32) - 1.0, 0.0)
    return out.to(dtype)


def uniforms(key: tuple, bounce: int, tag: int, shape, device,
             dtype=torch.float32) -> torch.Tensor:
    """One stream per (bounce, purpose tag) of a path's random decisions."""
    return uniform(fold_in(fold_in(key, bounce), tag), shape, device, dtype)
