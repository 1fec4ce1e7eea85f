"""Counter-based RNG, bit-exact with ``jax.random`` (threefry2x32).

Counterpart of ``jax.random.PRNGKey`` / ``fold_in`` / ``uniform`` under
``jax_threefry_partitionable=True`` (the JAX package's setting).
``uniform_rows`` draws under per-element keys: the renderer's
``pathtracer._TileKeys.uniforms`` builds the JAX package's per-bounce,
per-purpose streams (``pathtracer._uniforms``,
sycl_ray_tracing_tpu/models/pathtracer.py:109-111) on it.

A key is an int64 tensor of shape (2,) on the CPU holding the two 32-bit
words, passed down explicitly exactly as JAX passes its key.  All word
arithmetic is int64 masked to 32 bits, so the same code runs on CPU and
CUDA tensors (and on Python ints, which is how keys are folded).

Partitionable threefry draws element ``i`` of a shape from the counter
pair (i >> 32, i & 0xFFFFFFFF), so a draw depends only on its flat index:
the first rows of a (4096, 2) draw equal a (512, 2) draw.  So
``uniform_rows`` can draw a batch of tiles at once, each element under
its own tile's key at the flat index its tile's own draw gives it.
"""

from __future__ import annotations

import math

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: int, k2: int, x0, x1):
    """Threefry-2x32 (20 rounds) of counter words (x0, x1) under key
    (k1, k2).  x0/x1: int64 tensors (or ints) holding 32-bit values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: words (0, seed)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in``: the hash of counter (0, data) under ``key``."""
    k1, k2 = (int(v) for v in key.tolist())
    y0, y1 = threefry2x32(k1, k2, 0, int(data) & _MASK)
    return torch.tensor([y0, y1], dtype=torch.int64)


def random_bits(key: torch.Tensor, shape, device) -> torch.Tensor:
    """32 random bits per element (int64 holding uint32 values)."""
    k1, k2 = (int(v) for v in key.tolist())
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k1, k2, idx >> 32, idx & _MASK)
    return (b0 ^ b1).reshape(shape)


def _unit(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits -> float32 in [0, 1): mantissa fill ``(bits >> 9) |
    0x3F800000`` reinterpreted as a float, minus 1."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(fbits.view(torch.float32) - 1.0, 0.0)


def uniform(key: torch.Tensor, shape, device) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1)."""
    return _unit(random_bits(key, tuple(shape), device))


def uniform_rows(k1: torch.Tensor, k2: torch.Tensor,
                 counter: torch.Tensor) -> torch.Tensor:
    """``uniform`` element by element under per-element keys: element j
    is the draw of flat index ``counter[j]`` under key (k1[j], k2[j]).
    int64 tensors that broadcast to one shape (the keys [n, 1] beside
    counters [n, k] give each row its own key)."""
    b0, b1 = threefry2x32(k1, k2, counter >> 32, counter & _MASK)
    return _unit(b0 ^ b1)
