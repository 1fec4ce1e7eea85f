"""Guarded math helpers (counterpart of sycl_ray_tracing_tpu/ops/safe_math.py).

The port is forward-only for now, but keeps the same guards so values
match the JAX package on the same inputs.
"""

from __future__ import annotations

import torch

EPS = 1e-7          # Möller–Trumbore parallel-ray epsilon (reference triangle.h:19)
RAY_OFFSET = 1e-4   # shadow/continuation ray origin offset (reference render_kernel.cpp:139)


def safe_sqrt(x):
    """sqrt clamped at 1e-20 (the JAX package's gradient-safe form)."""
    return torch.sqrt(torch.clamp_min(x, 1e-20))


def safe_div(num, den, eps: float = 1e-12):
    """num/den with |den| floored away from 0 (sign-preserving)."""
    mag = torch.clamp_min(torch.abs(den), eps)
    return num / torch.where(den < 0, -mag, mag)


def safe_acos(x):
    return torch.arccos(torch.clamp(x, -1.0 + 1e-7, 1.0 - 1e-7))


def safe_asin(x):
    return torch.arcsin(torch.clamp(x, -1.0 + 1e-7, 1.0 - 1e-7))


def dot(a, b):
    """Batched 3-vector dot over the last axis, keeps batch shape."""
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(v):
    return safe_sqrt(dot(v, v))


def normalize(v):
    """v / |v| with the same floor as the JAX package."""
    return v / length(v)[..., None]


def reflect(v, n):
    """Reflect direction ``v`` about normal ``n`` (both [...,3])."""
    return 2.0 * dot(n, v)[..., None] * n - v


def luminance(rgb):
    """Reference luminance weights 0.3086/0.6094/0.0820 (color.h:78-81)."""
    return 0.3086 * rgb[..., 0] + 0.6094 * rgb[..., 1] + 0.0820 * rgb[..., 2]


def where3(mask, a, b):
    """Select full RGB rows by a [...]-shaped mask."""
    return torch.where(mask[..., None], a, b)
