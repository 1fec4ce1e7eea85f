"""Sampling primitives: ONB frames, hemisphere samplers, MIS heuristic,
triangle area sampling (counterpart of sycl_ray_tracing_tpu/ops/sampling.py;
reference render_kernel.cpp:5-54, :513-518, :715-742)."""

from __future__ import annotations

import math

import torch

from sycl_ray_tracing_tpu_torch.ops.safe_math import cross, length, safe_sqrt


def branchless_onb(n: torch.Tensor):
    """Orthonormal basis around normals [...,3] (Duff et al. 2017,
    reference render_kernel.cpp:5-12).  Returns (tangent, bitangent)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        dim=-1,
    )
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def to_world(n: torch.Tensor, local_dir: torch.Tensor) -> torch.Tensor:
    """Rotate a Z-up local direction into the frame around normal ``n``
    (reference rotate_vector_around_normal, render_kernel.cpp:14-22)."""
    t, bt = branchless_onb(n)
    return (
        local_dir[..., 0:1] * t
        + local_dir[..., 1:2] * bt
        + local_dir[..., 2:3] * n
    )


def uniform_hemisphere(n: torch.Tensor, u1, u2):
    """Uniform directions around normals; returns (dir, pdf)
    (reference render_kernel.cpp:24-37)."""
    phi = 2.0 * math.pi * u1
    root = safe_sqrt(1.0 - u2 * u2)
    local = torch.stack([torch.cos(phi) * root, torch.sin(phi) * root, u2],
                        dim=-1)
    pdf = torch.full_like(u1, 1.0 / (2.0 * math.pi))
    return to_world(n, local), pdf


def cosine_hemisphere(n: torch.Tensor, u1, u2):
    """Cosine-weighted directions; returns (dir, pdf)
    (reference render_kernel.cpp:39-54)."""
    sqrt_u2 = safe_sqrt(u2)
    phi = 2.0 * math.pi * u1
    sin_t = safe_sqrt(torch.clamp_min(1.0 - sqrt_u2 * sqrt_u2, 0.0))
    local = torch.stack(
        [torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, sqrt_u2], dim=-1
    )
    return to_world(n, local), sqrt_u2 / math.pi


def power_heuristic(pdf_a, pdf_b):
    """Two-sample power heuristic, beta=2, in the scale-invariant form
    1/(1+(b/a)^2) with the ratio clipped at 1e8 (render_kernel.cpp:513-518).
    Returns 0 where pdf_a == 0."""
    r = torch.clamp(pdf_b / torch.clamp_min(pdf_a, 1e-20), 0.0, 1e8)
    w = 1.0 / (1.0 + r * r)
    return torch.where(pdf_a > 0.0, w, 0.0)


def sample_triangle_uniform(va, vb, vc, u1, u2):
    """Uniform area sample of triangles (square-root warp, reference
    render_kernel.cpp:721-731).  va/vb/vc: [...,3]; u1,u2: [...].

    Returns (point [...,3], unit normal [...,3], area [...])."""
    sqrt_r1 = torch.sqrt(torch.clamp_min(u1, 1e-20))
    u = 1.0 - sqrt_r1
    v = (1.0 - u2) * sqrt_r1
    ab = vb - va
    ac = vc - va
    p = va + ab * u[..., None] + ac * v[..., None]
    n = cross(ab, ac)
    ln = length(n)
    return p, n / ln[..., None], 0.5 * ln


def triangle_area(tris: torch.Tensor) -> torch.Tensor:
    """Areas of triangles [...,3,3] (reference triangle.cpp:8-11)."""
    ab = tris[..., 1, :] - tris[..., 0, :]
    ac = tris[..., 2, :] - tris[..., 0, :]
    return 0.5 * length(cross(ab, ac))
