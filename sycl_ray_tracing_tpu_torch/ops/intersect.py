"""Ray/triangle hit records (counterpart of sycl_ray_tracing_tpu/ops/intersect.py).

``finalize_hit`` turns a chosen primitive per ray into a full hit record
with the JAX package's miss conventions: ``prim`` is clipped to 0 and
``point`` is the ray origin.  ``intersect_triangles`` is the brute-force
all-triangles oracle the tests hold the list tracer against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sycl_ray_tracing_tpu_torch.ops.safe_math import EPS, safe_sqrt

BIG_T = 3.0e38  # sentinel "no hit" distance


class Hit(NamedTuple):
    """SoA hit record for a batch of rays (reference hit_info.h:6-15)."""

    t: torch.Tensor        # [R] distance, BIG_T if miss
    point: torch.Tensor    # [R,3]
    normal: torch.Tensor   # [R,3] geometric normal
    uv: torch.Tensor       # [R,2] barycentrics
    prim: torch.Tensor     # [R] primitive index (clipped to 0 on miss)
    hit: torch.Tensor      # [R] bool


def _mt_scalar(ox, oy, oz, dx, dy, dz, tri9):
    """Scalarized Möller–Trumbore of rays against gathered vertex rows
    [..., 9] (triangle.h:16-60).  Returns (t, u, v, valid-without-t_lim)."""
    ax, ay, az = tri9[..., 0], tri9[..., 1], tri9[..., 2]
    e1x, e1y, e1z = tri9[..., 3] - ax, tri9[..., 4] - ay, tri9[..., 5] - az
    e2x, e2y, e2z = tri9[..., 6] - ax, tri9[..., 7] - ay, tri9[..., 8] - az
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    parallel = torch.abs(a) < EPS
    f = 1.0 / torch.where(parallel, 1.0, a)
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    valid = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPS)
    )
    return t, u, v, valid, (e1x, e1y, e1z, e2x, e2y, e2z)


def finalize_hit(ray_o, ray_d, tris, prim) -> Hit:
    """Hit record for a chosen primitive per ray; ``prim`` may be -1 for
    known misses (intersect.py:144-203)."""
    n = tris.shape[0]
    best = torch.clamp(prim, 0, n - 1)
    tri9 = tris.reshape(n, 9)[best.long()]                # [R,9]
    t, u, v, valid, (e1x, e1y, e1z, e2x, e2y, e2z) = _mt_scalar(
        ray_o[:, 0], ray_o[:, 1], ray_o[:, 2],
        ray_d[:, 0], ray_d[:, 1], ray_d[:, 2], tri9,
    )
    valid = valid & (prim >= 0)
    best_t = torch.where(valid, t, BIG_T)
    # miss lanes keep point = origin (o + d*BIG_T would overflow to inf)
    point = ray_o + ray_d * torch.where(valid, best_t, 0.0)[:, None]
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    inv_len = 1.0 / safe_sqrt(nx * nx + ny * ny + nz * nz)
    normal = torch.stack([nx * inv_len, ny * inv_len, nz * inv_len], dim=-1)
    return Hit(
        t=best_t,
        point=point,
        normal=normal,
        uv=torch.stack([u, v], dim=-1),
        prim=best.to(torch.int32),
        hit=valid,
    )


def intersect_triangles(ray_o, ray_d, tris) -> Hit:
    """Closest hit of rays [R,3] against ALL triangles [N,3,3]: a dense
    [R,N] evaluation and an argmin over N.  The test oracle."""
    t, _u, _v, valid, _ = _mt_scalar(
        ray_o[:, 0:1], ray_o[:, 1:2], ray_o[:, 2:3],
        ray_d[:, 0:1], ray_d[:, 1:2], ray_d[:, 2:3],
        tris.reshape(1, -1, 9),
    )
    t = torch.where(valid, t, BIG_T)
    best_t, best = torch.min(t, dim=1)
    prim = torch.where(best_t < BIG_T, best, -1)
    return finalize_hit(ray_o, ray_d, tris, prim)
