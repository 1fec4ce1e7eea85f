"""Ray/primitive intersection (counterpart of
sycl_ray_tracing_tpu/ops/intersect.py): Möller–Trumbore, the analytic
sphere quadric, hit-record merging, and the brute-force all-triangles
backend.

``finalize_hit`` turns a chosen primitive per ray into a full hit record
with the JAX package's miss conventions: ``prim`` is clipped to 0 and
``point`` is the ray origin.  ``intersect_triangles`` (closest hit) and
``any_hit_triangles`` (occlusion) are the dense [R,N] brute-force
backend, also the oracle the tests hold the other backends against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sycl_ray_tracing_tpu_torch.ops.safe_math import (
    EPS,
    cross,
    dot,
    normalize,
    safe_sqrt,
)

BIG_T = 3.0e38  # sentinel "no hit" distance


class Hit(NamedTuple):
    """SoA hit record for a batch of rays (reference hit_info.h:6-15)."""

    t: torch.Tensor        # [R] distance, BIG_T if miss
    point: torch.Tensor    # [R,3]
    normal: torch.Tensor   # [R,3] geometric normal
    uv: torch.Tensor       # [R,2] barycentrics
    prim: torch.Tensor     # [R] primitive index (clipped to 0 on miss)
    hit: torch.Tensor      # [R] bool


def moller_trumbore(ray_o, ray_d, tri):
    """Möller–Trumbore with the reference's epsilon rules (triangle.h:16-60)
    on broadcastable rays [...,3] and triangles [...,3,3].  Returns
    (t, u, v, valid); ``t`` is BIG_T where invalid (intersect.py:56-87)."""
    va = tri[..., 0, :]
    e1 = tri[..., 1, :] - va
    e2 = tri[..., 2, :] - va
    h = cross(ray_d, e2)
    a = dot(e1, h)
    parallel = torch.abs(a) < EPS
    f = 1.0 / torch.where(parallel, 1.0, a)
    s = ray_o - va
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(ray_d, q)
    t = f * dot(e2, q)
    valid = (
        (~parallel)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t > EPS)
    )
    return torch.where(valid, t, BIG_T), u, v, valid


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


def _mt_dense(ray_o, ray_d, tris):
    """Dense scalarized MT: rays [R,3] x triangles [N,3,3] -> t [R,N],
    BIG_T where invalid (intersect.py:90-129)."""
    t, _u, _v, valid, _ = _mt_scalar(
        ray_o[:, 0:1], ray_o[:, 1:2], ray_o[:, 2:3],
        ray_d[:, 0:1], ray_d[:, 1:2], ray_d[:, 2:3],
        tris.reshape(1, -1, 9),
    )
    return torch.where(valid, t, BIG_T)


@torch.no_grad()
def closest_triangle(ray_o, ray_d, tris):
    """The brute-force closest hit's primitive [R] (-1 on miss): a dense
    [R,N] evaluation and an argmin over N (the first index on ties).
    Records no graph."""
    best_t, best = torch.min(_mt_dense(ray_o, ray_d, tris), dim=1)
    return torch.where(best_t < BIG_T, best, -1)


def intersect_triangles(ray_o, ray_d, tris) -> Hit:
    """Closest hit of rays [R,3] against ALL triangles [N,3,3]
    (intersect.py:132-141): the brute-force backend and the test oracle."""
    prim = closest_triangle(ray_o.detach(), ray_d.detach(), tris.detach())
    return finalize_hit(ray_o, ray_d, tris, prim)


@torch.no_grad()
def any_hit_triangles(ray_o, ray_d, tris, t_lim):
    """Occlusion against ALL triangles: True where some t lies in
    (EPS, t_lim) — no argmin, no hit record (intersect.py:213-217)."""
    return torch.any(_mt_dense(ray_o, ray_d, tris) < t_lim[:, None], dim=1)


def intersect_spheres(ray_o, ray_d, centers, radii, prim_index) -> Hit:
    """Closest hit of rays [R,3] against spheres [S,3]/[S]: the analytic
    quadratic with the reference's nearest-positive-root rule
    (sphere.h:11-53, intersect.py:220-250).  ``prim_index`` [S] is each
    sphere's global primitive index.  Differentiable w.r.t. rays, centers
    and radii; ``amin`` shares a tie's gradient as the JAX package's min
    does."""
    L = ray_o[:, None, :] - centers[None]                 # [R,S,3]
    b = 2.0 * dot(ray_d[:, None, :], L)
    c = dot(L, L) - (radii * radii)[None]
    delta = b * b - 4.0 * c
    sq = safe_sqrt(torch.clamp_min(delta, 0.0))
    t1 = (-b - sq) * 0.5
    t2 = (-b + sq) * 0.5
    t = torch.where(t1 > 0.0, t1, t2)                     # nearest positive
    valid = (delta >= 0.0) & (t > 0.0)
    t = torch.where(valid, t, BIG_T)                      # [R,S]
    best = torch.argmin(t.detach(), dim=1)
    best_t = torch.amin(t, dim=1)
    hit = best_t < BIG_T
    point = ray_o + ray_d * torch.where(hit, best_t, 0.0)[:, None]
    normal = normalize(point - centers[best])
    return Hit(
        t=best_t,
        point=point,
        normal=normal,
        uv=torch.zeros((ray_o.shape[0], 2), dtype=ray_o.dtype,
                       device=ray_o.device),
        prim=prim_index[best].to(torch.int32),
        hit=hit,
    )


def merge_hits(a: Hit, b: Hit) -> Hit:
    """Elementwise closest of two hit records (``a`` on ties)."""
    take_a = a.t <= b.t

    def sel(x, y):
        return torch.where(
            take_a.reshape(take_a.shape + (1,) * (x.dim() - take_a.dim())),
            x, y)

    return Hit(
        t=torch.where(take_a, a.t, b.t),
        point=sel(a.point, b.point),
        normal=sel(a.normal, b.normal),
        uv=sel(a.uv, b.uv),
        prim=torch.where(take_a, a.prim, b.prim),
        hit=a.hit | b.hit,
    )


def miss_hit(num_rays: int, dtype=torch.float32, device=None) -> Hit:
    """An all-miss Hit batch (the identity of merge_hits)."""
    return Hit(
        t=torch.full((num_rays,), BIG_T, dtype=dtype, device=device),
        point=torch.zeros((num_rays, 3), dtype=dtype, device=device),
        normal=torch.zeros((num_rays, 3), dtype=dtype, device=device),
        uv=torch.zeros((num_rays, 2), dtype=dtype, device=device),
        prim=torch.zeros((num_rays,), dtype=torch.int32, device=device),
        hit=torch.zeros((num_rays,), dtype=torch.bool, device=device),
    )
