"""Scene queries of the plain reference: closest hit and occlusion by
Moller-Trumbore against every triangle whose box a ray crosses, found
through a binary tree of boxes that the reference builds itself.

The tree: triangles sorted by the Morton code of their centroids, leaves
of LEAF triangles in that order, a complete binary tree of boxes over the
leaves (padded to a power of two with empty leaves).  Boxes are widened
by BOX_PAD of the scene's extent, so no triangle a ray hits is left out
by the slab test's rounding.  A query walks the tree level by level over
(ray, node) pairs, then tests every triangle of every leaf it reached:
the answer is exact over all triangles, with no pruning by distance.

Moller-Trumbore runs in the list kernels' operation order (a frozen copy
of ``_mt8`` in sycl_ray_tracing_tpu_torch/ops/kernels/listtrace.py and of
``finalize_hit`` in ops/intersect.py at commit e337019), so a ray and a
triangle give the same t here as in the program.  A tie in t between two
triangles (a ray through their shared edge) goes to the lower triangle
index, or with ``tie_high`` to the higher; the program breaks it by its
cluster layout, so a check reads the program against both.
"""

from __future__ import annotations

import torch

from benchmark.reference.shading import EPS, safe_sqrt

BIG_T = 3.0e38
SHADOW_EPS = 1e-4
LEAF = 8
BOX_PAD = 1e-4
MORTON_BITS = 10
PAIR_CHUNK = 1 << 20      # (ray, leaf) pairs tested at once
RAY_CHUNK = 1 << 15       # rays walked down the tree at once
ID_MASK = 0x7FFFFFFF


def mt8(ax, ay, az, bx, by, bz, cx, cy, cz, ox, oy, oz, dx, dy, dz, tl):
    """t of a valid hit below ``tl``, else BIG_T."""
    e1x, e1y, e1z = bx - ax, by - ay, bz - az
    e2x, e2y, e2z = cx - ax, cy - ay, cz - az
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    parallel = torch.abs(a) < EPS
    f = torch.reciprocal(torch.where(parallel, 1.0, a))
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    ok = ((~parallel) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > EPS) & (t < tl))
    return torch.where(ok, t, BIG_T)


def _spread(x):
    """The bits of a 10-bit integer spread to every third bit."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


class Tree:
    """The reference's own acceleration structure over triangles [N,3,3]."""

    def __init__(self, tris: torch.Tensor):
        self.rows = tris.reshape(-1, 9)
        n = tris.shape[0]
        dev = tris.device
        v = tris.detach().float()
        cen = v.mean(dim=1)
        lo, hi = cen.amin(dim=0), cen.amax(dim=0)
        q = ((cen - lo) / torch.clamp_min(hi - lo, 1e-12)
             * ((1 << MORTON_BITS) - 1)).to(torch.int64)
        code = _spread(q[:, 0]) | (_spread(q[:, 1]) << 1) | (
            _spread(q[:, 2]) << 2)
        order = torch.argsort(code, stable=True)
        leaves = -(-n // LEAF)
        self.depth = max(0, (leaves - 1).bit_length())
        slots = (1 << self.depth) * LEAF
        ids = torch.full((slots,), -1, dtype=torch.int64, device=dev)
        ids[:n] = order
        self.leaf_ids = ids.view(-1, LEAF)                   # [P, LEAF]
        scale = float(v.abs().amax()) + 1.0
        pad = BOX_PAD * scale
        vv = v[torch.clamp_min(self.leaf_ids, 0)]           # [P,LEAF,3,3]
        real = (self.leaf_ids >= 0)[:, :, None, None]
        big = torch.tensor(float("inf"), device=dev)
        lo_b = torch.where(real, vv, big).amin(dim=(1, 2)) - pad
        hi_b = torch.where(real, vv, -big).amax(dim=(1, 2)) + pad
        levels = [torch.cat([lo_b, hi_b], dim=1)]           # [P, 6]
        while levels[-1].shape[0] > 1:
            b = levels[-1].view(-1, 2, 6)
            levels.append(torch.cat([b[:, :, :3].amin(dim=1),
                                     b[:, :, 3:].amax(dim=1)], dim=1))
        self.levels = levels[::-1]                           # root first
        self.tie_high = False
        self.ties = 0

    @staticmethod
    def _slab(box, o, inv, tlim):
        t0 = (box[:, :3] - o) * inv
        t1 = (box[:, 3:] - o) * inv
        tn = torch.minimum(t0, t1).amax(dim=1)
        tf = torch.maximum(t0, t1).amin(dim=1)
        # an empty node's box is inverted (lo = +inf, hi = -inf)
        real = box[:, 0] <= box[:, 3]
        return real & (tn <= tf) & (tf >= 0.0) & (tn <= tlim)

    def _pairs(self, o, d, tlim, live):
        """(ray, leaf) pairs whose leaf box each live ray crosses below
        its limit."""
        o, d, tlim = o.float(), d.float(), tlim.float()
        inv = torch.sign(d) + (d == 0).float()
        inv = inv / torch.clamp_min(d.abs(), 1e-30)
        ray = torch.nonzero(live)[:, 0]
        node = torch.zeros_like(ray)
        for level, boxes in enumerate(self.levels):
            if level:
                ray = ray.repeat_interleave(2)
                node = (node * 2).view(-1, 1).add(
                    torch.arange(2, device=node.device)).view(-1)
            keep = self._slab(boxes[node], o[ray], inv[ray], tlim[ray])
            ray, node = ray[keep], node[keep]
        return ray, node

    def query(self, o, d, tlim, live, any_hit: bool):
        """Closest hit: prim [R] (-1 on a miss).  Occlusion: blocked [R]
        bool, a triangle at t < tlim.  Rays outside ``live`` miss.

        The nearest hit is the least key (t's bits << 32 | triangle), or
        with ``tie_high`` (t's bits << 32 | ~triangle): where two
        triangles give a ray the same least t (a hit on their shared
        edge), both answers are exact, and the two rules take either.
        ``ties`` counts the closest-hit rays where the rules differ."""
        n_rays = o.shape[0]
        none = _key(torch.tensor(BIG_T), torch.tensor(0))
        best = torch.full((n_rays, 2), none, dtype=torch.int64,
                          device=o.device)
        step = PAIR_CHUNK // LEAF
        for r0 in range(0, n_rays, RAY_CHUNK):
            sl = slice(r0, r0 + RAY_CHUNK)
            ray, leaf = self._pairs(o[sl], d[sl], tlim[sl], live[sl])
            ray = ray + r0
            for p0 in range(0, ray.shape[0], step):
                r = ray[p0:p0 + step]
                ids = self.leaf_ids[leaf[p0:p0 + step]]
                t = self._mt(o, d, tlim, r, ids)
                keys = torch.stack([_key(t, ids).amin(dim=1),
                                    _key(t, ID_MASK - ids).amin(dim=1)], 1)
                best.scatter_reduce_(0, r[:, None].expand(-1, 2), keys,
                                     "amin")
        hit = best[:, 0] < none
        if any_hit:
            return hit
        low = best[:, 0] & ID_MASK
        high = ID_MASK - (best[:, 1] & ID_MASK)
        self.ties += int((hit & (low != high)).sum())
        return torch.where(hit, high if self.tie_high else low, -1)

    def _mt(self, o, d, tlim, r, ids):
        tri = self.rows[torch.clamp_min(ids, 0)]            # [P,LEAF,9]
        oo, dd = o[r], d[r]
        planes = [tri[..., c] for c in range(9)]
        t = mt8(*planes, *(oo[:, c:c + 1] for c in range(3)),
                *(dd[:, c:c + 1] for c in range(3)), tlim[r][:, None])
        t32 = t.float()
        return torch.where((ids >= 0) & (t32 < 0.5 * BIG_T), t32, BIG_T)


def _key(t, ids):
    """Keys ordered by t, then by triangle: t >= 0, so its float32 bits
    order like its values."""
    bits = t.float().view(torch.int32).to(torch.int64)
    return (bits << 32) | torch.clamp_min(ids, 0)


def finalize_hit(ray_o, ray_d, tris, prim):
    """The hit record of a chosen triangle per ray (prim -1: a miss):
    (t, point, normal, hit), re-intersected so gradients reach the
    scene."""
    n = tris.shape[0]
    best = torch.clamp(prim, 0, n - 1)
    tri9 = tris.reshape(n, 9)[best.long()]
    ox, oy, oz = ray_o[:, 0], ray_o[:, 1], ray_o[:, 2]
    dx, dy, dz = ray_d[:, 0], ray_d[:, 1], ray_d[:, 2]
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
    valid = ((~parallel) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > EPS) & (prim >= 0))
    best_t = torch.where(valid, t, BIG_T)
    point = ray_o + ray_d * torch.where(valid, best_t, 0.0)[:, None]
    nx = e1y * e2z - e1z * e2y
    ny = e1z * e2x - e1x * e2z
    nz = e1x * e2y - e1y * e2x
    inv_len = 1.0 / safe_sqrt(nx * nx + ny * ny + nz * nz)
    normal = torch.stack([nx * inv_len, ny * inv_len, nz * inv_len], dim=-1)
    return best_t, point, normal, valid
