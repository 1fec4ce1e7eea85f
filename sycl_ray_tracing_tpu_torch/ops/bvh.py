"""Threaded BVH: a Morton-ordered or binned-SAH build and a stackless
skip-link traversal (counterpart of sycl_ray_tracing_tpu/ops/bvh.py).

  * build: ``method="sah"`` takes the port's own native binned-SAH
    builder (native/__init__.py ``sah_build``); ``method="morton"`` sorts
    triangles by the Morton code of their AABB centroid and erects a
    balanced binary tree over equal index ranges, in numpy exactly as the
    JAX package does.
  * layout: one flat node array in DFS preorder with skip links, packed
    as [M,8] f32 boxes and [M,4] i32 (first, count (-1 internal), skip)
    rows; leaf triangles pre-gathered into slot order.
  * traversal: every ray carries one node index.  A box hit on an
    internal node descends (node+1); a miss or a finished leaf takes the
    skip link.  All rays step in lockstep with masks, as a Python loop of
    tensor ops.  ``any(node < M)`` is a host sync, so the loop tests it
    every CHECK_EVERY steps: a finished ray's node stays >= M and its
    state no longer changes, so the extra steps change no answer.
  * the traversal records no graph; ``intersect_bvh`` re-intersects the
    winning triangle with ``finalize_hit``, so gradients flow as through
    the brute-force backend.

WALK_STEPS counts the lockstep steps run since the last reset (closest
and any-hit walks separately), for the measurement scripts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sycl_ray_tracing_tpu_torch.ops.cluster import (
    SHADOW_EPS,
    _morton3,
    _slab_test,
    inv_dir,
)
from sycl_ray_tracing_tpu_torch.ops.intersect import (
    BIG_T,
    Hit,
    finalize_hit,
    moller_trumbore,
)
from sycl_ray_tracing_tpu_torch.utils.device import resolve_device

CHECK_EVERY = 8     # lockstep steps between two "any ray active?" syncs
WALK_STEPS = {"closest": 0, "any": 0}
BVH_FIELDS = ("nodes_box", "nodes_meta", "leaf_tris", "tri_order")


def reset_walk_steps():
    for k in WALK_STEPS:
        WALK_STEPS[k] = 0


@dataclasses.dataclass(frozen=True)
class ThreadedBVH:
    """Flat threaded BVH (DFS preorder, skip links)."""

    nodes_box: torch.Tensor   # [M,8] f32: min xyz, max xyz, 0, 0
    nodes_meta: torch.Tensor  # [M,4] i32: first, count (-1 internal), skip, 0
    leaf_tris: torch.Tensor   # [Np,3,3] f32 triangles in slot order (padded)
    tri_order: torch.Tensor   # [Np] i32 original triangle index per slot
    leaf_size: int = 4

    @property
    def num_nodes(self) -> int:
        return self.nodes_box.shape[0]


def bvh_from_numpy(arrays: dict, device, leaf_size: int = 4) -> ThreadedBVH:
    """ThreadedBVH from host arrays named like its tensor fields."""
    return ThreadedBVH(
        **{f: torch.tensor(np.asarray(arrays[f]), device=device)
           for f in BVH_FIELDS},
        leaf_size=int(leaf_size),
    )


def build_bvh_arrays(triangles: np.ndarray, leaf_size: int = 4,
                     method: str = "auto") -> dict:
    """The threaded BVH's tables over triangles [N,3,3], in numpy
    (bvh.py:82-197).  ``method``: "sah" (the native binned-SAH builder;
    raises if it cannot be built), "auto" (the same: the JAX package's
    "auto" takes SAH where its library loads, and the port's always
    builds or raises) or "morton"."""
    tris = np.asarray(triangles, np.float32)
    if method in ("auto", "sah"):
        from sycl_ray_tracing_tpu_torch import native

        nodes_box, nodes_meta, slot_order = native.sah_build(tris, leaf_size)
        return dict(nodes_box=nodes_box, nodes_meta=nodes_meta,
                    leaf_tris=tris[slot_order], tri_order=slot_order)
    if method != "morton":
        raise ValueError(f"bad build method {method!r}")
    n = tris.shape[0]
    tmin = tris.min(axis=1)  # [N,3]
    tmax = tris.max(axis=1)
    centroid = 0.5 * (tmin + tmax)
    lo = centroid.min(axis=0)
    span = np.maximum(centroid.max(axis=0) - lo, 1e-12)
    codes = _morton3((centroid - lo) / span)
    order = np.argsort(codes, kind="stable").astype(np.int32)

    k0 = max(1, -(-n // leaf_size))          # number of real leaves
    depth = max(0, int(np.ceil(np.log2(k0))))
    k = 1 << depth                            # padded leaf count
    m = 2 * k - 1                             # total nodes

    # triangles in Morton order, padded with degenerate (all-zero) triangles
    pad = k * leaf_size - n
    leaf_tris = np.concatenate(
        [tris[order], np.zeros((pad, 3, 3), np.float32)]
    )
    tri_order_padded = np.concatenate([order, np.zeros((pad,), np.int32)])

    big = np.float32(3e38)
    smin = np.concatenate([tmin[order], np.full((pad, 3), big, np.float32)])
    smax = np.concatenate([tmax[order], np.full((pad, 3), -big, np.float32)])
    leaf_min = smin.reshape(k, leaf_size, 3).min(axis=1)   # [K,3]
    leaf_max = smax.reshape(k, leaf_size, 3).max(axis=1)

    # per-level AABBs, bottom-up
    mins = [leaf_min]
    maxs = [leaf_max]
    while mins[-1].shape[0] > 1:
        mins.append(mins[-1].reshape(-1, 2, 3).min(axis=1))
        maxs.append(maxs[-1].reshape(-1, 2, 3).max(axis=1))
    mins = mins[::-1]  # mins[d]: level d (root = level 0)
    maxs = maxs[::-1]

    nodes_box = np.zeros((m, 8), np.float32)
    nodes_meta = np.zeros((m, 4), np.int32)
    nodes_meta[:, 1] = -1  # internal by default

    # DFS preorder positions level by level; subtree size at level d is
    # S(d) = 2^(depth-d+1) - 1
    pos = np.zeros((1,), np.int64)  # root at 0
    for d in range(depth + 1):
        s = (1 << (depth - d + 1)) - 1
        nodes_box[pos, 0:3] = mins[d]
        nodes_box[pos, 3:6] = maxs[d]
        nodes_meta[pos, 2] = pos + s  # skip link
        if d == depth:                # leaves
            leaf_ids = np.arange(k, dtype=np.int64)
            nodes_meta[pos, 0] = (leaf_ids * leaf_size).astype(np.int32)
            nodes_meta[pos, 1] = np.clip(
                n - leaf_ids * leaf_size, 0, leaf_size
            ).astype(np.int32)
        else:
            child_s = (1 << (depth - d)) - 1
            pos = np.stack([pos + 1, pos + 1 + child_s], axis=1).reshape(-1)

    return dict(nodes_box=nodes_box, nodes_meta=nodes_meta,
                leaf_tris=leaf_tris, tri_order=tri_order_padded)


def build_bvh(triangles: np.ndarray, leaf_size: int = 4,
              method: str = "auto", device="cuda") -> ThreadedBVH:
    """A threaded BVH over triangles [N,3,3] on ``device`` (see
    build_bvh_arrays)."""
    device = resolve_device(device)
    return bvh_from_numpy(build_bvh_arrays(triangles, leaf_size, method),
                          device, leaf_size)


def _box_hit(box, o, inv_d, t_limit):
    """Ray/AABB slab test of each ray against its own box [B,8], bounded
    above by t_limit."""
    return _slab_test([box[:, c] for c in range(6)],
                      [o[:, a] for a in range(3)],
                      [inv_d[:, a] for a in range(3)], t_limit)[0]


def _leaf_mt(bvh: ThreadedBVH, first, count, o, d):
    """Möller–Trumbore on each ray's current leaf slots -> (t [B,L] with
    BIG_T fills, slot [B,L] global slot index) (bvh.py:209-250)."""
    L = bvh.leaf_size
    lane = torch.arange(L, dtype=torch.int32, device=o.device)
    slot = torch.clamp(first[:, None] + lane[None, :], 0,
                       bvh.leaf_tris.shape[0] - 1)               # [B,L]
    tri = bvh.leaf_tris[slot.long()]                             # [B,L,3,3]
    t, _u, _v, ok = moller_trumbore(o[:, None, :], d[:, None, :], tri)
    ok = ok & (lane[None, :] < count[:, None])
    return torch.where(ok, t, BIG_T), slot


def _walk(step, state, active_of, counter: str):
    """Run ``step`` in lockstep until no ray is active, testing
    ``active_of(state)`` every CHECK_EVERY steps."""
    n = 0
    while n % CHECK_EVERY or bool(active_of(state).any()):
        state = step(state)
        n += 1
    WALK_STEPS[counter] += n
    return state


@torch.no_grad()
def closest_prim(bvh: ThreadedBVH, ray_o, ray_d):
    """Lockstep threaded traversal -> (best_t [B], best_prim [B]: -1 on
    miss, in ORIGINAL triangle indexing) (bvh.py:253-295)."""
    B = ray_o.shape[0]
    m = bvh.num_nodes
    dev = ray_o.device
    inv_d = inv_dir(ray_d)

    def step(state):
        node, best_t, best_slot = state
        nc = torch.clamp(node, 0, m - 1).long()
        box = bvh.nodes_box[nc]
        meta = bvh.nodes_meta[nc]
        first, cnt, skp = meta[:, 0], meta[:, 1], meta[:, 2]
        active = node < m
        box_hit = _box_hit(box, ray_o, inv_d, best_t) & active
        is_leaf = cnt >= 0
        do_leaf = box_hit & is_leaf
        t, slot = _leaf_mt(bvh, torch.where(do_leaf, first, 0),
                           torch.where(do_leaf, cnt, 0), ray_o, ray_d)
        lane_best = torch.argmin(t, dim=1)[:, None]
        lane_t = torch.gather(t, 1, lane_best)[:, 0]
        lane_slot = torch.gather(slot, 1, lane_best)[:, 0]
        better = do_leaf & (lane_t < best_t)
        best_t = torch.where(better, lane_t, best_t)
        best_slot = torch.where(better, lane_slot, best_slot)
        nxt = torch.where(box_hit & ~is_leaf, node + 1, skp)
        return torch.where(active, nxt, node), best_t, best_slot

    state = (torch.zeros((B,), dtype=torch.int32, device=dev),
             torch.full((B,), BIG_T, dtype=torch.float32, device=dev),
             torch.full((B,), -1, dtype=torch.int32, device=dev))
    _node, best_t, best_slot = _walk(step, state,
                                     lambda s: s[0] < m, "closest")
    best_prim = torch.where(
        best_slot >= 0, bvh.tri_order[torch.clamp_min(best_slot, 0).long()],
        -1)
    return best_t, best_prim


@torch.no_grad()
def any_hit(bvh: ThreadedBVH, ray_o, ray_d, t_max):
    """Occlusion walk: True where a triangle lies at t in
    (EPS, t_max - SHADOW_EPS); a ray retires once it finds one
    (bvh.py:298-330)."""
    B = ray_o.shape[0]
    m = bvh.num_nodes
    dev = ray_o.device
    inv_d = inv_dir(ray_d)
    t_lim = t_max - SHADOW_EPS

    def step(state):
        node, found = state
        nc = torch.clamp(node, 0, m - 1).long()
        box = bvh.nodes_box[nc]
        meta = bvh.nodes_meta[nc]
        first, cnt, skp = meta[:, 0], meta[:, 1], meta[:, 2]
        active = (node < m) & ~found
        box_hit = _box_hit(box, ray_o, inv_d, t_lim) & active
        is_leaf = cnt >= 0
        do_leaf = box_hit & is_leaf
        t, _ = _leaf_mt(bvh, torch.where(do_leaf, first, 0),
                        torch.where(do_leaf, cnt, 0), ray_o, ray_d)
        found = found | (do_leaf & (t < t_lim[:, None]).any(dim=1))
        nxt = torch.where(box_hit & ~is_leaf, node + 1, skp)
        return torch.where(active, nxt, node), found

    state = (torch.zeros((B,), dtype=torch.int32, device=dev),
             torch.zeros((B,), dtype=torch.bool, device=dev))
    _node, found = _walk(step, state,
                         lambda s: (s[0] < m) & ~s[1], "any")
    return found


def intersect_bvh(bvh: ThreadedBVH, tris, ray_o, ray_d) -> Hit:
    """Closest hit via the BVH with a differentiable hit record
    (bvh.py:333-346)."""
    _t, prim = closest_prim(bvh, ray_o.detach(), ray_d.detach())
    return finalize_hit(ray_o, ray_d, tris, prim)
