"""Clustered geometry and the exact candidate-list build for the list tracer
(counterpart of sycl_ray_tracing_tpu/ops/cluster.py).

Triangles are grouped into clusters of T_CLUSTER=128 (SAH leaf order, or
Morton order on request) and superclusters of S_CLUSTER=64; the tables
are built in numpy exactly as the JAX package builds them.

The candidate build is plain torch (it is XLA, not Pallas, in the JAX
package): a dense [rays, K2] slab test, the EXACT nearest-first
extraction (packed quantized-entry-t | cluster-id keys, sorted), and the
per-ray membership certificate.  Every step is row-local, so the build
runs in row chunks to bound the [rows, K2] transients; chunking does not
change any result.

Not ported here (NotImplementedError at the caller): the supercluster
prefiltered build ``candidate_clusters_hier`` and the threshold-min
``_extract_candidates`` it uses, and the approximate-recall extraction
(every list-tracer pass asks for exact extraction).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sycl_ray_tracing_tpu_torch.ops.intersect import BIG_T
from sycl_ray_tracing_tpu_torch.ops.safe_math import EPS

T_CLUSTER = 128      # triangles per cluster
S_CLUSTER = 64       # clusters per supercluster
SHADOW_EPS = 1e-4    # reference t_max slack (render_kernel.cpp:751)
_DEAD = 0x7F800000   # +inf bits: a packed key above every real key
# [rows, K2] elements per chunk of the dense build (~128 MB per f32 array)
_CHUNK_ELEMS = 1 << 25


@dataclasses.dataclass(frozen=True)
class ClusterScene:
    """Two-level clustered geometry (padded to full 64-cluster groups)."""

    sc_box: torch.Tensor       # [K1,8] f32 supercluster AABB (min3,max3,0,0)
    cl_box_rows: torch.Tensor  # [K1, 8*S] f32 child AABBs, planar rows
    cl_box: torch.Tensor       # [K2,8] f32 per-cluster AABB
    cl_tris: torch.Tensor      # [K2, 9*T] f32 planar triangle coordinate rows
    cl_tri_idx: torch.Tensor   # [K2, T] i32 original tri index (-1 pad)
    # per-ray candidate-list depth override for the list tracer (0 = module
    # defaults): the overflow-regrow knob of the JAX package
    list_maxc: int = 0

    @property
    def num_clusters(self) -> int:
        return self.cl_tris.shape[0]

    def with_list_maxc(self, maxc: int) -> "ClusterScene":
        return dataclasses.replace(self, list_maxc=maxc)


CLUSTER_FIELDS = ("sc_box", "cl_box_rows", "cl_box", "cl_tris", "cl_tri_idx")


def clusters_from_numpy(arrays: dict, device, list_maxc: int = 0):
    """ClusterScene from host arrays named like its tensor fields."""
    return ClusterScene(
        **{f: torch.tensor(np.asarray(arrays[f]), device=device)
           for f in CLUSTER_FIELDS},
        list_maxc=list_maxc,
    )


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit coords -> 30-bit Morton codes. x: [N,3] in [0,1]
    (sycl_ray_tracing_tpu/ops/bvh.py:64-79)."""
    q = np.clip((x * 1024.0), 0, 1023).astype(np.uint64)

    def spread(v):
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return (
        (spread(q[:, 0]) << np.uint64(2))
        | (spread(q[:, 1]) << np.uint64(1))
        | spread(q[:, 2])
    )


def sah_order(triangles: np.ndarray) -> np.ndarray:
    """Triangle permutation from the native binned-SAH builder's leaf order
    (depth-first leaves, first occurrence of each triangle).  Raises if
    the native builder cannot be built or its order is incomplete."""
    from sycl_ray_tracing_tpu_torch import native

    _, _, slots = native.sah_build(np.asarray(triangles, np.float32), 4)
    slots = slots[slots >= 0].astype(np.int64)
    _, first = np.unique(slots, return_index=True)
    order = slots[np.sort(first)]
    if order.size != triangles.shape[0]:
        raise RuntimeError(
            f"SAH leaf order covers {order.size} of {triangles.shape[0]} "
            "triangles"
        )
    return order


def morton_order(triangles: np.ndarray) -> np.ndarray:
    """Triangle permutation by the Morton code of AABB centroids."""
    tmin = triangles.min(axis=1)
    tmax = triangles.max(axis=1)
    cent = 0.5 * (tmin + tmax)
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-12)
    return np.argsort(_morton3((cent - lo) / span), kind="stable")


def build_cluster_arrays(triangles: np.ndarray, order="sah") -> dict:
    """Group triangles [N,3,3] into the two-level cluster tables (numpy,
    cluster.py:114-204).  ``order``: "sah" (native SAH leaf order),
    "morton", or an explicit permutation array."""
    tris = np.asarray(triangles, np.float32)
    n = tris.shape[0]
    if isinstance(order, str):
        if order == "sah":
            order = sah_order(tris)
        elif order == "morton":
            order = morton_order(tris)
        else:
            raise ValueError(f"bad cluster order {order!r}")
    order = np.asarray(order, np.int64)

    k2 = max(1, -(-n // T_CLUSTER))
    k1 = max(1, -(-k2 // S_CLUSTER))
    k2_pad = k1 * S_CLUSTER
    slot_count = k2_pad * T_CLUSTER

    # triangle slots (padded with degenerate zero triangles)
    sorted_tris = np.zeros((slot_count, 3, 3), np.float32)
    sorted_tris[:n] = tris[order]
    tri_idx = np.full((slot_count,), -1, np.int32)
    tri_idx[:n] = order.astype(np.int32)

    grouped = sorted_tris.reshape(k2_pad, T_CLUSTER, 3, 3)
    # coordinate-planar rows: [ax*T | ay*T | az*T | bx*T | ...]
    planar = np.transpose(grouped, (0, 2, 3, 1)).reshape(
        k2_pad, 9 * T_CLUSTER
    )
    # cluster AABBs; padding slots must not affect bounds
    valid = (tri_idx.reshape(k2_pad, T_CLUSTER) >= 0)[..., None]
    big = np.float32(3e38)
    vmin = np.where(valid, grouped.min(axis=2), big).min(axis=1)   # [K2,3]
    vmax = np.where(valid, grouped.max(axis=2), -big).max(axis=1)

    sc_min = vmin.reshape(k1, S_CLUSTER, 3).min(axis=1)
    sc_max = vmax.reshape(k1, S_CLUSTER, 3).max(axis=1)

    # empty (padding) groups get the always-miss box min = max = +big
    cl_empty = ~valid.any(axis=(1, 2))
    vmin[cl_empty] = big
    vmax[cl_empty] = big
    sc_empty = cl_empty.reshape(k1, S_CLUSTER).all(axis=1)
    sc_min[sc_empty] = big
    sc_max[sc_empty] = big

    cl_minmax = np.concatenate([vmin, vmax], axis=1)                # [K2,6]
    planes = np.transpose(
        cl_minmax.reshape(k1, S_CLUSTER, 6), (0, 2, 1)
    ).reshape(k1, 6 * S_CLUSTER)
    cl_box_rows = np.concatenate(
        [planes, np.zeros((k1, 2 * S_CLUSTER), np.float32)], axis=1
    )
    cl_box = np.concatenate(
        [vmin, vmax, np.zeros((k2_pad, 2), np.float32)], axis=1
    )
    sc_box = np.concatenate(
        [sc_min, sc_max, np.zeros((k1, 2), np.float32)], axis=1
    )
    return dict(
        sc_box=sc_box,
        cl_box_rows=cl_box_rows,
        cl_box=cl_box,
        cl_tris=planar,
        cl_tri_idx=tri_idx.reshape(k2_pad, T_CLUSTER),
    )


def build_clusters(triangles: np.ndarray, order="sah",
                   device="cpu") -> ClusterScene:
    """ClusterScene on ``device`` (see build_cluster_arrays)."""
    return clusters_from_numpy(build_cluster_arrays(triangles, order), device)


def inv_dir(ray_d):
    """Sign-preserving reciprocal direction, |d| floored at 1e-30."""
    sign = torch.where(ray_d < 0, -1.0, 1.0)
    return sign / torch.clamp_min(torch.abs(ray_d), 1e-30)


def dense_box_mask(boxes, ray_o, inv_d, t_lim):
    """Slab-test boxes [K,8] against rays: (hit [B,K], tnear [B,K])
    (cluster.py:474-493)."""
    ox, oy, oz = ray_o[:, 0:1], ray_o[:, 1:2], ray_o[:, 2:3]
    ix, iy, iz = inv_d[:, 0:1], inv_d[:, 1:2], inv_d[:, 2:3]
    x0 = (boxes[None, :, 0] - ox) * ix                 # [B,K]
    y0 = (boxes[None, :, 1] - oy) * iy
    z0 = (boxes[None, :, 2] - oz) * iz
    x1 = (boxes[None, :, 3] - ox) * ix
    y1 = (boxes[None, :, 4] - oy) * iy
    z1 = (boxes[None, :, 5] - oz) * iz
    tnear = torch.maximum(
        torch.maximum(torch.minimum(x0, x1), torch.minimum(y0, y1)),
        torch.minimum(z0, z1),
    )
    tfar = torch.minimum(
        torch.minimum(torch.maximum(x0, x1), torch.maximum(y0, y1)),
        torch.maximum(z0, z1),
    )
    hit = (tnear <= tfar) & (tfar > EPS) & (tnear < t_lim[:, None])
    return hit, tnear


def _id_bits(ncols: int) -> int:
    if ncols > 65536:
        raise ValueError("cluster-id field too wide (more than 65536 columns)")
    return max(11, (ncols - 1).bit_length())


def pack_keys(tnear, id_bits: int):
    """THE key packing, shared by extraction and the membership
    certificate: entry-t clipped to [0, 1e30], its float bits with the low
    ``id_bits`` cleared (rounding entry-t DOWN, which is conservative
    wherever it is consumed), OR the column id.  Non-negative float bits
    order like the floats, and the id bits make keys unique per row.
    (The JAX package adds a +2^23 bias before its float-domain top-k; an
    integer sort needs none.)"""
    id_mask = (1 << id_bits) - 1
    tbits = torch.clamp(tnear, 0.0, 1e30).view(torch.int32)
    ids = torch.arange(tnear.shape[-1], dtype=torch.int32,
                       device=tnear.device)
    return (tbits & ~id_mask) | ids


def extract_candidates(hit, tnear, maxc: int):
    """EXACT nearest-first extraction (the exact path of
    _extract_candidates_topk, cluster.py:590-666).

    (hit [R,K], tnear [R,K]) -> (cand [R,maxc] i32 column ids, -1 empty;
    ctn [R,maxc] f32 entry-t, BIG_T empty; overflow bool tensor).
    Rows that come back short (fewer kept than min(count, maxc)) are
    poisoned: last cand -> 0 if empty, last ctn -> -BIG_T.  With exact
    extraction that never happens, but the rule is kept as in JAX."""
    R, ncols = hit.shape
    id_bits = _id_bits(ncols)
    id_mask = (1 << id_bits) - 1
    rem = torch.where(hit, pack_keys(tnear, id_bits), _DEAD)
    k = min(maxc, ncols)
    kv = torch.sort(rem, dim=1).values[:, :k]
    if k < maxc:
        kv = torch.cat(
            [kv, torch.full((R, maxc - k), _DEAD, dtype=torch.int32,
                            device=kv.device)], dim=1)
    alive = kv < _DEAD
    cand = torch.where(alive, kv & id_mask, -1)
    ctn = torch.where(alive, (kv & ~id_mask).view(torch.float32), BIG_T)
    count = hit.sum(dim=1)
    got = alive.sum(dim=1)
    short = got < torch.clamp_max(count, maxc)
    over = short | (count > maxc)
    cand[:, -1] = torch.where(over & (cand[:, -1] < 0), 0, cand[:, -1])
    ctn[:, -1] = torch.where(short, -BIG_T, ctn[:, -1])
    return cand, ctn, over.any()


def membership_cert(hit, tn_blk, cand, ctn, group: int):
    """Per-ray MEMBERSHIP exactness certificate for block-union lists
    (cluster.py:676-725): a ray is exact, even in a FULL block, when every
    column it hits is among the kept columns, i.e. its block key is at or
    below the last kept key.  Poisoned rows never certify.

    hit [B,K] per-ray, tn_blk [nb,K] block-min entry-t, cand/ctn [nb,maxc].
    Returns covered [B] bool."""
    nb, ncols = tn_blk.shape
    id_bits = _id_bits(ncols)
    id_mask = (1 << id_bits) - 1
    bkey = pack_keys(tn_blk, id_bits)                     # [nb,K]
    full = cand[:, -1] >= 0
    poisoned = ctn[:, -1] < 0.0                           # -BIG_T sentinel
    last_key = ((ctn[:, -1].contiguous().view(torch.int32) & ~id_mask)
                | torch.clamp_min(cand[:, -1], 0))
    thr = torch.where(full, last_key, _DEAD)
    drop_col = bkey > thr[:, None]                        # [nb,K]
    dropped = (hit.view(nb, group, ncols) & drop_col[:, None, :]).any(dim=2)
    covered = (~dropped) & (~poisoned)[:, None]
    return covered.reshape(-1)


def _row_chunks(rows: int, ncols: int, group: int):
    step = max(group, (_CHUNK_ELEMS // max(1, ncols)) // group * group)
    for lo in range(0, rows, step):
        yield lo, min(rows, lo + step)


def candidate_clusters(scene: ClusterScene, ray_o, ray_d, t_lim, maxc: int):
    """Per-ray nearest-first candidate cluster lists (cluster.py:728-743,
    exact).  Returns (cand [B,maxc] i32, -1 empty; ctn [B,maxc] f32,
    BIG_T empty; overflow bool tensor: some ray hit more than maxc boxes)."""
    inv_d = inv_dir(ray_d)
    cands, ctns, ovf = [], [], torch.zeros((), dtype=torch.bool,
                                           device=ray_o.device)
    for lo, hi in _row_chunks(ray_o.shape[0], scene.num_clusters, 1):
        hit, tnear = dense_box_mask(scene.cl_box, ray_o[lo:hi], inv_d[lo:hi],
                                    t_lim[lo:hi])
        c, t, o = extract_candidates(hit, tnear, maxc)
        cands.append(c)
        ctns.append(t)
        ovf = ovf | o
    return torch.cat(cands), torch.cat(ctns), ovf


def candidate_clusters_grouped(scene: ClusterScene, ray_o, ray_d, t_lim,
                               maxc: int, group: int):
    """Per-BLOCK (``group`` consecutive rays) candidate lists: the union of
    the block's per-ray cluster hits, nearest-first by the block entry-t
    (cluster.py:746-781, exact, with the membership certificate).

    Returns (cand [B/group, maxc], ctn [B/group, maxc], overflow,
    covered [B])."""
    B = ray_o.shape[0]
    if B % group:
        raise ValueError(f"{B} rays do not divide into blocks of {group}")
    k2 = scene.num_clusters
    inv_d = inv_dir(ray_d)
    cands, ctns, covs = [], [], []
    ovf = torch.zeros((), dtype=torch.bool, device=ray_o.device)
    for lo, hi in _row_chunks(B, k2, group):
        hit, tnear = dense_box_mask(scene.cl_box, ray_o[lo:hi], inv_d[lo:hi],
                                    t_lim[lo:hi])
        nb = (hi - lo) // group
        hit_g = hit.view(nb, group, k2).any(dim=1)
        tn_g = torch.where(hit, torch.clamp_min(tnear, 0.0), BIG_T)
        del tnear
        tn_g = tn_g.view(nb, group, k2).amin(dim=1)
        c, t, o = extract_candidates(hit_g, tn_g, maxc)
        covs.append(membership_cert(hit, tn_g, c, t, group))
        cands.append(c)
        ctns.append(t)
        ovf = ovf | o
    return torch.cat(cands), torch.cat(ctns), ovf, torch.cat(covs)
