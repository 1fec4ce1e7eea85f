"""Clustered geometry and the candidate-list builds for the list tracer
(counterpart of sycl_ray_tracing_tpu/ops/cluster.py).

Triangles are grouped into clusters of T_CLUSTER=128 (Morton order by
default, or the SAH leaf order that Scene.build_acceleration asks for) and
superclusters of S_CLUSTER=64; the tables are built in numpy exactly as
the JAX package builds them.

The candidate builds are plain torch (they are XLA, not Pallas, in the
JAX package), but for one: on CUDA tensors the grouped supercluster build
runs as one hand-written kernel (csrc/hier_build.cu, loaded through
ops/kernels/cuda_lib.py), its plain version ``_hier_rows`` the CPU path
and its twin:
  * the dense builds (``candidate_clusters``, ``_grouped``): a [rays, K2]
    slab test, the nearest-first extraction (packed quantized-entry-t |
    cluster-id keys, sorted; ``exact`` chooses which rows keep their
    certificate) and the per-ray membership certificate;
  * the supercluster-prefiltered build (``candidate_clusters_hier``) for
    scenes above 2*maxs*64 clusters: a [rays, K1] supercluster slab test,
    the threshold-min extraction of each block's ``maxs`` nearest
    superclusters, then the same exact extraction over the C = maxs*64
    child boxes of those superclusters only.
Every step is row-local (block-local), so each build runs in row chunks
to bound its [rows, columns] transients; chunking does not change any
result.  ``utils.metrics.COUNTS`` counts the builds: "cand_build.fused"
the kernel's launches, "cand_build.plain" the builds the torch code made.

The XLA pair tracer (the "cluster" backend, cluster.py:207-416,
:922-976) is plain torch too: a dense [B,K1] supercluster slab test,
the exact stream compaction of the hit (ray, supercluster) pairs into a
static ``p1_budget``, the [P1,64] child-box test (or, with ``fanout``,
each pair's ``fanout`` nearest children), the compaction of the hit
(ray, cluster) pairs into ``p2_budget``, Möller–Trumbore on each pair's
128 triangles, and segment reductions (``scatter_reduce`` amin / amax)
back to rays.  A pair past a budget is dropped and raises the overflow
flag, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sycl_ray_tracing_tpu_torch.ops.intersect import (
    BIG_T,
    Hit,
    _mt_scalar,
    finalize_hit,
)
from sycl_ray_tracing_tpu_torch.ops.kernels.cuda_lib import (
    kernel_info,
    load_cuda_library,
    stream_of,
)
from sycl_ray_tracing_tpu_torch.ops.safe_math import EPS
from sycl_ray_tracing_tpu_torch.utils.device import resolve_device
from sycl_ray_tracing_tpu_torch.utils.metrics import tally

T_CLUSTER = 128      # triangles per cluster
S_CLUSTER = 64       # clusters per supercluster
SHADOW_EPS = 1e-4    # reference t_max slack (render_kernel.cpp:751)
_DEAD = 0x7F800000   # +inf bits: a packed key above every real key
# [rows, K2] elements per chunk of the dense build (~128 MB per f32 array)
_CHUNK_ELEMS = 1 << 25
# the fused supercluster build's arrays: superclusters (MAX_CLUSTERS / S),
# supercluster and candidate slots, rays a block (a bit of a mask each)
HIER_MAX_K1 = 128
HIER_MAX_SLOTS = 128
HIER_MAX_GROUP = 32
# pairs a ray is budgeted for (default_budgets): (ray, supercluster)
# pairs, at most one a supercluster, and (ray, cluster) pairs
P1_PER_RAY, P2_PER_RAY = 8, 18


@dataclasses.dataclass(frozen=True)
class ClusterScene:
    """Two-level clustered geometry (padded to full 64-cluster groups)."""

    sc_box: torch.Tensor       # [K1,8] f32 supercluster AABB (min3,max3,0,0)
    cl_box_rows: torch.Tensor  # [K1, 8*S] f32 child AABBs, planar rows
    cl_box: torch.Tensor       # [K2,8] f32 per-cluster AABB
    cl_tris: torch.Tensor      # [K2, 9*T] f32 planar triangle coordinate rows
    cl_tri_idx: torch.Tensor   # [K2, T] i32 original tri index (-1 pad)
    # the pair tracer's static (ray, supercluster) and (ray, cluster) pair
    # budgets (build_clusters sets them; 0 here as in the JAX package),
    # and its per-pair child cap (0 = every hit child, the exact path)
    p1_budget: int = 0
    p2_budget: int = 0
    fanout: int = 0
    # per-ray candidate-list depth override for the list tracer (0 = module
    # defaults): the overflow-regrow knob of the JAX package
    list_maxc: int = 0

    @property
    def num_clusters(self) -> int:
        return self.cl_tris.shape[0]

    @property
    def num_superclusters(self) -> int:
        return self.sc_box.shape[0]

    @property
    def budget_rays(self) -> int:
        """Rays one pair-tracer call holds at the pair densities its
        budgets were sized for (default_budgets).  The budgets are
        static, so a wider call drops pairs past them and raises the
        overflow flag: a tiled render batches no more rays than this."""
        p1_per_ray = min(P1_PER_RAY, max(1, self.num_superclusters))
        return min(self.p1_budget // p1_per_ray,
                   self.p2_budget // P2_PER_RAY)

    def with_list_maxc(self, maxc: int) -> "ClusterScene":
        return dataclasses.replace(self, list_maxc=maxc)

    def with_budgets(self, p1: int, p2: int) -> "ClusterScene":
        return dataclasses.replace(self, p1_budget=p1, p2_budget=p2)

    def with_fanout(self, f: int) -> "ClusterScene":
        return dataclasses.replace(self, fanout=f)


CLUSTER_FIELDS = ("sc_box", "cl_box_rows", "cl_box", "cl_tris", "cl_tri_idx")
# the static fields scene_from_numpy carries beside the tables
CLUSTER_STATIC = ("list_maxc", "p1_budget", "p2_budget", "fanout")


def clusters_from_numpy(arrays: dict, device, **static):
    """ClusterScene from host arrays named like its tensor fields;
    ``static``: any of CLUSTER_STATIC."""
    return ClusterScene(
        **{f: torch.tensor(np.asarray(arrays[f]), device=device)
           for f in CLUSTER_FIELDS},
        **{k: int(v) for k, v in static.items()},
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


def build_cluster_arrays(triangles: np.ndarray, order=None) -> dict:
    """Group triangles [N,3,3] into the two-level cluster tables (numpy,
    cluster.py:114-204).  ``order``: "sah" (native SAH leaf order; raises
    if the native builder cannot be built), an explicit permutation
    array, or None or any other string for the Morton order of AABB
    centroids, as in the JAX package."""
    tris = np.asarray(triangles, np.float32)
    n = tris.shape[0]
    if isinstance(order, str) and order == "sah":
        order = sah_order(tris)
    elif order is None or isinstance(order, str):
        order = morton_order(tris)
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


def build_clusters(triangles: np.ndarray, order=None, p1_budget: int = 0,
                   p2_budget: int = 0, device="cuda") -> ClusterScene:
    """ClusterScene on ``device`` (see build_cluster_arrays) with the pair
    tracer's budgets; a budget of 0 means its default, 16*1024 or
    64*1024."""
    device = resolve_device(device)
    return clusters_from_numpy(build_cluster_arrays(triangles, order), device,
                               p1_budget=p1_budget or 16 * 1024,
                               p2_budget=p2_budget or 64 * 1024)


def inv_dir(ray_d):
    """Sign-preserving reciprocal direction, |d| floored at 1e-30."""
    sign = torch.where(ray_d < 0, -1.0, 1.0)
    return sign / torch.clamp_min(torch.abs(ray_d), 1e-30)


def _slab_test(box, ray_o, inv_d, t_lim):
    """The slab test on broadcastable operands: ``box`` the six planes
    (min x, y, z, max x, y, z), ``ray_o`` and ``inv_d`` three axes each,
    ``t_lim`` the rays' limit.  Returns (hit, tnear)."""
    x0 = (box[0] - ray_o[0]) * inv_d[0]
    y0 = (box[1] - ray_o[1]) * inv_d[1]
    z0 = (box[2] - ray_o[2]) * inv_d[2]
    x1 = (box[3] - ray_o[0]) * inv_d[0]
    y1 = (box[4] - ray_o[1]) * inv_d[1]
    z1 = (box[5] - ray_o[2]) * inv_d[2]
    tnear = torch.maximum(
        torch.maximum(torch.minimum(x0, x1), torch.minimum(y0, y1)),
        torch.minimum(z0, z1),
    )
    tfar = torch.minimum(
        torch.minimum(torch.maximum(x0, x1), torch.maximum(y0, y1)),
        torch.maximum(z0, z1),
    )
    hit = (tnear <= tfar) & (tfar > EPS) & (tnear < t_lim)
    return hit, tnear


def dense_box_mask(boxes, ray_o, inv_d, t_lim):
    """Slab-test boxes [K,8] against rays: (hit [B,K], tnear [B,K])
    (cluster.py:474-493)."""
    return _slab_test([boxes[None, :, c] for c in range(6)],
                      [ray_o[:, a:a + 1] for a in range(3)],
                      [inv_d[:, a:a + 1] for a in range(3)], t_lim[:, None])


def _id_bits(ncols: int) -> int:
    if ncols > 65536:
        raise ValueError("cluster-id field too wide (more than 65536 columns)")
    return max(11, (ncols - 1).bit_length())


def pack_keys(tnear, id_bits: int, t_max: float = 1e30):
    """THE key packing, shared by both extractions and the membership
    certificate: entry-t clipped to [0, t_max], its float bits with the low
    ``id_bits`` cleared (rounding entry-t DOWN, which is conservative
    wherever it is consumed), OR the column id.  Non-negative float bits
    order like the floats, and the id bits make keys unique per row.
    The exact extraction clips at 1e30, as the JAX package's top-k does
    (its +2^23 bias before a float-domain top-k is not needed by an
    integer sort); its threshold-min extraction clips only at 0, so
    ``t_max=inf`` reproduces it.  The two keys differ only where a hit
    box's entry-t exceeds 1e30.  torch keeps the sign of -0.0 through a
    clamp where XLA gives +0.0, so ``abs`` clears it: the key of an entry-t
    of -0.0 is that of 0."""
    id_mask = (1 << id_bits) - 1
    tbits = torch.clamp(tnear, 0.0, t_max).abs().view(torch.int32)
    ids = torch.arange(tnear.shape[-1], dtype=torch.int32,
                       device=tnear.device)
    return (tbits & ~id_mask) | ids


def _unpack(kv, id_mask: int):
    """Sorted keys -> (cand, -1 where dead; ctn, BIG_T where dead; alive)."""
    alive = kv < _DEAD
    cand = torch.where(alive, kv & id_mask, -1)
    ctn = torch.where(alive, (kv & ~id_mask).view(torch.float32), BIG_T)
    return cand, ctn, alive


def _pad_cols(kv, maxc: int):
    """A row's first maxc sorted keys, dead keys past its columns."""
    if kv.shape[1] >= maxc:
        return kv[:, :maxc]
    return torch.cat([kv, torch.full((kv.shape[0], maxc - kv.shape[1]), _DEAD,
                                     dtype=torch.int32, device=kv.device)],
                     dim=1)


def extract_candidates(hit, tnear, maxc: int, exact: bool = False):
    """Nearest-first extraction (_extract_candidates_topk,
    cluster.py:590-666).

    (hit [R,K], tnear [R,K]) -> (cand [R,maxc] i32 column ids, -1 empty;
    ctn [R,maxc] f32 entry-t, BIG_T empty; overflow bool tensor).
    Rows that come back short (fewer kept than min(count, maxc)) are
    poisoned: last cand -> 0 if empty, last ctn -> -BIG_T.  With
    ``exact=False`` FULL rows (count > maxc) are poisoned too: the JAX
    package's approximate top-k may swap a nearest key for a farther one
    there unseen, so its certificate is not trusted.

    The kept set is the maxc nearest keys in both modes: JAX's
    ``approx_min_k`` returns that exact set on the CPU, where the two
    packages are held against each other, so the modes differ only by
    the poisoning."""
    id_bits = _id_bits(hit.shape[1])
    rem = torch.where(hit, pack_keys(tnear, id_bits), _DEAD)
    kv = _pad_cols(torch.sort(rem, dim=1).values, maxc)
    cand, ctn, alive = _unpack(kv, (1 << id_bits) - 1)
    count = hit.sum(dim=1)
    got = alive.sum(dim=1)
    short = got < torch.clamp_max(count, maxc)
    over = short | (count > maxc)
    cand[:, -1] = torch.where(over & (cand[:, -1] < 0), 0, cand[:, -1])
    ctn[:, -1] = torch.where(short if exact else over, -BIG_T, ctn[:, -1])
    return cand, ctn, over.any()


def extract_candidates_min(hit, tnear, maxc: int):
    """THRESHOLD-MIN extraction (_extract_candidates, cluster.py:519-570),
    which the supercluster build uses for each block's supercluster list.

    (hit [R,K], tnear [R,K]) -> (cand [R,maxc] i32 column ids, -1 empty;
    ctn [R,maxc] f32 entry-t, BIG_T empty; overflow bool tensor: a live
    key is left after the maxc kept).  The JAX package takes maxc
    dependent rounds, each the least key above the last one; keys are
    unique per row, so the first maxc keys of one sort are the same keys
    in the same order.  Its keys clip entry-t at 0 only (pack_keys'
    ``t_max=inf``), and no row is poisoned."""
    id_bits = _id_bits(hit.shape[1])
    rem = torch.where(hit, pack_keys(tnear, id_bits, float("inf")), _DEAD)
    kv = torch.sort(rem, dim=1).values
    if kv.shape[1] > maxc:
        over = (kv[:, maxc] < _DEAD).any()
    else:
        over = torch.zeros((), dtype=torch.bool, device=kv.device)
    cand, ctn, _alive = _unpack(_pad_cols(kv, maxc), (1 << id_bits) - 1)
    return cand, ctn, over


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


def candidate_clusters(scene: ClusterScene, ray_o, ray_d, t_lim, maxc: int,
                       exact: bool = False):
    """Per-ray nearest-first candidate cluster lists (cluster.py:728-743).
    Returns (cand [B,maxc] i32, -1 empty; ctn [B,maxc] f32, BIG_T empty;
    overflow bool tensor: some ray hit more than maxc boxes).  ``exact``:
    see extract_candidates; every list-tracer pass asks for it."""
    tally("cand_build.plain")
    inv_d = inv_dir(ray_d)
    cands, ctns, ovf = [], [], torch.zeros((), dtype=torch.bool,
                                           device=ray_o.device)
    for lo, hi in _row_chunks(ray_o.shape[0], scene.num_clusters, 1):
        hit, tnear = dense_box_mask(scene.cl_box, ray_o[lo:hi], inv_d[lo:hi],
                                    t_lim[lo:hi])
        c, t, o = extract_candidates(hit, tnear, maxc, exact)
        cands.append(c)
        ctns.append(t)
        ovf = ovf | o
    return torch.cat(cands), torch.cat(ctns), ovf


def candidate_clusters_grouped(scene: ClusterScene, ray_o, ray_d, t_lim,
                               maxc: int, group: int, exact: bool = False,
                               ray_cert: bool = False):
    """Per-BLOCK (``group`` consecutive rays) candidate lists: the union of
    the block's per-ray cluster hits, nearest-first by the block entry-t
    (cluster.py:746-781).

    Returns (cand [B/group, maxc], ctn [B/group, maxc], overflow), plus
    covered [B], the per-ray membership certificate, with ``ray_cert``,
    which needs ``exact``."""
    B = ray_o.shape[0]
    if B % group:
        raise ValueError(f"{B} rays do not divide into blocks of {group}")
    _check_ray_cert(exact, ray_cert)
    tally("cand_build.plain")
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
        c, t, o = extract_candidates(hit_g, tn_g, maxc, exact)
        if ray_cert:
            covs.append(membership_cert(hit, tn_g, c, t, group))
        cands.append(c)
        ctns.append(t)
        ovf = ovf | o
    if ray_cert:
        return torch.cat(cands), torch.cat(ctns), ovf, torch.cat(covs)
    return torch.cat(cands), torch.cat(ctns), ovf


def _check_ray_cert(exact: bool, ray_cert: bool):
    """The membership certificate reads the kept set as a key prefix,
    which only exact extraction guarantees (the JAX package asserts it)."""
    if ray_cert and not exact:
        raise ValueError("ray_cert needs exact=True: the membership "
                         "certificate holds for exact extraction only")


def candidate_clusters_hier(scene: ClusterScene, ray_o, ray_d, t_lim,
                            maxc: int, maxs: int = 12, group: int = 8,
                            grouped: bool = False, exact: bool = False,
                            ray_cert: bool = False, impl=None):
    """Nearest-first candidate lists through a SUPERCLUSTER prefilter
    (cluster.py:784-919): per-ray lists [B, maxc], or with
    ``grouped=True`` per-BLOCK union lists [B/group, maxc] (the block
    kernel's contract), built over C = maxs*64 prefiltered columns instead
    of all K2 clusters:

      1. a [B, K1] supercluster slab test, reduced per block of ``group``
         rays (union of hits, block-min entry-t);
      2. each block's ``maxs`` nearest superclusters (threshold-min
         extraction, extract_candidates_min);
      3. per-ray slab tests against those superclusters' 64 child boxes
         each ([B, C], from the gathered planar rows ``cl_box_rows``);
      4. extract_candidates (with ``exact``) over the C local columns (per
         ray, or per block on the union), local ids mapped back to global
         cluster ids through the block's supercluster list.

    Equal to the dense build wherever no block hits more than ``maxs``
    superclusters (entry-t up to the id-bit quantization).  A block that
    does (SC overflow) raises ``overflow`` and its rows are poisoned as in
    the JAX package: last ctn -> -BIG_T, last cand -> 0 where it was
    empty, so no certificate fires on them.

    ``ray_cert=True`` (only with ``grouped=True`` and ``exact=True``) also
    returns covered [B], the per-ray membership certificate over the local
    columns, False in every SC-overflow block.  Returns (cand, ctn,
    overflow[, covered]).  Runs in block-aligned row chunks; chunking
    changes no result.

    Where it runs, as ``listtrace.block_tiles`` chooses: with
    ``grouped=True`` CUDA tensors launch the fused kernel
    (``_hier_cuda``, bit for bit the torch version), and CPU tensors or
    ``impl="plain"`` take the torch version (``_hier_rows``), which also
    builds every per-ray (``grouped=False``) list on either device: those
    lists keep no block union, so the block kernel does not build them
    (the list tracer asks for them only with a pinned ``maxc``, which no
    benchmark cell runs).  ``impl="cuda"`` asks for the kernel."""
    B = ray_o.shape[0]
    if B % group:
        raise ValueError(f"{B} rays do not divide into blocks of {group}")
    if ray_cert and not grouped:
        raise ValueError("ray_cert needs grouped=True: the membership "
                         "certificate is defined for block lists only")
    _check_ray_cert(exact, ray_cert)
    if not _hier_plain(scene, ray_o, maxc, maxs, group, grouped, impl):
        return _hier_cuda(scene, ray_o, ray_d, t_lim, maxc, maxs, group,
                          exact, ray_cert)
    tally("cand_build.plain")
    inv_d = inv_dir(ray_d)
    outs = [_hier_rows(scene, ray_o[lo:hi], inv_d[lo:hi], t_lim[lo:hi],
                       maxc, maxs, group, grouped, exact, ray_cert)
            for lo, hi in _row_chunks(B, maxs * S_CLUSTER, group)]
    cand = torch.cat([o[0] for o in outs])
    ctn = torch.cat([o[1] for o in outs])
    ovf = torch.stack([o[2] for o in outs]).any()
    if ray_cert:
        return cand, ctn, ovf, torch.cat([o[3] for o in outs])
    return cand, ctn, ovf


def _hier_plain(scene: ClusterScene, ray_o, maxc: int, maxs: int,
                group: int, grouped: bool, impl) -> bool:
    """Whether candidate_clusters_hier takes its torch version (see its
    docstring); raises on a bad ``impl``, and where the kernel is asked
    for, on what it cannot take."""
    if impl not in (None, "plain", "cuda"):
        raise ValueError(f"bad impl {impl!r}")
    if impl == "plain" or (impl is None and (not grouped or not ray_o.is_cuda)):
        return True
    if not grouped:
        raise ValueError("candidate_clusters_hier: the kernel builds block "
                         "lists only (grouped=True)")
    _check_hier_shapes(scene, maxc, maxs, group)
    if not ray_o.is_cuda:
        raise ValueError("candidate_clusters_hier: the CUDA kernel needs "
                         "CUDA tensors")
    return False


def _check_hier_shapes(scene: ClusterScene, maxc: int, maxs: int,
                       group: int):
    """The shapes the fused kernel's shared arrays hold."""
    k1 = scene.num_superclusters
    if not 1 <= k1 <= HIER_MAX_K1:
        raise ValueError(f"the fused build takes 1 to {HIER_MAX_K1} "
                         f"superclusters, got {k1}")
    for name, v, top in (("maxs", maxs, HIER_MAX_SLOTS),
                         ("maxc", maxc, HIER_MAX_SLOTS),
                         ("group", group, HIER_MAX_GROUP)):
        if not 1 <= v <= top:
            raise ValueError(f"the fused build takes {name} 1 to {top}, "
                             f"got {v}")
    if tuple(scene.sc_box.shape) != (k1, 8) or \
            tuple(scene.cl_box_rows.shape) != (k1, 8 * S_CLUSTER):
        raise ValueError("the fused build needs sc_box [K1, 8] and "
                         "cl_box_rows [K1, 8*64]")


def _hier_cuda(scene: ClusterScene, ray_o, ray_d, t_lim, maxc: int,
               maxs: int, group: int, exact: bool, ray_cert: bool):
    """Launch the fused supercluster build (csrc/hier_build.cu) over all
    B / group blocks at once; arguments as candidate_clusters_hier,
    already checked.  Returns what it returns with grouped=True."""
    B = ray_o.shape[0]
    dev = ray_o.device
    tables = (scene.sc_box, scene.cl_box_rows)
    if any(t.dtype != torch.float32 for t in (ray_o, ray_d, t_lim) + tables):
        raise TypeError("the fused build takes float32 rays and tables")
    if ray_o.shape != (B, 3) or ray_d.shape != (B, 3) or t_lim.shape != (B,):
        raise ValueError("ray_o, ray_d must be [B, 3] and t_lim [B]")
    if any(t.device != dev for t in (ray_d, t_lim) + tables):
        raise ValueError("rays and cluster tables must share a device")
    tables = tuple(t.contiguous() for t in tables)
    # rows may be strided (the list tracer passes columns of its ray rows)
    ray_o, ray_d = (x if x.stride(1) == 1 else x.contiguous()
                    for x in (ray_o, ray_d))
    nb = B // group
    cand = torch.empty((nb, maxc), dtype=torch.int32, device=dev)
    ctn = torch.empty((nb, maxc), dtype=torch.float32, device=dev)
    covered = torch.empty((B,), dtype=torch.bool, device=dev) \
        if ray_cert else None
    flag = torch.empty((nb,), dtype=torch.bool, device=dev)
    if nb:
        rc = load_cuda_library().srt_hier_build(
            tables[0].data_ptr(), tables[1].data_ptr(), ray_o.data_ptr(),
            ray_o.stride(0), ray_d.data_ptr(), ray_d.stride(0),
            t_lim.data_ptr(), t_lim.stride(0), cand.data_ptr(),
            ctn.data_ptr(), None if covered is None else covered.data_ptr(),
            flag.data_ptr(), nb, scene.num_superclusters, maxs, maxc, group,
            int(exact), _id_bits(scene.num_superclusters),
            _id_bits(maxs * S_CLUSTER), stream_of(ray_o))
        if rc != 0:
            raise RuntimeError(f"hier_build launch failed: CUDA error {rc}")
        tally("cand_build.fused")
    if ray_cert:
        return cand, ctn, flag.any(), covered
    return cand, ctn, flag.any()


def hier_build_info(maxs: int) -> dict:
    """The built fused kernel's registers, spill and occupancy, with the
    shared memory of maxs * 64 columns."""
    return kernel_info("hier_build", load_cuda_library().srt_hier_build_info,
                       maxs * S_CLUSTER)


def _hier_rows(scene: ClusterScene, ray_o, inv_d, t_lim, maxc: int,
               maxs: int, group: int, grouped: bool, exact: bool,
               ray_cert: bool):
    """candidate_clusters_hier on one block-aligned chunk of rays."""
    R = ray_o.shape[0]
    nb = R // group
    S = S_CLUSTER
    C = maxs * S
    k1 = scene.num_superclusters
    # 1-2: each block's nearest superclusters
    m1, tn1 = dense_box_mask(scene.sc_box, ray_o, inv_d, t_lim)    # [R,K1]
    hit_g = m1.view(nb, group, k1).any(dim=1)
    tn_g = torch.where(m1, torch.clamp_min(tn1, 0.0), BIG_T)
    tn_g = tn_g.view(nb, group, k1).amin(dim=1)
    scand, _sctn, _of = extract_candidates_min(hit_g, tn_g, maxs)
    # SC overflow: the block may miss nearer clusters of dropped
    # superclusters, so none of its certificates may fire
    sc_of = hit_g.sum(dim=1) > maxs                               # [nb]
    # 3: per-ray slab tests against the kept superclusters' child boxes
    rows = scene.cl_box_rows[torch.clamp_min(scand, 0).long()]
    box = rows.view(nb, 1, maxs, 8, S)
    o4 = ray_o.view(nb, group, 1, 3, 1)
    i4 = inv_d.view(nb, group, 1, 3, 1)
    hit2, tnear = _slab_test([box[:, :, :, c] for c in range(6)],
                             [o4[:, :, :, a] for a in range(3)],
                             [i4[:, :, :, a] for a in range(3)],
                             t_lim.view(nb, group, 1, 1))
    hit2 = hit2 & (scand >= 0).view(nb, 1, maxs, 1)              # [nb,g,maxs,S]
    covered = None
    if grouped:
        # 4: block union lists over the local columns
        hit_b = hit2.view(nb, group, C).any(dim=1)
        tn_b = torch.where(hit2, torch.clamp_min(tnear, 0.0), BIG_T)
        tn_b = tn_b.view(nb, group, C).amin(dim=1)
        cand_l, ctn, of2 = extract_candidates(hit_b, tn_b, maxc, exact)
        if ray_cert:
            covered = membership_cert(hit2.view(R, C), tn_b, cand_l, ctn,
                                      group)
            covered = covered & ~sc_of.repeat_interleave(group)
        sc_list = scand
        row_of = sc_of
    else:
        # 4: per-ray lists over the local columns
        cand_l, ctn, of2 = extract_candidates(hit2.view(R, C),
                                              tnear.view(R, C), maxc, exact)
        sc_list = scand.repeat_interleave(group, dim=0)
        row_of = sc_of.repeat_interleave(group)
    slot = torch.clamp_min(cand_l, 0)
    sc_g = torch.gather(sc_list, 1, torch.div(slot, S,
                                              rounding_mode="floor").long())
    cand = torch.where(cand_l >= 0, sc_g * S + slot % S, -1)
    # SC-overflow rows: poison the certificate (cluster 0 as the filler id
    # of an empty last slot is a real, harmless re-test)
    cand[:, -1] = torch.where(row_of & (cand[:, -1] < 0), 0, cand[:, -1])
    ctn[:, -1] = torch.where(row_of, -BIG_T, ctn[:, -1])
    return cand, ctn, sc_of.any() | of2, covered


# ---- the XLA pair tracer (the "cluster" backend) ----

def default_budgets(num_rays: int, k1: int):
    """Pair budgets sized from the densities measured on the dragon at
    T=128 (cluster.py:207-213): surface-origin rays average ~5
    supercluster pairs and ~13 cluster pairs a ray."""
    p1 = num_rays * min(P1_PER_RAY, max(1, k1))
    p2 = num_rays * P2_PER_RAY
    return p1, p2


def _compact_mask(mask2d, budget: int, payload=None):
    """Stream-compact the True positions of mask [A,C] into (row [P],
    col [P], valid [P], overflow[, payload rows [P,D]]) with P = budget,
    row-major, EXACT (cluster.py:419-470): output slot q finds its row by a
    binary search of the rows' inclusive count ends and its column by the
    rank of q within that row.  Slots past the total come back invalid on
    the last row."""
    A, C = mask2d.shape
    dev = mask2d.device
    cum = torch.cumsum(mask2d.to(torch.int32), dim=1, dtype=torch.int32)
    counts = cum[:, -1]
    ends = torch.cumsum(counts, dim=0, dtype=torch.int32)
    total = ends[-1]
    base = ends - counts
    q = torch.arange(budget, dtype=torch.int32, device=dev)
    row = torch.searchsorted(ends, q, right=True).to(torch.int32)
    rowc = torch.clamp_max(row, A - 1)
    parts = [base[:, None], cum]
    if payload is not None:
        parts.append(payload.to(torch.int32))
    cumx_g = torch.cat(parts, dim=1)[rowc.long()]         # [P, C+1(+D)]
    j = q - cumx_g[:, 0]
    col = (cumx_g[:, 1:C + 1] <= j[:, None]).sum(dim=1, dtype=torch.int32)
    col = torch.clamp_max(col, C - 1)
    valid = q < total
    if payload is not None:
        return rowc, col, valid, total > budget, cumx_g[:, C + 1:]
    return rowc, col, valid, total > budget


def _expand_pairs(mask, budget: int):
    """mask [A,C] -> (row [P], col [P], valid [P], overflow); invalid
    entries carry (A, C) (cluster.py:232-239)."""
    r, c, valid, overflow = _compact_mask(mask, budget)
    r = torch.where(valid, r, mask.shape[0])
    c = torch.where(valid, c, mask.shape[1])
    return r, c, valid, overflow


def _build_pairs(scene: ClusterScene, ray_o, ray_d, t_lim):
    """Phases 1-2: culling and pair expansion (cluster.py:247-352).
    Returns (r2 [P2] ray ids (B where invalid), c2 [P2] cluster ids,
    valid2 [P2], rays12 [B,12] packed ray rows, overflow)."""
    B = ray_o.shape[0]
    S = S_CLUSTER
    inv_d = inv_dir(ray_d)
    # packed per-ray rows: o(3) d(3) inv(3) t_lim(1) pad(2)
    rays12 = torch.cat([ray_o, ray_d, inv_d, t_lim[:, None],
                        torch.zeros((B, 2), dtype=ray_o.dtype,
                                    device=ray_o.device)], dim=1)
    # phase 1: dense supercluster tests
    m1, _ = dense_box_mask(scene.sc_box, ray_o, inv_d, t_lim)    # [B,K1]
    r1, s1, valid1, of1 = _expand_pairs(m1, scene.p1_budget)
    r1c = torch.clamp_max(r1, B - 1)
    s1c = torch.clamp_max(s1, scene.num_superclusters - 1)
    # phase 2: each pair's 64 child boxes from one planar row
    rowsb = scene.cl_box_rows[s1c.long()]                         # [P1,8S]
    rg1 = rays12[r1c.long()]                                      # [P1,12]
    box = [rowsb[:, k * S:(k + 1) * S] for k in range(6)]
    hit2, tnear = _slab_test(box, [rg1[:, a:a + 1] for a in range(3)],
                             [rg1[:, 6 + a:7 + a] for a in range(3)],
                             rg1[:, 9:10])
    m2 = hit2 & valid1[:, None]                                   # [P1,S]
    if scene.fanout > 0:
        # each pair's ``fanout`` nearest hit children by argmin rounds;
        # a pair with more hit children overflows
        F = scene.fanout
        lanes = torch.arange(S, device=m2.device)[None]
        m = m2
        sel_cols, sel_ok = [], []
        for _ in range(F):
            c = torch.argmin(torch.where(m, tnear, BIG_T), dim=1)  # [P1]
            sel_ok.append(torch.gather(m, 1, c[:, None])[:, 0])
            sel_cols.append(c.to(torch.int32))
            m = m & (lanes != c[:, None])
        of_fanout = m.any()
        mF = torch.stack(sel_ok, dim=1)                           # [P1,F]
        cF = torch.stack(sel_cols, dim=1)
        payload = torch.cat([r1c[:, None], s1c[:, None], cF], dim=1)
        _p2c, f_idx, valid2, of2, pay = _compact_mask(
            mF, scene.p2_budget, payload)
        c2_local = torch.gather(pay[:, 2:], 1,
                                torch.clamp_max(f_idx, F - 1)[:, None]
                                .long())[:, 0]
        of2 = of2 | of_fanout
    else:
        payload = torch.cat([r1c[:, None], s1c[:, None]], dim=1)
        _p2c, c2_local, valid2, of2, pay = _compact_mask(
            m2, scene.p2_budget, payload)
        c2_local = torch.clamp_max(c2_local, S - 1)
    r2 = torch.where(valid2, pay[:, 0], B)
    c2 = pay[:, 1] * S + c2_local
    return r2, c2, valid2, rays12, of1 | of2


def _mt_rows_scalar(tri_rows, o, d):
    """Möller–Trumbore on planar triangle rows [P, 9*T] against per-row
    rays o, d [P,3] -> t [P,T], BIG_T where invalid (cluster.py:473-519)."""
    tri9 = tri_rows.view(tri_rows.shape[0], 9, T_CLUSTER).transpose(1, 2)
    t, _u, _v, valid, _ = _mt_scalar(
        o[:, 0:1], o[:, 1:2], o[:, 2:3], d[:, 0:1], d[:, 1:2], d[:, 2:3],
        tri9)
    return torch.where(valid, t, BIG_T)


def _trace_pairs(scene: ClusterScene, ray_o, ray_d, t_lim):
    """Phases 1-3 (cluster.py:355-370).  Returns (r2, c2, t [P2,T],
    valid2, tl2 [P2], overflow)."""
    B = ray_o.shape[0]
    r2, c2, valid2, rays12, of = _build_pairs(scene, ray_o, ray_d, t_lim)
    rg2 = rays12[torch.clamp_max(r2, B - 1).long()]               # [P2,12]
    t = _mt_rows_scalar(scene.cl_tris[c2.long()], rg2[:, 0:3], rg2[:, 3:6])
    t = torch.where(valid2[:, None], t, BIG_T)
    return r2, c2, t, valid2, rg2[:, 9], of


def _segment(values, seg, B: int, reduce: str, fill):
    """Per-segment min/max of ``values`` by segment id ``seg`` in [0, B]
    (row B collects the invalid pairs); empty segments keep ``fill``, the
    reduction's identity."""
    out = torch.full((B + 1,), fill, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(0, seg.long(), values, reduce=reduce,
                              include_self=True)[:B]


def _reduce_closest(scene: ClusterScene, B: int, r2, pair_t, pair_cl,
                    valid2):
    """Per-pair (t, packed winner) -> per-ray (t, prim) (cluster.py:
    496-517): the per-ray minimum, then among the pairs at it the LARGEST
    packed (cluster, lane) winner."""
    best_t = torch.clamp_max(_segment(pair_t, r2, B, "amin", float("inf")),
                             BIG_T)
    is_best = (pair_t <= best_t[torch.clamp_max(r2, B - 1).long()]) & valid2
    win = _segment(torch.where(is_best, pair_cl, -1), r2, B, "amax",
                   torch.iinfo(torch.int32).min)
    w = torch.clamp_min(win, 0).long()
    best_prim = scene.cl_tri_idx[w // T_CLUSTER, w % T_CLUSTER]
    best_prim = torch.where((best_t < BIG_T) & (win >= 0), best_prim, -1)
    return best_t, best_prim


@torch.no_grad()
def closest_hit(scene: ClusterScene, ray_o, ray_d):
    """Closest hit of rays [B,3] -> (t [B], prim [B] (-1 miss), overflow)
    (cluster.py:922-938)."""
    B = ray_o.shape[0]
    t_lim = torch.full((B,), BIG_T, dtype=ray_o.dtype, device=ray_o.device)
    r2, c2, t, valid2, _tl2, overflow = _trace_pairs(scene, ray_o, ray_d,
                                                     t_lim)
    pair_t = t.amin(dim=1)
    lane = torch.argmin(t, dim=1).to(torch.int32)
    best_t, best_prim = _reduce_closest(scene, B, r2, pair_t,
                                        c2 * T_CLUSTER + lane, valid2)
    return best_t, best_prim, overflow


@torch.no_grad()
def any_hit(scene: ClusterScene, ray_o, ray_d, t_max):
    """Occlusion: True where a triangle lies at t < t_max - SHADOW_EPS.
    Returns (blocked [B] bool, overflow: a pair budget was exceeded and
    hits may have been dropped) (cluster.py:941-957)."""
    B = ray_o.shape[0]
    r2, _c2, t, valid2, tl2, overflow = _trace_pairs(
        scene, ray_o, ray_d, t_max - SHADOW_EPS)
    pair_hit = (t < tl2[:, None]).any(dim=1) & valid2
    hits = _segment(pair_hit.to(torch.int32), r2, B, "amax", 0)
    return hits > 0, overflow


def intersect_clusters(scene: ClusterScene, tris, ray_o, ray_d,
                       of: list | None = None) -> Hit:
    """Closest hit with a differentiable hit record: the traversal records
    no graph, ``finalize_hit`` re-intersects the winner (cluster.py:
    960-976).  ``of``: optional list the overflow flag is appended to."""
    _t, prim, overflow = closest_hit(scene, ray_o.detach(), ray_d.detach())
    if of is not None:
        of.append(overflow)
    return finalize_hit(ray_o, ray_d, tris, prim)
