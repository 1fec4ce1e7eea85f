"""The least time an H100 could take for each hand-written kernel's work:
bound = max(operations / 67 TFLOP/s FP32, bytes / 3.35 TB/s), the SXM
part's published peaks at its full 700 W.

Operations are counted from this call's inputs, for the work the data
needs: each FP32 multiply, add or subtract, compare and reciprocal counts
one, and only live (non-dummy) rounds count.  67 TFLOP/s counts an FMA as
two operations; the kernels are built with -fmad=false, so each of these
operations takes one issue slot and this mix can reach at most about half
of that peak.  Bytes: each input byte the output depends on read once
(the tiles its lists name, once each; the 7 ray columns the list kernels
use), each output byte written once.
"""

from __future__ import annotations

import torch

from sycl_ray_tracing_tpu_torch.ops.kernels.listtrace import (
    CHUNK,
    GROUP,
    list_counts,
)
from sycl_ray_tracing_tpu_torch.ops.kernels.probes import MOSAIC_FEATURES

FP32_OPS_PER_S = 67e12
BYTES_PER_S = 3.35e12
TILE_BYTES = 9 * 128 * 4
LANES = 128
RAY_COLS_USED = 7  # o, d, t_lim: the list kernels ignore column 7
# _mt8 per (ray, lane, live round): h 9, a 5, the parallel test 1, the
# reciprocal 1, s 3, u 6, q 9, v 6, t 6, the six hit tests and u + v 7;
# plus the update compare
MT8_OPS = 54
EDGE_OPS = 6      # the two edges, once per loaded tile lane
# the probes' synthetic MT per (ray, lane, round): edges 6, h 9, a 5,
# the parallel test 1, the reciprocal 1, u / v / t 18, hit tests and
# u + v 5 (4 without the t > EPS test)
SYNTH_MT_OPS = 45
# a slab test per (ray, box): 6 subtracts, 6 multiplies, 10 min / max,
# 3 compares
SLAB_OPS = 25


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(bound in ms, "operations" or "bytes")."""
    t_ops = ops / FP32_OPS_PER_S * 1e3
    t_bytes = nbytes / BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _rays(rays) -> int:
    return rays.shape[0] * RAY_COLS_USED * rays.element_size()


def _tiles(cand, dummy: int) -> int:
    """Bytes of the distinct real tiles the lists name."""
    ids = torch.unique(cand)
    return int((ids != dummy).sum()) * TILE_BYTES


def _ran(cand, dummy: int, stop=None):
    """[blocks, maxc] bool: the live rounds before each block's stop."""
    ran = cand != dummy
    if stop is not None:
        slot = torch.arange(cand.shape[1], device=cand.device)
        ran = ran & (slot[None, :] < stop[:, None])
    return ran


def rounds_run(cand, tris, stop=None) -> int:
    """Live block-rounds before ``stop`` (all of them without one)."""
    return int(_ran(cand, tris.shape[0] - 1, stop).sum())


def block_tiles_work(cand, rays, tris, stop=None) -> tuple[float, float]:
    """(operations, bytes) of a guarded list walk on these lists (each
    list shared by rays.shape[0] / cand.shape[0] rays: 32 for block_tiles,
    1 for list_tiles): the live rounds before each list's ``stop`` (the
    tail guard's output; without it, every live round, the unguarded
    kernel's work) and the tiles they name.  With a stop, also the
    entry-t the guard reads (one per check: c0 = GROUP + k*CHUNK up to
    the stop and below the list's count) and the stop written."""
    dummy = tris.shape[0] - 1
    ran = _ran(cand, dummy, stop)
    rb = rays.shape[0] // cand.shape[0]
    ops = int(ran.sum()) * LANES * (EDGE_OPS + rb * MT8_OPS)
    out = rays.shape[0] * LANES * 8                   # at f32 + ar i32
    tiles = _tiles(torch.where(ran, cand, dummy), dummy)
    nbytes = _nbytes(cand) + _rays(rays) + tiles + out
    if stop is not None:
        last = torch.minimum(list_counts(cand, dummy) - 1, stop)
        checks = torch.clamp_min(torch.div(last - GROUP, CHUNK,
                                           rounding_mode="floor") + 1, 0)
        nbytes += int(checks.sum()) * 4 + _nbytes(stop)
    return ops, nbytes


def list_tiles_work(cand, rays, tris, stop=None) -> tuple[float, float]:
    """(operations, bytes) of list_tiles (any rays_per_block): the live
    ray-rounds before each ray's ``stop``, plus the entry-t each check
    reads and the stop written (as block_tiles_work, one ray per list);
    without a stop, every live ray-round."""
    return block_tiles_work(cand, rays, tris, stop)


def list_tiles_min_work(cand, rays, tris) -> tuple[float, float]:
    """The unguarded per-ray walk with the lane min inside: every live
    ray-round, one t per ray written."""
    ops, nbytes = list_tiles_work(cand, rays, tris)
    n = rays.shape[0]
    return ops + n * (LANES - 1), nbytes - n * LANES * 8 + n * 4


def union_tiles(cand, dummy: int, rays_per_block: int) -> tuple[int, int]:
    """(live ray-rounds, distinct tiles summed over blocks) of lists taken
    ``rays_per_block`` consecutive rays a block: the tiles a per-ray walk
    reads (one a live round) and those a union walk stages (each distinct
    tile of a block once).  Their ratio is the sharing factor."""
    n, maxc = cand.shape
    pad = -n % rays_per_block
    ids = torch.cat([cand, torch.full((pad, maxc), dummy, dtype=cand.dtype,
                                      device=cand.device)])
    ids = ids.view(-1, rays_per_block * maxc).sort(dim=1).values
    first = torch.ones_like(ids, dtype=torch.bool)
    first[:, 1:] = ids[:, 1:] != ids[:, :-1]
    return int((cand != dummy).sum()), int((first & (ids != dummy)).sum())


def hier_build_work(scene, ray_o, ray_d, t_lim, maxc: int, maxs: int,
                    group: int, ray_cert: bool) -> tuple[float, float]:
    """(operations, bytes) of the fused supercluster build: each ray's
    slab test against every supercluster box, then against the 64 child
    boxes of each supercluster its block keeps (min(hit, maxs) a block;
    the integer key work is not counted).  Bytes: the rays' o, d and
    t_lim, the supercluster boxes, each kept supercluster's child planes
    once, the lists, flags and certificates written."""
    from sycl_ray_tracing_tpu_torch.ops import cluster as pc

    B = ray_o.shape[0]
    nb = B // group
    k1 = scene.num_superclusters
    hit, tnear = pc.dense_box_mask(scene.sc_box, ray_o,
                                   pc.inv_dir(ray_d), t_lim)
    hit_g = hit.view(nb, group, k1).any(dim=1)
    tn_g = torch.where(hit, torch.clamp_min(tnear, 0.0), 3.0e38)
    scand = pc.extract_candidates_min(
        hit_g, tn_g.view(nb, group, k1).amin(dim=1), maxs)[0]
    kept = int((scand >= 0).sum())
    ops = (B * k1 + kept * pc.S_CLUSTER * group) * SLAB_OPS
    n_sc = int(torch.unique(scand[scand >= 0]).numel())
    nbytes = (B * 7 * 4 + k1 * 6 * 4 + n_sc * 6 * pc.S_CLUSTER * 4
              + nb * maxc * 8 + nb + (B if ray_cert else 0))
    return ops, nbytes


def round_probe_work(cand, tris, variant: str) -> tuple[float, float]:
    """The copy variants' output is the sum of plane 0, lane 0 of the
    tiles (dyncopy: those cand names; statcopy: tile 7, cand unread); the
    MT variants work on whole tiles (mtonly on none)."""
    rows, rounds = cand.shape
    out = rows * 4
    if variant in ("dyncopy", "statcopy"):
        ops = rows * rounds                           # one add a round
    else:
        mt = SYNTH_MT_OPS - (variant == "dynmt_noeps")
        ops = rows * rounds * (LANES * mt + LANES)    # + the lane min
    n_tiles = int(torch.unique(cand).numel())
    if variant == "dyncopy":
        nbytes = _nbytes(cand) + n_tiles * 4
    elif variant == "statcopy":
        nbytes = 4
    elif variant == "mtonly":
        nbytes = 0                                    # reads nothing
    else:
        nbytes = _nbytes(cand) + n_tiles * TILE_BYTES
    return ops, nbytes + out


def smoke_gather_work(cid, table, rays) -> tuple[float, float]:
    """The output reads column 0 of rays and the table rows cid names."""
    rows = rays.shape[0]
    ops = rows * (2 * LANES + 1)
    rows_read = int(torch.unique(cid).numel()) * LANES * 4
    return ops, _nbytes(cid) + rows * 4 + rows_read + rows * 4


def smoke_rank_select_work(mask, table) -> tuple[float, float]:
    n = int((mask > 0.5).any(dim=0).sum())
    ops = mask.numel() + LANES + n * LANES           # tests, scan, sums
    return ops, _nbytes(mask) + n * LANES * 4 + LANES * 4


def mosaic_probe_rounds(ns, x, feature: str) -> int:
    """The rounds the feature's loop runs on these inputs: ns[0] with the
    while loop, ending after the first round whose column max is <= -1;
    else 4."""
    f = MOSAIC_FEATURES[feature]
    if not f & 1:
        return 4
    n = int(ns[0])
    for r in range(n):
        col = x[:, r] if f & 2 else x[:, 0] + float(r)
        if float(col.max()) <= -1.0:
            return r + 1
    return n


def mosaic_probe_work(ns, cand, x, feature: str) -> tuple[float, float]:
    """Per round and element: the adds into o (2, or 1 with extract), the
    column's add (without ds), the when test and multiply (with when).
    Bytes: ns, x, the cand columns of the rounds run (with when), o."""
    f = MOSAIC_FEATURES[feature]
    rounds = mosaic_probe_rounds(ns, x, feature)
    per = (1 if f & 4 else 2) + (0 if f & 2 else 1) + (2 if f & 8 else 0)
    cand_read = cand.shape[0] * rounds * 4 if f & 8 else 0
    return (rounds * x.numel() * per,
            _nbytes(ns, x) + cand_read + x.numel() * 4)
