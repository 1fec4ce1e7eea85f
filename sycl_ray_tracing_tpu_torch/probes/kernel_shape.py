"""Kernel-shape sweep on the card (counterpart of
scratch/kernel_shape_bench.py): the per-ray list kernel (with its tail
guard) at 1 / 8 / 16 / 32 rays per CUDA block (the TPU kernel's RB) x
maxc 16 / 32, the unguarded per-ray walk with the lane min inside (one t
per ray out; the "union" lines, kernel_shape_bench.py's "inkred") at
maxc 32 and 48, and the block-shared kernel at maxc 48 / 96 on grouped
lists; all on one all-live surface wavefront of 98,304 sorted rays over
the 200k-triangle dragon stand-in.  Reports ms and ns per ray.  The
union lines also give the tiles the walk stages a call against those a
per-ray walk reads (one a live ray-round) and their ratio, the sharing
factor, at pk.LIST_MIN_RAYS rays a block.

    python -m sycl_ray_tracing_tpu_torch.probes kernel_shape
"""

from __future__ import annotations

import torch

from sycl_ray_tracing_tpu_torch.ops.cluster import (
    candidate_clusters,
    candidate_clusters_grouped,
)
from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as lt
from sycl_ray_tracing_tpu_torch.ops.kernels import probes as pk
from sycl_ray_tracing_tpu_torch.probes import bounds
from sycl_ray_tracing_tpu_torch.probes.common import (
    bound_note,
    cuda_ms,
    dummy_lists,
    live_rounds_mean,
    pack_rays,
    plain_line,
    surface_wavefront,
)

B = 3 * 32768
LIST_MAXC = 48
SHARE_MAXC = 96


def workload(scene) -> dict:
    """The sorted wavefront, its per-ray lists (maxc 48) and its block
    lists (maxc 96, 32 rays a block), as kernel_shape_bench.py:46-75."""
    cs = scene.clusters
    o, d, tl = surface_wavefront(scene.triangles.cpu().numpy(), B,
                                 scene.device)
    perm = torch.argsort(lt._ray_sort_key(cs, o, d), stable=True)
    o, d = o[perm], d[perm]
    cand, ctn, _of = candidate_clusters(cs, o, d, tl, LIST_MAXC, exact=True)
    candg, ctng, _of = candidate_clusters_grouped(
        cs, o, d, tl, SHARE_MAXC, lt.RB_SHARE, exact=True)
    return dict(k2=cs.num_clusters, rays=pack_rays(o, d, tl), cand=cand,
                ctn=ctn, candg=candg, ctng=ctng,
                tris=lt._tiles_with_dummy(cs))


def per_ray_lists(work: dict, maxc: int):
    """The per-ray lists cut at ``maxc`` and their entry-t: (cand, ctn)."""
    return (dummy_lists(work["cand"][:, :maxc], work["k2"]),
            work["ctn"][:, :maxc].contiguous())


def block_lists(work: dict, maxc: int):
    """The block lists cut at ``maxc`` and their entry-t: (cand, ctn)."""
    return (dummy_lists(work["candg"][:, :maxc], work["k2"]),
            work["ctng"][:, :maxc].contiguous())


def sharing_note(cand, k2: int, rays_per_block: int) -> str:
    """The tile bytes a union walk of ``rays_per_block`` rays a block
    stages a call, those a per-ray walk reads, and their ratio; and the
    blocks' imbalance: the sum over blocks of their longest list over
    the mean list times blocks (a block lasts as long as its longest)."""
    live, union = bounds.union_tiles(cand, k2, rays_per_block)
    n = (cand != k2).sum(dim=1)
    n = torch.cat([n, n.new_zeros(-n.shape[0] % rays_per_block)])
    longest = int(n.view(-1, rays_per_block).amax(dim=1).sum())
    return (f"tiles staged {union * bounds.TILE_BYTES / 1e9:.4f} GB "
            f"({union} tiles) vs {live * bounds.TILE_BYTES / 1e9:.4f} GB "
            f"per ray-round ({live}), sharing factor "
            f"{live / max(union, 1):.2f}, imbalance "
            f"{longest * rays_per_block / max(live, 1):.3f}")


def run(scene, reps: int = 5, work: dict | None = None):
    work = work or workload(scene)
    rays, tris, k2 = work["rays"], work["tris"], work["k2"]
    for maxc in (16, 32):
        cnd, ctn = per_ray_lists(work, maxc)
        stop = lt.list_tiles(cnd, ctn, rays, tris)[2]
        print(f"per-ray maxc={maxc:2d}: {live_rounds_mean(cnd, k2):.2f} live "
              f"rounds per ray, the guard runs "
              f"{bounds.rounds_run(cnd, tris, stop)} of "
              f"{bounds.rounds_run(cnd, tris)}", flush=True)
        work_run = bounds.list_tiles_work(cnd, rays, tris, stop)
        for rb in lt.LIST_RAYS_PER_BLOCK:
            ms = cuda_ms(lambda: lt.list_tiles(cnd, ctn, rays, tris,
                                               rays_per_block=rb), reps)
            print(f"per-ray rb={rb:2d} maxc={maxc:2d}: {ms:8.4f} ms "
                  f"({ms * 1e6 / B:7.2f} ns/ray), {bound_note(work_run)}",
                  flush=True)
    cnd, ctn = per_ray_lists(work, 32)
    plain_line("per-ray maxc=32", lambda: lt.list_tiles_plain(cnd, ctn, rays,
                                                              tris))
    for maxc in (32, LIST_MAXC):
        cnd, _ctn = per_ray_lists(work, maxc)
        ms = cuda_ms(lambda: pk.list_tiles_min(cnd, rays, tris), reps)
        print(f"per-ray rb={pk.LIST_MIN_RAYS:2d} maxc={maxc:2d} union: "
              f"{ms:8.4f} ms ({ms * 1e6 / B:7.2f} ns/ray), "
              f"{sharing_note(cnd, k2, pk.LIST_MIN_RAYS)}, "
              f"{bound_note(bounds.list_tiles_min_work(cnd, rays, tris))}",
              flush=True)
    for maxc in (48, 96):
        cnd, ctn = block_lists(work, maxc)
        ms = cuda_ms(lambda: lt.block_tiles(cnd, ctn, rays, tris), reps)
        stop = lt.block_tiles(cnd, ctn, rays, tris)[2]
        print(f"share   rb=32 maxc={maxc:2d}: {ms:8.4f} ms "
              f"({ms * 1e6 / B:7.2f} ns/ray, "
              f"{live_rounds_mean(cnd, k2):.2f} live rounds per block, "
              f"{bounds.rounds_run(cnd, tris, stop)} of "
              f"{bounds.rounds_run(cnd, tris)} run), "
              f"{bound_note(bounds.block_tiles_work(cnd, rays, tris, stop))}",
              flush=True)
    plain_line("share rb=32 maxc=96", lambda: lt.block_tiles_plain(
        cnd, ctn, rays, tris))

