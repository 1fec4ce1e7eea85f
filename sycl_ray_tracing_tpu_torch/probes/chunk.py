"""Count-list sweep on the card (counterpart of scratch/chunk_bench_r4.py):
the block-shared kernel over all 3,072 blocks of 98,304 unsorted surface
rays on the SAH-clustered 200k-triangle stand-in, at maxc 96, on the real
union lists and on synthetic lists that are all full, half full and a
quarter full.  The TPU script measured its count-chunk gates; the port's
kernel skips every dummy round, so the sweep gives its cost per live
round and its fixed cost per block.  The real lists carry their build's
entry-t, so the tail guard runs as on the main path; the synthetic ones
carry an entry-t of 0, on which it never fires.

    python -m sycl_ray_tracing_tpu_torch.probes chunk
"""

from __future__ import annotations

import numpy as np
import torch

from sycl_ray_tracing_tpu_torch.ops.cluster import (
    build_clusters,
    candidate_clusters_grouped,
)
from sycl_ray_tracing_tpu_torch.ops.intersect import BIG_T
from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as lt
from sycl_ray_tracing_tpu_torch.probes import bounds
from sycl_ray_tracing_tpu_torch.probes.common import (
    SEED,
    bound_note,
    cuda_ms,
    dummy_lists,
    pack_rays,
    plain_line,
)
from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_standin

B = 98304
N_TRIS = 200_000
MAXC = 96


def workload(device, n_tris: int = N_TRIS, n_rays: int = B) -> dict:
    """Clusters, rays and union lists as chunk_bench_r4.py:34-53, and the
    synthetic lists of :128-139 (-1 marks an empty slot); each list set
    with its entry-t."""
    tris_np = dragon_standin(n_tris)
    cs = build_clusters(tris_np, order="sah", device=device)
    rng = np.random.default_rng(SEED)
    idx = rng.integers(0, tris_np.shape[0], n_rays)
    o = tris_np[idx].mean(axis=1) + rng.normal(
        0, .01, (n_rays, 3)).astype(np.float32)
    dn = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d = dn / np.linalg.norm(dn, axis=-1, keepdims=True)
    o, d = (torch.as_tensor(x, device=device) for x in (o, d))
    tl = torch.full((n_rays,), BIG_T, dtype=torch.float32, device=device)
    cand, ctn, _of = candidate_clusters_grouped(cs, o, d, tl, MAXC,
                                                lt.RB_SHARE, exact=True)
    g, k2 = cand.shape[0], cs.num_clusters
    lists = {"real union lists": (cand, ctn)}
    cycle = torch.arange(MAXC, dtype=torch.int32, device=device) % k2
    zero_t = torch.zeros((g, MAXC), dtype=torch.float32, device=device)
    lists["synthetic all-full (96 rounds)"] = (cycle.repeat(g, 1), zero_t)
    for frac in (0.5, 0.25):
        n = int(MAXC * frac)
        c = torch.full((g, MAXC), -1, dtype=torch.int32, device=device)
        c[:, :n] = cycle[:n]
        lists[f"synthetic count={n}"] = (c, zero_t)
    return dict(k2=k2, rays=pack_rays(o, d, tl), lists=lists,
                tris=lt._tiles_with_dummy(cs))


def run(device, reps: int = 5, work: dict | None = None):
    work = work or workload(device)
    rays, tris, k2 = work["rays"], work["tris"], work["k2"]
    first = next(iter(work["lists"]))
    print(f"blocks={work['lists'][first][0].shape[0]} maxc={MAXC}",
          flush=True)
    for label, (cand, ctn) in work["lists"].items():
        g = cand.shape[0]
        cnt = float((cand >= 0).sum(dim=1).float().mean())
        cnd = dummy_lists(cand, k2)
        ms = cuda_ms(lambda: lt.block_tiles(cnd, ctn, rays, tris), reps)
        stop = lt.block_tiles(cnd, ctn, rays, tris)[2]
        work_run = bounds.block_tiles_work(cnd, rays, tris, stop)
        print(f"{label:32s} {ms:8.4f} ms  ({ms * 1e6 / g:8.1f} ns/block, "
              f"mean count {cnt:.1f}, "
              f"{bounds.rounds_run(cnd, tris, stop)} of "
              f"{bounds.rounds_run(cnd, tris)} live rounds run), "
              f"{bound_note(work_run)}", flush=True)
        if label == first:
            plain_line(label, lambda: lt.block_tiles_plain(cnd, ctn, rays,
                                                           tris))

