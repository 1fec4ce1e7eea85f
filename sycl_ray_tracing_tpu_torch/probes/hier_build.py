"""The fused supercluster candidate build (csrc/hier_build.cu) against its
plain torch version, ``_hier_rows``, on the card:

    python -m sycl_ray_tracing_tpu_torch.probes hier_build

Two workloads: the hierarchical test mesh (30k triangles, 4
superclusters) under rays made to reach every rule of the build (dead
rays and a dead block, non-finite origins and directions, supercluster
overflow, short, full and poisoned rows, dropped columns), in one case a
rule; and the 870k stand-in's builds of one 32768-ray tile at one
bounce (the primary rays' and the bounce's fused closest-hit + light +
sky shadow query, at the main pass's shapes: maxc 128, maxs 42, 32 rays
a block).  Each case's (cand, ctn,
overflow, covered) must equal the plain version's bit for bit; the
largest 870k build prints the kernel's time (CUDA events a call, the profiler's
device time a launch) beside its bound and the plain version's time.
The card tests of ``tests/test_torch_cand_build.py`` run the same
holds.
"""

from __future__ import annotations

import numpy as np
import torch

from sycl_ray_tracing_tpu_torch.ops import cluster as pc
from sycl_ray_tracing_tpu_torch.ops.intersect import BIG_T

KERNEL = "hier_build_kernel"
MESH_TRIS = 30_000
BIG_TRIS = 870_000
W = H = 512
TILE = 32768
# (label, maxs, maxc, group, exact, ray_cert) on the test mesh
CASES = (
    ("sc-overflow", 2, 48, 32, True, True),
    ("fits", 4, 128, 32, True, True),
    ("full", 4, 16, 32, True, True),
    ("no-cert", 4, 48, 32, True, False),
    ("inexact", 4, 16, 8, False, False),
    ("defaults", 12, 16, 8, True, True),
    ("sc-overflow-8", 2, 8, 8, True, True),
)
OUTPUTS = ("cand", "ctn", "overflow", "covered")


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def mesh_rays(n: int = 1024, seed: int = 7):
    """Rays for the test mesh, 32-ray blocks of: a tight bundle (a block
    within few superclusters), random rays (blocks over many), rays from
    near the surface, a block of dead rays (t_lim -BIG_T) and, in the last
    block, rays whose origin or direction is not finite or is tiny, and
    signed zeros in a direction."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = _unit(rng.normal(size=(n, 3))).astype(np.float32)
    q = n // 4
    o[:q] = np.array([0.0, 0.2, 3.0], np.float32)
    d[:q] = _unit(np.stack([np.linspace(-0.02, 0.02, q),
                            np.linspace(-0.01, 0.01, q),
                            np.full(q, -1.0)], axis=1))
    o[2 * q:3 * q] = rng.uniform(-1.0, 1.0, (q, 3))
    tl = np.full(n, BIG_T, np.float32)
    tl[q:2 * q:5] = 1.5
    tl[q:3 * q:7] = -BIG_T
    tl[2 * q:2 * q + 32] = -BIG_T                 # a dead block
    s = n - 32                                    # the last block
    d[s + 0] = [np.nan, 0.0, -1.0]
    d[s + 1] = [np.inf, 0.0, -1.0]
    o[s + 2] = [np.nan, 0.0, 0.0]
    o[s + 3] = [-3.3e38, 0.2, 0.1]                # plane - o overflows
    d[s + 3] = [1.0, 0.0, 0.0]
    o[s + 4] = [-3.3e38, 0.2, 0.1]
    d[s + 4] = [np.inf, 0.0, 0.0]                 # inf * 0: a NaN product
    d[s + 5] = [0.0, -0.0, -1.0]
    d[s + 6] = [1e-35, -1e-35, -1.0]
    o[s + 7] = [np.inf, 0.0, 0.0]
    tl[s + 8] = np.nan
    return o, d, tl


def mesh_cases(device):
    """[(label, args, kwargs)] of candidate_clusters_hier calls on the
    test mesh, one a CASES entry."""
    from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_standin

    scene = pc.build_clusters(dragon_standin(MESH_TRIS), device=device)
    o, d, tl = (torch.tensor(a, device=device) for a in mesh_rays())
    return [(label, (scene, o, d, tl, maxc, maxs, group),
             dict(grouped=True, exact=exact, ray_cert=cert))
            for label, maxs, maxc, group, exact, cert in CASES]


def bounce_builds(device, n_tris: int = BIG_TRIS):
    """The 870k stand-in (dragon_scene) and the candidate_clusters_hier
    calls of one 32768-ray tile at one bounce: [(args, kwargs)] as the
    list tracer made them, largest first."""
    from sycl_ray_tracing_tpu_torch.models import pathtracer as pt
    from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
    from sycl_ray_tracing_tpu_torch.ops import rng
    from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as lt
    from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_scene

    scene = dragon_scene(n_tris, with_sky=True, device=device)
    pix = torch.arange(TILE, device=device)
    px, py = (pix % W).float(), (pix // W).float()
    made = []
    orig = lt.candidate_clusters_hier

    def record(*args, **kw):
        made.append((tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args), dict(kw)))
        return orig(*args, **kw)

    lt.candidate_clusters_hier = record
    try:
        with torch.no_grad():
            pt.render_rays(scene, pbrt_dragon_camera(device), px, py, W, H,
                           rng.fold_in(rng.prng_key(0), 0), 1, 1,
                           estimator="shared")
    finally:
        lt.candidate_clusters_hier = orig
    if not made:
        raise RuntimeError(f"the {n_tris}-triangle tile made no supercluster "
                           "build")
    return scene, sorted(made, key=lambda m: -m[0][1].shape[0])


def same_bits(a, b) -> bool:
    """Equal shape, dtype and bits (floats compared as their int32 bits:
    -0.0 and NaN payloads count)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def hold(args, kw) -> tuple[tuple, list]:
    """Run the build through the kernel and through the plain version;
    returns (the plain outputs, the names of the outputs that differ)."""
    out_k = pc.candidate_clusters_hier(*args, **kw)
    out_p = pc.candidate_clusters_hier(*args, **dict(kw, impl="plain"))
    bad = [name for name, a, b in zip(OUTPUTS, out_k, out_p)
           if not same_bits(a, b)]
    if len(out_k) != len(out_p):
        bad.append("arity")
    return out_p, bad


def rules(out, group: int) -> dict:
    """What a case's plain outputs show of the rules it is there for."""
    cand, ctn, ovf = out[:3]
    last_c, last_t = cand[:, -1], ctn[:, -1]
    full = last_c >= 0
    seen = {"overflow": bool(ovf),
            "poisoned_rows": int((last_t == -BIG_T).sum()),
            "short_rows": int((last_c < 0).sum()),
            "full_rows": int(full.sum()),
            "empty_rows": int((cand < 0).all(dim=1).sum())}
    if len(out) > 3:
        cov = out[3].view(-1, group)
        ok = full & (last_t >= 0)
        seen["dropped_rays_in_full_rows"] = int((~cov[ok]).sum())
        seen["covered_rays"] = int(out[3].sum())
    return seen


def work(args, kw):
    """(operations, bytes) of one build (probes/bounds.hier_build_work)."""
    from sycl_ray_tracing_tpu_torch.probes.bounds import hier_build_work

    scene, o, d, tl, maxc, maxs, group = args
    return hier_build_work(scene, o, d, tl, maxc, maxs, group,
                           kw.get("ray_cert", False))


def run(device, reps: int = 20, log=print) -> dict:
    """Every hold, then the 870k build's times; raises on a difference.
    Returns the 870k build's numbers."""
    from sycl_ray_tracing_tpu_torch.probes import frame
    from sycl_ray_tracing_tpu_torch.probes.bounds import bound
    from sycl_ray_tracing_tpu_torch.probes.common import card_line, cuda_ms

    card = card_line()
    info = pc.hier_build_info(42)
    log(f"hier_build kernel: {info['registers']} registers, "
        f"{info['local_bytes']} spill bytes, {info['threads']} threads, "
        f"{info['shared_bytes']} shared bytes at maxs 42, "
        f"{info['blocks_per_sm']} blocks per SM")
    if info["local_bytes"]:
        raise RuntimeError("hier_build_kernel spills")
    bad = []
    for label, args, kw in mesh_cases(device):
        out_p, diff = hold(args, kw)
        log(f"hier_build mesh {label} (maxs {args[5]}, maxc {args[4]}, "
            f"group {args[6]}, exact {kw['exact']}, ray_cert "
            f"{kw['ray_cert']}): bit-identical={not diff} {diff or ''}; "
            f"{rules(out_p, args[6])}")
        bad += [f"{label}: {x}" for x in diff]
    scene, made = bounce_builds(device)
    cs = scene.clusters
    log(f"hier_build 870k: {cs.num_clusters} clusters, "
        f"{cs.num_superclusters} superclusters; the tile at one bounce "
        f"made {len(made)} supercluster builds, of "
        f"{[m[0][1].shape[0] for m in made]} rays")
    for i, (args, kw) in enumerate(made):
        out_p, diff = hold(args, kw)
        log(f"hier_build 870k build {i}: {args[1].shape[0]} rays, "
            f"maxs {args[5]}, maxc {args[4]}, group {args[6]}: "
            f"bit-identical={not diff} {diff or ''}; "
            f"{rules(out_p, args[6])}")
        bad += [f"870k build {i}: {x}" for x in diff]
    if bad:
        raise RuntimeError("the fused build differs from its plain "
                           f"version: {bad}")
    args, kw = made[0]

    def fused():
        pc.candidate_clusters_hier(*args, **kw)

    def plain():
        pc.candidate_clusters_hier(*args, **dict(kw, impl="plain"))

    ms = cuda_ms(fused, reps)
    dev_ms = frame.kernel_ms(fused, KERNEL, reps)
    plain_ms = cuda_ms(plain, max(1, reps // 4))
    ops_bytes = work(args, kw)
    bound_ms, by = bound(*ops_bytes)
    log(f"hier_build 870k largest build ({args[1].shape[0]} rays, "
        f"{args[1].shape[0] // args[6]} blocks): {ms:.4f} ms a call by "
        f"events, {dev_ms:.4f} ms device a launch (profiler), plain "
        f"version {plain_ms:.4f} ms; bound {bound_ms:.4f} ms by {by} "
        f"({card})")
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, work=ops_bytes, rays=args[1].shape[0],
                info=info)
