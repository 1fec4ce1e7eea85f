"""Where a frame's device time goes: one warm flagship frame (the dragon
stand-in, 200k triangles unless --tris says otherwise, + HDR sky, 512x512,
1 spp, 8 bounces, list tracer, shared estimator, 32768-ray tiles) under
torch.profiler, recording CUDA activity only.  Prints, per list kernel,
its launches and device time (the profiler's kernel intervals, which hold
no host launch path), the ten device ops with the most time in the frame under
their profiler names, the frame's device time over all CUDA activity
against its wall time, and the device time of each candidate build (the
supercluster build, the dense grouped build, the dense per-ray build of
the escalation) over the frame.

    python -m sycl_ray_tracing_tpu_torch.probes.frame [--tris 870000]
"""

from __future__ import annotations

import argparse
import time

import torch

from sycl_ray_tracing_tpu_torch.utils.metrics import device_op_totals

KERNELS = ("block_tiles_kernel", "list_tiles_kernel")
SEED = 0
N_TRIS = 200_000
W = H = 512
BOUNCES = 8
TILE = 32768
TOP_OPS = 10
# the list tracer's candidate builds, by their names in its module
BUILDS = ("candidate_clusters_hier", "candidate_clusters_grouped",
          "candidate_clusters")


def profile(fn, kernels=KERNELS, warmup: bool = False) -> dict:
    """Run ``fn`` once under torch.profiler (CUDA activity) and
    return {"kernels": {name: (launches, device ms, longest launch's
    device ms)} for each name in ``kernels`` (a kernel counts where its
    name holds it), "top": [(device ms, launches, name)] of the TOP_OPS
    device ops with the most time, "device_ms": all CUDA activity,
    "wall_ms": host clock around fn and the synchronise}.  Device times
    are 0 where the profiler saw no CUDA activity.  With ``warmup``, fn
    runs once more before, in the profiler's warm-up cycle, whose trace is
    dropped."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    from torch.profiler import schedule

    torch.cuda.synchronize()
    # CUDA activity only, read from the raw records: on an 870k frame
    # (H100, torch 2.11) recording the host's ops too slowed the frame by
    # a third, and building the profiler's event tree took ~50 s with
    # them and ~28 s without
    cycle = schedule(wait=0, warmup=1, active=1, repeat=1) if warmup \
        else None
    with torch_profile(activities=[ProfilerActivity.CUDA],
                       schedule=cycle) as prof:
        if warmup:
            fn()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if warmup:
            prof.step()
    found = {k: (0, 0.0, 0.0) for k in kernels}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.duration_ns() / 1e6
        for k in kernels:
            if k in e.name():
                n, tot, top = found[k]
                found[k] = (n + 1, tot + ms, max(top, ms))
    by_name = device_op_totals(prof)
    device_us = sum(us for _n, us in by_name.values())
    top = sorted(((us / 1e3, n, name) for name, (n, us) in by_name.items()),
                 reverse=True)[:TOP_OPS]
    return dict(kernels=found, top=top, device_ms=device_us / 1e3,
                wall_ms=wall * 1e3)


def kernel_ms(fn, kernel: str, reps: int = 20, tries: int = 3) -> float:
    """Device ms per launch of the kernels whose name holds ``kernel``
    over ``reps`` back-to-back calls of ``fn`` (after one warm-up call),
    by the profiler: the kernel's own time, without the host's launch
    path that CUDA events around the calls also hold.  Each call of
    ``fn`` launches the kernel once.  The profiler has missed launches of
    a short run late in a long process (H100, torch 2.11, one process
    that ran every on-card check: none of 20 empty-kernel launches once,
    19 of 20 in three runs in a row another time), so each run is
    recorded after a warm-up cycle of the profiler, and a run in which it
    did not record all ``reps`` launches with their device time is
    profiled again, up to ``tries`` runs in all; then it raises."""
    fn()

    def calls():
        for _ in range(reps):
            fn()

    seen = []
    for _ in range(tries):
        n, ms, _top = profile(calls, (kernel,),
                              warmup=True)["kernels"][kernel]
        if n == reps and ms > 0:
            return ms / n
        seen.append(n)
    raise RuntimeError(f"the profiler did not record all {reps} launches "
                       f"of {kernel} with their device time in any of "
                       f"{tries} runs (launches seen: {seen})")


def build_ms(render) -> dict:
    """{build: (calls, device ms)} of each candidate build of one
    ``render()``: its calls are recorded during the render, then run again
    back to back under the profiler, so the device time holds no host
    path.  Builds that the render did not call are left out."""
    from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as lt

    orig = {name: getattr(lt, name) for name in BUILDS}
    calls = {name: [] for name in BUILDS}

    def recorder(name):
        def record(*args, **kw):
            calls[name].append((args, kw))
            return orig[name](*args, **kw)
        return record

    for name in BUILDS:
        setattr(lt, name, recorder(name))
    try:
        render()
    finally:
        for name in BUILDS:
            setattr(lt, name, orig[name])
    out = {}
    for name, made in calls.items():
        if made:
            prof = profile(lambda: [orig[name](*a, **kw) for a, kw in made],
                           kernels=())
            out[name] = (len(made), prof["device_ms"])
    return out


def build_report(builds: dict, label: str, card: str) -> list[str]:
    return [f"{label} {name}: {n} calls, {ms:.4f} ms device time over the "
            f"frame (profiler, replayed back to back) ({card})"
            for name, (n, ms) in builds.items()]


def report(prof: dict, label: str, card: str) -> list[str]:
    lines = [f"{label} {k}: {n} launches, {ms:.4f} ms device time, the "
             f"longest launch {top:.4f} ms (profiler) ({card})"
             for k, (n, ms, top) in prof["kernels"].items()]
    for i, (ms, n, name) in enumerate(prof["top"]):
        share = ms / prof["device_ms"] if prof["device_ms"] else 0.0
        lines.append(f"{label} top device op {i + 1}: {ms:.4f} ms "
                     f"({share:.1%} of device time), {n} launches: "
                     f"{name[:160]}")
    busy = prof["device_ms"] / prof["wall_ms"] if prof["wall_ms"] else 0.0
    lines.append(f"{label} frame: {prof['device_ms']:.1f} ms device time "
                 f"over all CUDA activity in {prof['wall_ms']:.1f} ms wall "
                 f"(device busy {busy:.1%}) ({card})")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tris", type=int, default=N_TRIS,
                    help="triangles of the dragon stand-in (default 200000)")
    args = ap.parse_args(argv)
    from sycl_ray_tracing_tpu_torch.models import pathtracer as pt
    from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
    from sycl_ray_tracing_tpu_torch.ops import rng
    from sycl_ray_tracing_tpu_torch.probes.common import (
        card_line,
        require_cuda,
    )
    from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
    from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_scene

    dev = require_cuda()
    card = card_line()
    with torch.no_grad():
        scene = dragon_scene(args.tris, with_sky=True, device=dev)
        cam = pbrt_dragon_camera(dev)
        cfg = RenderConfig(W, H, samples=1, bounces=BOUNCES,
                           intersect="list", estimator="shared",
                           tile_rays=TILE)
        key = rng.prng_key(SEED)
        pt.render(scene, cam, cfg, key)                   # warm
        prof = profile(lambda: pt.render(scene, cam, cfg, key))
        builds = build_ms(lambda: pt.render(scene, cam, cfg, key))
    label = f"profiled {args.tris}-triangle"
    for line in report(prof, label, card) + build_report(builds, label,
                                                         card):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
