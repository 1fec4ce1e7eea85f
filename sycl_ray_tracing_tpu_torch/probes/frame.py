"""Where a frame's device time goes: one warm flagship frame (the 200k
dragon stand-in + HDR sky, 512x512, 1 spp, 8 bounces, list tracer, shared
estimator, 32768-ray tiles) under torch.profiler with CUDA activity.
Prints, per list kernel, its launches and device time (the profiler's
kernel intervals, which hold no host launch path), then the frame's
device time over all CUDA activity against its wall time.

    python -m sycl_ray_tracing_tpu_torch.probes.frame
"""

from __future__ import annotations

import time

import torch

KERNELS = ("block_tiles_kernel", "list_tiles_kernel")
SEED = 0
N_TRIS = 200_000
W = H = 512
BOUNCES = 8
TILE = 32768


def profile(fn, kernels=KERNELS) -> dict:
    """Run ``fn`` once under torch.profiler (CPU + CUDA activity) and
    return {"kernels": {name: (launches, device ms, longest launch's
    device ms)} for each name in ``kernels`` (a kernel counts where its
    name holds it), "device_ms": all CUDA activity, "wall_ms": host clock
    around fn and the synchronise}.  Device times are 0 where the
    profiler saw no CUDA activity."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    found = {k: (0, 0.0, 0.0) for k in kernels}
    device_us = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        device_us += us
        for k in kernels:
            if k in e.name:
                n, ms, top = found[k]
                found[k] = (n + 1, ms + us / 1e3, max(top, us / 1e3))
    return dict(kernels=found, device_ms=device_us / 1e3,
                wall_ms=wall * 1e3)


def kernel_ms(fn, kernel: str, reps: int = 20) -> float:
    """Device ms per launch of the kernels whose name holds ``kernel``
    over ``reps`` back-to-back calls of ``fn`` (after one warm-up call),
    by the profiler: the kernel's own time, without the host's launch
    path that CUDA events around the calls also hold."""
    fn()

    def calls():
        for _ in range(reps):
            fn()

    n, ms, _top = profile(calls, (kernel,))["kernels"][kernel]
    return ms / n if n else 0.0


def report(prof: dict, label: str, card: str) -> list[str]:
    lines = [f"{label} {k}: {n} launches, {ms:.4f} ms device time, the "
             f"longest launch {top:.4f} ms (profiler) ({card})"
             for k, (n, ms, top) in prof["kernels"].items()]
    busy = prof["device_ms"] / prof["wall_ms"] if prof["wall_ms"] else 0.0
    lines.append(f"{label} frame: {prof['device_ms']:.1f} ms device time "
                 f"over all CUDA activity in {prof['wall_ms']:.1f} ms wall "
                 f"(device busy {busy:.1%}) ({card})")
    return lines


def main() -> int:
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
        scene = dragon_scene(N_TRIS, with_sky=True, device=dev)
        cam = pbrt_dragon_camera(dev)
        cfg = RenderConfig(W, H, samples=1, bounces=BOUNCES,
                           intersect="list", estimator="shared",
                           tile_rays=TILE)
        key = rng.prng_key(SEED)
        pt.render(scene, cam, cfg, key)                   # warm
        prof = profile(lambda: pt.render(scene, cam, cfg, key))
    for line in report(prof, "profiled", card):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
