#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. Device: the card's name and power limit (nvidia-smi), then the build
     of every kernel of the path from the checkout's sources (nvcc for
     csrc/listtrace.cu, g++ for the native SAH builder).
  2. Kernels vs their plain torch versions on the card, on inputs captured
     from the main path itself: the 32768-ray primary launch and the fused
     ~98k-ray 3-query launch of the first bounce (block-shared kernel), and
     the escalation launches (per-ray kernel).  at/ar must be bit-identical,
     and so must _run's (t, packed, resolved, overflow).  Then certified
     closest hits are held against the brute-force triangle oracle on a
     small ray subset.
  3. The main path: render() of the 200k-triangle dragon + HDR sky at
     512x512, 1 spp, 8 bounces, list tracer, shared estimator, 32768-ray
     tiles — warm, with the kernels' launch counters reset just before.
  4. One 32768-ray tile at 8 bounces with the kernels and with the plain
     versions: the radiance must be bit-identical.

The second-to-last lines are the card line and one JSON object describing
each kernel; the last line is {"ok": true, "device": {...}}.  Without CUDA,
or without the rest of the repository beside it, the script exits 2 and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 0
N_TRIS = 200_000
W = H = 512
BOUNCES = 8
TILE = 32768


def log(msg: str):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls after one
    warm-up call, by CUDA events."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class Capture:
    """Records the inputs of the list tracer's launches and passes while
    a render runs (module-level functions are looked up at call time)."""

    def __init__(self, lt):
        self.lt = lt
        self.tiles = {"block_tiles": [], "list_tiles": []}
        self.runs = []
        self._orig = {}

    def __enter__(self):
        for name in ("block_tiles", "list_tiles", "_run"):
            self._orig[name] = getattr(self.lt, name)

        def tiles_hook(name):
            def hook(cand, rays, tris, impl=None):
                self.tiles[name].append((cand.clone(), rays.clone()))
                return self._orig[name](cand, rays, tris, impl=impl)
            return hook

        def run_hook(scene, o, d, tl, maxc, any_hit, **kw):
            self.runs.append((o.clone(), d.clone(), tl.clone(), maxc,
                              any_hit if isinstance(any_hit, bool)
                              else any_hit.clone(), kw))
            return self._orig["_run"](scene, o, d, tl, maxc, any_hit, **kw)

        self.lt.block_tiles = tiles_hook("block_tiles")
        self.lt.list_tiles = tiles_hook("list_tiles")
        self.lt._run = run_hook
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.lt, name, fn)


def main() -> int:
    sys.path.insert(0, HERE)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    try:
        from sycl_ray_tracing_tpu_torch import native
        from sycl_ray_tracing_tpu_torch.models import pathtracer as pt
        from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
        from sycl_ray_tracing_tpu_torch.ops import rng
        from sycl_ray_tracing_tpu_torch.ops.intersect import (
            intersect_triangles,
        )
        from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as lt
        from sycl_ray_tracing_tpu_torch.ops.tonemap import tonemap
        from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
        from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_scene
    except ImportError as e:
        print(f"chip_smoke: the port package is missing beside this script "
              f"({e})", file=sys.stderr)
        return 2
    if "jax" in sys.modules:
        print("chip_smoke: the port imported jax", file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ---- phase 1: build every kernel of the path from the sources ----
    t0 = time.perf_counter()
    lt.load_cuda_library()
    t1 = time.perf_counter()
    native.load()
    t2 = time.perf_counter()
    log(f"phase 1 build: nvcc listtrace.cu {t1 - t0:.1f} s, "
        f"g++ bvh_builder.cpp {t2 - t1:.1f} s")
    for logf in sorted(native.BUILD_DIR.glob("liblisttrace_*.log")):
        for line in logf.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")

    with torch.no_grad():
        t0 = time.perf_counter()
        scene = dragon_scene(N_TRIS, with_sky=True, device=dev)
        torch.cuda.synchronize()
        log(f"scene: {scene.num_triangles} triangles, "
            f"{scene.clusters.num_clusters} clusters, sky "
            f"{tuple(scene.env_map.image.shape)}, built in "
            f"{time.perf_counter() - t0:.1f} s")
        cam = pbrt_dragon_camera(dev)
        key = rng.prng_key(SEED)
        ys, xs = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=dev),
            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
        px0 = xs.reshape(-1)[:TILE]
        py0 = ys.reshape(-1)[:TILE]
        tile_key = rng.fold_in(key, 0)

        # ---- phase 2: kernels vs plain versions at main-path shapes ----
        with Capture(lt) as cap:
            pt.render_rays(scene, cam, px0, py0, W, H, tile_key, 1, 1)
        torch.cuda.synchronize()
        blocks = cap.tiles["block_tiles"]
        lists = cap.tiles["list_tiles"]
        if len(blocks) < 2 or not lists:
            raise RuntimeError(
                f"capture saw {len(blocks)} block and {len(lists)} per-ray "
                "launches; expected the primary and the first bounce's")
        tris = lt._tiles_with_dummy(scene.clusters)
        prim_launch, bounce_launch = blocks[0], max(
            blocks, key=lambda c: c[1].shape[0])
        esc_launch = max(lists, key=lambda c: c[1].shape[0])
        kernels = []
        for name, (cand, rays), fn, plain, replaces in [
            ("block_tiles", bounce_launch, lt.block_tiles,
             lt.block_tiles_plain,
             "sycl_ray_tracing_tpu/ops/pallas/listtrace.py:298"),
            ("list_tiles", esc_launch, lt.list_tiles, lt.list_tiles_plain,
             "sycl_ray_tracing_tpu/ops/pallas/listtrace.py:245"),
        ]:
            checks = [(cand, rays)]
            if name == "block_tiles":
                checks.append(prim_launch)
            err = 0.0
            for c, r in checks:
                at_k, ar_k = fn(c, r, tris)
                at_p, ar_p = plain(c, r, tris)
                torch.cuda.synchronize()
                same = torch.equal(at_k, at_p) and torch.equal(ar_k, ar_p)
                diff = (at_k - at_p).abs()
                err = max(err, float(diff[torch.isfinite(diff)].max())
                          if diff.numel() else 0.0)
                log(f"phase 2 {name}: rays {r.shape[0]}, maxc "
                    f"{c.shape[1]}, bit-identical={same}")
                if not same:
                    raise RuntimeError(f"{name} disagrees with its plain "
                                       f"version (max |dt| {err})")
            ms = cuda_ms(lambda: fn(cand, rays, tris), 20)
            plain_ms = cuda_ms(lambda: plain(cand, rays, tris), 3)
            log(f"phase 2 {name}: {ms:.4f} ms kernel vs {plain_ms:.4f} ms "
                f"plain per launch at {rays.shape[0]} rays ({card})")
            kernels.append(dict(
                name=name, route="cuda",
                source="sycl_ray_tracing_tpu_torch/csrc/listtrace.cu",
                replaces=replaces, launches=0, max_abs_err=err,
                ms=ms, plain_ms=plain_ms,
            ))

        # _run's (t, packed, resolved, overflow): kernels == plain versions
        for label, run in (("primary", cap.runs[0]),
                           ("bounce 1 fused", cap.runs[1])):
            o, d, tl, maxc, ah, kw = run
            outs = [lt._run(scene.clusters, o, d, tl, maxc, ah,
                            **dict(kw, impl=impl))
                    for impl in (None, "plain")]
            same = all(torch.equal(a, b) for a, b in zip(*outs))
            log(f"phase 2 _run {label}: rays {o.shape[0]}, "
                f"(t, packed, resolved, overflow) identical={same}, "
                f"overflow={bool(outs[0][3])}")
            if not same:
                raise RuntimeError(f"_run {label} differs between kernels "
                                   "and plain versions")

        # certified closest hits agree with the brute-force oracle
        o, d = cap.runs[0][0][::256], cap.runs[0][1][::256]
        t_l, prim_l, _of, res = lt.closest_hit(scene.clusters, o, d,
                                               with_resolved=True)
        ref = intersect_triangles(o, d, scene.triangles)
        hit_ref = ref.hit & res
        agree = (torch.equal((prim_l >= 0)[res], ref.hit[res])
                 and torch.equal(prim_l[hit_ref], ref.prim[hit_ref].to(
                     prim_l.dtype))
                 and bool(((t_l - ref.t).abs()[hit_ref] <= 1e-5).all()))
        log(f"phase 2 oracle: {o.shape[0]} primary rays, {int(res.sum())} "
            f"certified, {int(ref.hit.sum())} hits, agree={agree}")
        if not agree:
            raise RuntimeError("list tracer disagrees with the brute oracle")

        # ---- phase 3: the main path, warm ----
        cfg = RenderConfig(W, H, samples=1, bounces=BOUNCES, intersect="list",
                           estimator="shared", tile_rays=TILE)
        t0 = time.perf_counter()
        pt.render(scene, cam, cfg, key, with_aux=True)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        lt.reset_launch_counts()
        t0 = time.perf_counter()
        img, aux = pt.render(scene, cam, cfg, key, with_aux=True)
        torch.cuda.synchronize()
        frame = time.perf_counter() - t0
        launches = dict(lt.LAUNCHES)
        for k in kernels:
            k["launches"] = launches[k["name"]]
        mean = float(img.mean())
        finite = bool(torch.isfinite(img).all())
        tm = tonemap(img)
        mrays = W * H * 1 * BOUNCES / frame / 1e6
        log(f"phase 3 frame: {tuple(img.shape)} finite={finite} mean={mean:.6f} "
            f"tonemapped mean={float(tm.mean()):.6f} "
            f"overflow={aux['overflow']} launches={launches}")
        log(f"phase 3 frame time {frame * 1e3:.1f} ms warm ({cold * 1e3:.1f} "
            f"ms first), {mrays:.3f} Mrays/s ({W}x{H}x1spp x{BOUNCES} bounces "
            f"/ frame time), card {card}")
        if not finite or mean <= 1e-4 or aux["overflow"] \
                or tuple(img.shape) != (H, W, 3):
            raise RuntimeError("main-path frame failed its checks")
        if min(launches.values()) < 1:
            raise RuntimeError(f"a kernel of the path never launched: "
                               f"{launches}")

        # ---- phase 4: one 8-bounce tile, kernels vs plain versions ----
        rad_k, aux_k = pt.render_rays(scene, cam, px0, py0, W, H, tile_key,
                                      1, BOUNCES, with_aux=True)
        rad_p, aux_p = pt.render_rays(scene, cam, px0, py0, W, H, tile_key,
                                      1, BOUNCES, with_aux=True, impl="plain")
        torch.cuda.synchronize()
        same = torch.equal(rad_k, rad_p)
        log(f"phase 4 tile: {rad_k.shape[0]} rays x {BOUNCES} bounces, "
            f"radiance bit-identical={same}, overflow "
            f"{bool(aux_k['overflow'])}/{bool(aux_p['overflow'])}, "
            f"mean {float(rad_k.mean()):.6f}")
        if not same:
            raise RuntimeError("tile radiance differs between kernels and "
                               "plain versions")

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
