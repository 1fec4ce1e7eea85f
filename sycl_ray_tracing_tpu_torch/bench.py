"""Benchmark of the port on one card (counterpart of the repository's
bench.py):

    python -m sycl_ray_tracing_tpu_torch.bench [--sections 1,2,3,4,5]
        [--repeats 3] [--steady 8] [--cornell data/OBJs/cornell_pbr.obj]
        [--weak-ranks 8] [--history PATH] [--profile] [--small]
        [--device cuda|cpu]

The JAX bench's sections (bench.py:165-316), with its names and rules:

  1. dragon_fwd: the flagship frame, the dragon stand-in (200k triangles)
     with the HDR sky, 512x512, 1 spp, 8 bounces, list tracer, shared
     estimator, 32768-ray tiles, under torch.no_grad(): the least of
     --repeats timed frames after a warm-up, then --steady frames enqueued
     back to back with one synchronise.  It fails if a frame is not
     certified exact (overflow) or its image mean is not above 1e-4.
  2. dragon_fwd_bwd: the same frame, value and gradient of its mean with
     respect to materials.diffuse (a fresh leaf), remat on.  It fails on a
     zero gradient.
  3. dragon870k_fwd: section 1's frame on the 870k-triangle scene (the
     reference's pbrt_dragon size), whose cluster count must fit the list
     kernels' MAX_CLUSTERS.
  4. cornell_fwd: the reference's own default workload, cornell_pbr.obj at
     512x512, 64 spp, 8 bounces, brute force, untiled.  --cornell names the
     OBJ; a relative path not found from the current directory is looked up
     under $SRT_REFERENCE_ROOT (utils/config.find_data).
  5. weak_scaling: the weak-scaling proxy on the CPU: render_sharded of the
     Cornell scene at 32n x 32, 4 spp, 3 bounces, on n = 1 and n =
     --weak-ranks gloo ranks (one single-thread process each, sample axis
     1); the result is n * t1 / tn, under weak_scaling_proxy_cpu<n> (the
     JAX bench's weak_scaling_proxy_cpu8 at the default 8).  It is a CPU
     number, as the JAX bench's is, but not the same measurement: the JAX
     bench runs 8 virtual XLA devices in one process, this one n processes
     and gloo's exchange between them.

Rays are counted as the JAX bench counts them: W*H*spp*bounces (the NEE
queries are not counted).  A timed call's clock stops after
torch.cuda.synchronize() and the result's copy to the host.  Times are
unrounded seconds; Mrays/s and ms are computed from them.

Each section prints one JSON line as soon as it ends: {"section", "ok",
its keys in the JAX bench's names, "times_s" (every timed call),
"launches" (list-kernel launches of the fastest timed call), "scene_s"
(the scene's build), "build_s" (the warm-up call: on the card the first
frame of the process also builds the CUDA kernels), "device", and "error"
where it failed}.  A failed section keeps what it measured before it
failed, and the later sections still run.  The last line has the JAX
bench's shape, {"metric", "value", "unit", "vs_baseline", "extra"}, with
every key of the sections in "extra" and "errors" where a section failed.
"vs_baseline" is null: the JAX bench divides by 50 Mrays/s, BASELINE.md's
target for a TPU v4, and adds a ratio to a TPU v5e ceiling
(docs/ROOFLINE.md); neither is about this card.

It runs on the card unless given --device cpu.  Without a card it exits 3
(the JAX bench's code for an unreachable chip) and prints no result.  The
exit code is 0 only if dragon_fwd_mrays was measured.  Nothing is written
unless --history PATH is given (the JAX bench appends to the committed
bench_history.jsonl).  --small is the tests' size, never a number for the
card.  --profile adds one frame a section under torch.profiler (device
time, its share of that frame's wall time and of the fastest timed
call's, top device ops).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import socket
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Optional

import torch

from sycl_ray_tracing_tpu_torch.models import pathtracer
from sycl_ray_tracing_tpu_torch.models.camera import (
    cornell_box_camera,
    pbrt_dragon_camera,
)
from sycl_ray_tracing_tpu_torch.models.scene import Scene
from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace
from sycl_ray_tracing_tpu_torch.ops.rng import prng_key
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig, find_data
from sycl_ray_tracing_tpu_torch.utils.obj_loader import load_scene
from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_scene

REPO = Path(__file__).resolve().parents[1]
CORNELL_OBJ = "data/OBJs/cornell_pbr.obj"
NO_CARD = 3            # the JAX bench's exit code for an unreachable chip
WEAK_TIMEOUT = 600     # seconds for all ranks of section 5 (bench.py:310)
WEAK_THREADS = 1       # torch threads of each section 5 rank
TOP_OPS = 5            # device ops a profiled section line names


@dataclasses.dataclass(frozen=True)
class Size:
    """The sections' sizes: the dragon frames' (sections 1-3), the
    Cornell frame's (W, H, spp, bounces) and the weak-scaling frame's
    (W per rank, H, spp, bounces)."""

    tris: int
    tris_big: int
    sky_res: tuple
    width: int
    height: int
    bounces: int
    tile: int
    cornell: tuple
    weak: tuple


FULL = Size(200_000, 870_000, (512, 1024), 512, 512, 8, 32768,
            (512, 512, 64, 8), (32, 32, 4, 3))
SMALL = Size(2_000, 6_000, (16, 32), 16, 16, 2, 128, (16, 16, 2, 2),
             (8, 8, 2, 1))


@dataclasses.dataclass
class Run:
    """What the sections share: the flags, the device, the size, the
    200k scene once built, and the JAX keys and errors gathered so far."""

    args: argparse.Namespace
    device: torch.device
    size: Size
    dragon: Optional[Scene] = None
    results: dict = dataclasses.field(default_factory=dict)
    errors: dict = dataclasses.field(default_factory=dict)

    @property
    def rays(self) -> int:
        s = self.size
        return s.width * s.height * s.bounces


def dragon_config(size: Size) -> RenderConfig:
    """Sections 1-3's frame (bench.py:170-172)."""
    return RenderConfig(width=size.width, height=size.height, samples=1,
                        bounces=size.bounces, intersect="list",
                        tile_rays=size.tile, estimator="shared")


def cornell_config(size: Size) -> RenderConfig:
    """Section 4's frame (bench.py:262-264)."""
    w, h, spp, bounces = size.cornell
    return RenderConfig(width=w, height=h, samples=spp, bounces=bounces,
                        intersect="brute", tile_rays=None,
                        estimator="shared")


def frame(scene, camera, config, key):
    """One forward frame: (image, overflow)."""
    with torch.no_grad():
        img, aux = pathtracer.render(scene, camera, config, key,
                                     with_aux=True)
    return img, aux["overflow"]


def value_and_grad(scene, camera, config, key):
    """Section 2's step (bench.py:217-226): the frame's mean and its
    gradient with respect to materials.diffuse, through a fresh leaf."""
    mats = scene.materials
    diffuse = mats.diffuse.detach().clone().requires_grad_()
    s = scene.with_materials(dataclasses.replace(mats, diffuse=diffuse))
    loss = pathtracer.render(s, camera, config, key).mean()
    loss.backward()
    return loss.detach(), diffuse.grad


def _to_host(out, device):
    """Wait for the card, then copy ``out`` (a tensor, or a tuple of
    tensors and host values) to the host."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if isinstance(out, torch.Tensor):
        return out.cpu()
    return tuple(x.cpu() if isinstance(x, torch.Tensor) else x for x in out)


def _check_finite(out):
    tensors = [out] if isinstance(out, torch.Tensor) else out
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_floating_point() \
                and not bool(torch.isfinite(t).all()):
            raise RuntimeError("non-finite bench output")


def _timed(fn: Callable, n: int, device):
    """One warm-up call fn(0), then n timed calls fn(1..n).  Each call's
    clock stops after the card is synchronised and the result is on the
    host.  Returns (the last result, the warm-up's seconds, every timed
    call's seconds, the list-kernel launches of each timed call)."""
    t0 = time.perf_counter()
    out = _to_host(fn(0), device)
    first = time.perf_counter() - t0
    times, launches = [], []
    for i in range(1, n + 1):
        listtrace.reset_launch_counts()
        t0 = time.perf_counter()
        out = _to_host(fn(i), device)
        times.append(time.perf_counter() - t0)
        launches.append(dict(listtrace.LAUNCHES))
    _check_finite(out)
    return out, first, times, launches


def _record_timed(line: dict, first, times, launches):
    line["build_s"] = first
    line["times_s"] = times
    line["launches"] = launches[times.index(min(times))]


def _profile(line: dict, fn, device):
    """One more call of ``fn`` under torch.profiler (probes/frame.py):
    the device time of all CUDA activity, its share of that call's wall
    time (``busy``) and of the fastest timed call's (``busy_of_fastest``),
    and the device ops with the most time."""
    from sycl_ray_tracing_tpu_torch.probes.frame import profile

    if device.type != "cuda":
        raise RuntimeError("--profile reads the card's activity: it needs "
                           "--device cuda")
    prof = profile(fn)
    line["device_ms"] = prof["device_ms"]
    line["busy"] = (prof["device_ms"] / prof["wall_ms"]
                    if prof["wall_ms"] else 0.0)
    # the profiler slows the frame it records: the same device time over
    # the fastest unprofiled call
    line["busy_of_fastest"] = prof["device_ms"] / (min(line["times_s"]) * 1e3)
    line["top_device_ops"] = [[ms, n, name[:120]]
                              for ms, n, name in prof["top"][:TOP_OPS]]


def _build_dragon(run: Run, tris: int, line: dict):
    t0 = time.perf_counter()
    scene = dragon_scene(tris, with_sky=True, sky_res=run.size.sky_res,
                         device=run.device)
    _to_host(scene.triangles[:1], run.device)
    line["scene_s"] = time.perf_counter() - t0
    return scene


def _forward_section(run: Run, line: dict, scene, prefix: str):
    """The timed forward frames of sections 1 and 3 and their gates."""
    cam = pbrt_dragon_camera(run.device)
    cfg = dragon_config(run.size)
    (img, ovf), first, times, launches = _timed(
        lambda i: frame(scene, cam, cfg, prng_key(i)), run.args.repeats,
        run.device)
    _record_timed(line, first, times, launches)
    line[f"{prefix}_overflow"] = ovf
    if ovf:
        raise RuntimeError(f"{prefix} frame reported overflow")
    if not float(img.mean()) > 1e-4:
        raise RuntimeError(f"broken {prefix} render")
    return cam, cfg, min(times)


def dragon_fwd(run: Run, line: dict):
    """Section 1 (bench.py:169-211)."""
    run.dragon = _build_dragon(run, run.size.tris, line)
    cam, cfg, dt = _forward_section(run, line, run.dragon, "dragon")
    line["dragon_fwd_mrays"] = run.rays / dt / 1e6
    line["dragon_fwd_ms"] = dt * 1e3
    # steady state: frames enqueued back to back, one synchronise
    n = run.args.steady
    t0 = time.perf_counter()
    outs = [frame(run.dragon, cam, cfg, prng_key(100 + i))[0]
            for i in range(n)]
    _to_host(tuple(outs), run.device)
    dt_st = (time.perf_counter() - t0) / n
    line["steady_frame_s"] = dt_st
    line["dragon_fwd_mrays_steady"] = run.rays / dt_st / 1e6
    if run.args.profile:
        _profile(line, lambda: frame(run.dragon, cam, cfg, prng_key(0)),
                 run.device)


def dragon_fwd_bwd(run: Run, line: dict):
    """Section 2 (bench.py:213-235)."""
    if run.dragon is None:
        run.dragon = _build_dragon(run, run.size.tris, line)
    cam = pbrt_dragon_camera(run.device)
    cfg = dragon_config(run.size)
    (_val, grad), first, times, launches = _timed(
        lambda i: value_and_grad(run.dragon, cam, cfg, prng_key(i)),
        run.args.repeats, run.device)
    _record_timed(line, first, times, launches)
    if not float(grad.abs().sum()) > 0:
        raise RuntimeError("zero gradient in fwd+bwd bench")
    dt = min(times)
    line["dragon_fwd_bwd_mrays"] = run.rays / dt / 1e6
    line["dragon_fwd_bwd_ms"] = dt * 1e3
    if run.args.profile:
        _profile(line, lambda: value_and_grad(run.dragon, cam, cfg,
                                              prng_key(0)), run.device)


def dragon870k_fwd(run: Run, line: dict):
    """Section 3 (bench.py:237-258)."""
    run.dragon = None          # the 200k scene, before the big one exists
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    big = _build_dragon(run, run.size.tris_big, line)
    k2 = big.clusters.num_clusters
    line["clusters"] = k2
    if k2 > listtrace.MAX_CLUSTERS:
        raise RuntimeError(f"{k2} clusters exceed the list kernels' "
                           f"MAX_CLUSTERS {listtrace.MAX_CLUSTERS}: the "
                           "870k scene must run the list path")
    cam, cfg, dt = _forward_section(run, line, big, "dragon870k")
    line["dragon870k_fwd_mrays"] = run.rays / dt / 1e6
    line["dragon870k_fwd_ms"] = dt * 1e3
    if run.args.profile:
        _profile(line, lambda: frame(big, cam, cfg, prng_key(0)), run.device)


def _cornell_path(run: Run) -> str:
    found = find_data(run.args.cornell)
    if found is None:
        raise FileNotFoundError(f"OBJ file not found: {run.args.cornell}")
    return found


def cornell_fwd(run: Run, line: dict):
    """Section 4 (bench.py:260-278)."""
    t0 = time.perf_counter()
    scene = load_scene(_cornell_path(run), device=run.device)
    line["scene_s"] = time.perf_counter() - t0
    cam = cornell_box_camera(run.device)
    cfg = cornell_config(run.size)
    img, first, times, launches = _timed(
        lambda i: frame(scene, cam, cfg, prng_key(i))[0], run.args.repeats,
        run.device)
    _record_timed(line, first, times, launches)
    if not float(img.mean()) > 0.05:
        raise RuntimeError("broken cornell render")
    w, h, spp, bounces = run.size.cornell
    line["cornell_fwd_mrays"] = w * h * spp * bounces / min(times) / 1e6
    if run.args.profile:
        _profile(line, lambda: frame(scene, cam, cfg, prng_key(0)),
                 run.device)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_times(world: int, obj: str, run: Run, deadline: float) -> list:
    """Rank 0's timed calls of render_sharded on ``world`` gloo ranks,
    each a process of its own on the CPU.  Every rank is killed at the
    deadline."""
    code = ("import sys; from sycl_ray_tracing_tpu_torch.bench import "
            "weak_rank; weak_rank(sys.argv[1:])")
    env = dict(os.environ, OMP_NUM_THREADS=str(WEAK_THREADS),
               CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(REPO), os.environ.get("PYTHONPATH"))
                   if p))
    port = str(_free_port())
    argv = [obj, *map(str, run.size.weak), str(run.args.repeats)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(world), port, *argv],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            left = max(0.1, deadline - time.monotonic())
            logs.append(p.communicate(timeout=left)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"weak-scaling rank {r} of {world} failed: "
                               f"{log[-300:]}")
    for ln in logs[0].splitlines():
        if ln.startswith("WEAK_TIMES "):
            return json.loads(ln[len("WEAK_TIMES "):])
    raise RuntimeError(f"weak-scaling rank 0 of {world} printed no times")


def weak_rank(argv) -> None:
    """One rank of section 5: join the gloo group, render the Cornell
    scene with render_sharded once to warm up, then time ``repeats``
    calls (after a barrier); rank 0 prints its times."""
    rank, world, port, obj, w, h, spp, bounces, repeats = argv
    import torch.distributed as dist

    from sycl_ray_tracing_tpu_torch.parallel import distributed
    from sycl_ray_tracing_tpu_torch.parallel.mesh import make_mesh
    from sycl_ray_tracing_tpu_torch.parallel.render import render_sharded

    torch.set_num_threads(WEAK_THREADS)
    world = int(world)
    distributed.initialize(f"127.0.0.1:{port}", world, int(rank),
                           device="cpu")
    try:
        scene = load_scene(obj, device="cpu")
        cam = cornell_box_camera("cpu")
        cfg = RenderConfig(width=int(w) * world, height=int(h),
                           samples=int(spp), bounces=int(bounces))
        mesh = make_mesh(world, sample_axis=1)
        render_sharded(scene, cam, cfg, prng_key(0), mesh)
        times = []
        for i in range(int(repeats)):
            dist.barrier()
            t0 = time.perf_counter()
            img = render_sharded(scene, cam, cfg, prng_key(i + 1), mesh)
            times.append(time.perf_counter() - t0)
        _check_finite(img)
        if int(rank) == 0:
            print("WEAK_TIMES " + json.dumps(times), flush=True)
    finally:
        dist.destroy_process_group()


def weak_scaling(run: Run, line: dict):
    """Section 5 (bench.py:279-316), on gloo ranks in processes of their
    own: n * t1 / tn for n = --weak-ranks, under weak_key(n)."""
    obj = str(Path(_cornell_path(run)).resolve())
    n = run.args.weak_ranks
    line["world"] = n
    line["threads_per_rank"] = WEAK_THREADS
    deadline = time.monotonic() + WEAK_TIMEOUT
    one = _rank_times(1, obj, run, deadline)
    many = _rank_times(n, obj, run, deadline)
    line["times_s_one_rank"] = one
    line["times_s"] = many
    t1, tn = statistics.mean(one), statistics.mean(many)
    line[weak_key(n)] = n * t1 / max(tn, 1e-9)


def weak_key(ranks: int) -> str:
    """Section 5's result key, named by its rank count: at the default 8
    ranks it is the JAX bench's weak_scaling_proxy_cpu8."""
    return f"weak_scaling_proxy_cpu{ranks}"


# section number -> (name, function); the name is the JAX bench's key in
# "errors"; each function writes its results into the line it is given
SECTIONS = {
    1: ("dragon_fwd", dragon_fwd),
    2: ("dragon_fwd_bwd", dragon_fwd_bwd),
    3: ("dragon870k_fwd", dragon870k_fwd),
    4: ("cornell_fwd", cornell_fwd),
    5: ("weak_scaling", weak_scaling),
}
# the keys sections 1-4 add to the last line's "extra" (bench.py's names);
# section 5's is weak_key(--weak-ranks)
RESULT_KEYS = {
    "dragon_fwd": ("dragon_overflow", "dragon_fwd_mrays", "dragon_fwd_ms",
                   "dragon_fwd_mrays_steady"),
    "dragon_fwd_bwd": ("dragon_fwd_bwd_mrays", "dragon_fwd_bwd_ms"),
    "dragon870k_fwd": ("dragon870k_overflow", "dragon870k_fwd_mrays",
                       "dragon870k_fwd_ms"),
    "cornell_fwd": ("cornell_fwd_mrays",),
}


def result_keys(run: Run, name: str) -> tuple:
    """The keys section ``name`` adds to the last line's "extra"."""
    if name == "weak_scaling":
        return (weak_key(run.args.weak_ranks),)
    return RESULT_KEYS[name]


def _nvidia_smi(device) -> dict:
    """The card's power limit, SM clock and power draw (nvidia-smi), or
    {} where nvidia-smi cannot be read."""
    index = device.index if device.index is not None else 0
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}",
             "--query-gpu=power.limit,clocks.sm,power.draw",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True, timeout=60)
        limit, clock, draw = (float(x) for x in
                              out.stdout.strip().split(","))
    except (OSError, subprocess.SubprocessError, ValueError):
        return {}
    return {"power_limit_w": limit, "sm_clock_mhz": clock,
            "power_draw_w": draw}


def device_info(device) -> dict:
    """The device a line was measured on: name, power limit and count,
    with the SM clock and power draw at the time of the call."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit_w": None, "count": 0}
    return {"name": torch.cuda.get_device_name(device),
            "power_limit_w": None, "count": torch.cuda.device_count(),
            **_nvidia_smi(device)}


def run_section(run: Run, number: int) -> dict:
    """Run one section under its own try, print its line and fold its
    JAX keys (or its error) into ``run``."""
    name, fn = SECTIONS[number]
    line = {"section": name, "ok": False}
    try:
        fn(run, line)
        line["ok"] = True
    except Exception as e:  # a late failure keeps the earlier numbers
        traceback.print_exc(file=sys.stderr)
        run.errors[name] = line["error"] = repr(e)[:200]
    run.results.update({k: line[k] for k in result_keys(run, name)
                        if k in line})
    line["device"] = device_info(run.device)
    print(json.dumps(line), flush=True)
    return line


def _append_history(path: str, results: dict) -> None:
    try:
        rev = subprocess.run(["git", "-C", str(REPO), "rev-parse", "--short",
                              "HEAD"], capture_output=True, text=True,
                             timeout=10).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        rev = "unknown"
    entry = {"ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime()),
             "git": rev, "results": results}
    with open(path, "a") as f:
        f.write(json.dumps(entry) + "\n")


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m sycl_ray_tracing_tpu_torch.bench",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--sections", default="1,2,3,4,5",
                    help="comma-separated section numbers (default all)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed calls a section after the warm-up")
    ap.add_argument("--steady", type=int, default=8,
                    help="section 1's frames enqueued back to back")
    ap.add_argument("--small", action="store_true",
                    help="the tests' size (never a number for the card)")
    ap.add_argument("--cornell", default=CORNELL_OBJ,
                    help="the OBJ of sections 4 and 5")
    ap.add_argument("--weak-ranks", type=int, default=8,
                    help="gloo ranks of section 5's many-rank run")
    ap.add_argument("--history", default=None,
                    help="append this run's results to this file")
    ap.add_argument("--profile", action="store_true",
                    help="one more frame a section under torch.profiler")
    args = ap.parse_args(argv)
    args.sections = sorted({int(s) for s in args.sections.split(",")})
    if not set(args.sections) <= set(SECTIONS) or args.repeats < 1 \
            or args.steady < 1 or args.weak_ranks < 1:
        ap.error("sections are 1-5; --repeats, --steady and --weak-ranks "
                 "are at least 1")
    return args


def main(argv=None) -> int:
    args = _parse(sys.argv[1:] if argv is None else argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device; the bench runs on the card unless "
              "given --device cpu", file=sys.stderr)
        return NO_CARD
    device = torch.device(args.device)
    size = SMALL if args.small else FULL
    run = Run(args, device, size)
    # the port's native build raises instead of falling back to Morton
    run.results["cluster_order"] = "sah"
    before = device_info(device)
    for number in args.sections:
        run_section(run, number)
    if run.errors:
        run.results["errors"] = run.errors
    if args.history:
        _append_history(args.history, run.results)
    after = device_info(device)
    dev = {k: before.get(k) for k in ("name", "power_limit_w", "count")}
    for k in ("sm_clock_mhz", "power_draw_w"):
        if k in before:
            dev[k] = [before[k], after.get(k)]
    mrays = run.results.get("dragon_fwd_mrays_steady",
                            run.results.get("dragon_fwd_mrays", 0.0))
    print(json.dumps({
        "metric": f"Mrays/s/card fwd steady-state (dragon stand-in "
                  f"{size.tris} tris + HDR sky, {size.width}x{size.height}, "
                  f"1spp, {size.bounces} bounces, list backend, "
                  f"overflow=False certified)",
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": None,
        "extra": dict(run.results, device=dev),
    }), flush=True)
    return 0 if "dragon_fwd_mrays" in run.results else 1


if __name__ == "__main__":
    sys.exit(main())
