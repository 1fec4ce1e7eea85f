#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path and its probe path once on
one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. Device: the card's name and power limit (nvidia-smi), then the build
     of every kernel from the checkout's sources, all builds started
     together (nvcc for csrc/listtrace.cu and csrc/probes.cu, g++ for the
     native SAH builder).
  2. Kernels vs their plain torch versions on the card, on inputs captured
     from the main path itself: the 32768-ray primary launch and the fused
     ~98k-ray 3-query launch of the first bounce (block-shared kernel),
     and the largest escalation launch (per-ray kernel): (at, ar, stop)
     must be bit-identical, and so must _run's (t, packed, resolved,
     overflow).  For the bounce-1 and the escalation launch it prints the
     live list-rounds and those the tail guard let run, the time back to
     back, the bound on the rounds run beside the bound on all live
     rounds, and the kernel's registers, local (spill) bytes and blocks
     per SM (it fails if a kernel spills); for the escalation launch also
     the time of every rays-per-block instance.  Then certified closest
     hits are held against the brute-force triangle oracle on a small ray
     subset.
  3. The main path: render() of the 200k-triangle dragon + HDR sky at
     512x512, 1 spp, 8 bounces, list tracer, shared estimator, 32768-ray
     tiles — warm, with the kernels' launch counters reset just before;
     then one more frame with every list-kernel launch timed (CUDA events)
     and bounded, for each kernel's time and sum of bounds per frame, and
     one more under torch.profiler, for each list kernel's device time
     per frame beside its event time (probes/frame.py).  Every launch of
     the timed frame where the tail guard stopped a list is held bit for
     bit against the plain version (at least one block-kernel launch must
     exist), and the count of such launches is printed per kernel.
  4. One 32768-ray tile at 8 bounces with the kernels and with the plain
     versions: the radiance must be bit-identical.
  5. The probe path: each probe kernel against its plain version at the
     probe scripts' shapes (the block kernel on kernel_shape's maxc-96
     grouped lists and the per-ray kernel at 1 / 8 / 16 / 32 rays per
     block on its maxc-32 per-ray lists, (at, ar, stop) each, where the
     guard must stop lists; the unguarded lane-min form, the synthetic
     round in every variant and sub-block count, the three feature smoke
     kernels, also against the scripts' closed forms), then every probe
     sweep once (python -m sycl_ray_tracing_tpu_torch.probes), with the
     probe kernels' launch counters reset just before.
  6. The 870k-triangle frame, whose main passes take the supercluster-
     prefiltered candidate build (K2 above 2*maxs*64 clusters): the scene
     (K2, K1, the SAH build's wall time, the tables' bytes); on the
     bounce-1 fused launch's hierarchical lists, block_tiles' (at, ar,
     stop) bit for bit against its plain version (poisoned SC-overflow
     lists among them, or else a launch built with a smaller maxs that
     has some) and _run's (t, packed, resolved, overflow) against the
     plain versions; the same rays' hierarchical lists against the dense
     build on the lists without SC overflow (the same live counts, the
     same candidates on lists that fit, entry-t within the id-bit
     quantization); the frame warm (overflow False, finite, both launch
     counters above 0, peak memory under 20 GB) with its time, launches,
     each list kernel's event and device time and bound per frame, the
     poisoned lists and escalation rays per launch; the largest escalation
     list_tiles launch bit for bit; one profiled frame (probes/frame.py,
     with the top device ops) and each candidate build's device time over
     a frame; certified closest hits against the brute-force oracle on a
     ray subset.
  7. The backward pass, bench.py section 2: value and gradient of the
     200k frame's mean w.r.t. materials.diffuse through render() with
     remat.  First the frame with remat=False, then the timed warm
     fwd+bwd frame with the launch counters reset just before (time,
     Mrays/s, overflow False, a finite gradient with a nonzero sum,
     block_tiles and list_tiles launches equal to phase 3's forward
     frame's: the replay traces nothing); for both frames the memory held
     before, the forward's peak, the memory held after the forward and
     the backward's peak; the two frames' gradients against each other,
     then one frame profiled in two windows
     (forward, backward: device busy share, the backward's top device ops
     and no list-kernel launch in it).  On one 32768-ray tile at 8
     bounces: the forward radiance bit-identical between the kernels and
     the plain versions, their gradients within GRAD_RTOL, and the
     kernels' AD against a central finite difference of diffuse[2, 0]
     (the ground's red) within 2e-3 + 5%.
  8. The parity estimator (``trace``, 5 scene queries a bounce) and the
     other backends.  (a) The 200k frame of phase 3 with
     estimator="parity": cold and warm time, Mrays/s, both list kernels'
     launches (counters reset just before; each must be above 0), peak
     memory, overflow False, a finite image, its mean beside phase 3's;
     one more frame with each list-kernel launch timed and bounded, and
     one profiled (each list kernel's device time, device busy share,
     top device ops).
     (b) One 32768-ray parity tile at 8 bounces, kernels against plain
     versions: bit-identical radiance.  (c) The same scene plus two
     spheres, through the fused list path: a warm frame (overflow False,
     primary rays ending on the spheres) and the tile that holds them
     bit-identical between kernels and plain versions.  (d) A tile with
     the materials padded to 2049 rows (the unfused shading) against the
     fused path on the unpadded scene, both uncompacted: at least 99% of
     rays within 1e-3 and the means within 1%.  (e) A 4k-triangle dragon
     with a sky and the two spheres, with clusters and a SAH BVH, at
     64x64, 2 spp, 3 bounces, both estimators through "list", "cluster",
     "bvh" and "brute": each frame's time (the BVH's lockstep steps too),
     overflow False, and every image within rtol 2e-4 / atol 1e-5 of
     brute force per pixel (tests/test_integrator.py:293-294).
  9. The user's entry points, in a temporary directory that is the cwd
     of every CLI call.  (a) The 200k scene written as OBJ + MTL and its
     512x1024 sky as .hdr (upside down, so the CLI's flipped read gives
     the scene's sky); the OBJ parsed by the native C++ parser and by the
     Python one (equal arrays, each parse's ms), the sky read back equal
     to RGBE precision.  (b) The CLI in-process (python -m
     sycl_ray_tracing_tpu_torch.main dragon.obj --sky=sky.hdr --w=512
     --h=512 --samples=4 --bounces=8 --camera=pbrt_dragon
     --intersect=list --estimator=shared), the launch counters reset just
     before: exit 0, no regrow warning (so overflow False), the five
     outputs, RT_output.hdr equal to the rendered image to RGBE
     precision, both list kernels launched; its scene_load, accel_build
     and render seconds and Mrays/s; then the same call with every
     list-kernel launch timed and bounded, and once under the profiler.
     (c) One ProgressiveRenderer batch saved, the CLI resuming it to 2
     spp (--checkpoint, --checkpoint-batch=1): bit-identical to the same
     render without a break.  (d) The 4k scene as OBJ with clusters of
     candidate depth 1: the CLI doubles the depth and ends with every ray
     certified (no ERROR line).  (e) train.run on a one-rank NCCL group:
     5 steps on the 200k scene + sky at 128x128, 4 spp, 2 bounces, the
     launch counters reset just before (finite losses, finite nonzero
     gradients, the diffuse error falls; both list kernels launched, none
     inside the backward calls; every launch of step 0's forward held bit
     for bit against the plain versions as it happens; seconds a step,
     peak memory).  (f) render_sharded on that rank: the 200k frame at
     512x512, 1 spp, 8 bounces in one render_rays call (block_tiles
     launches of up to 786,432 rays), the counters reset just before and
     every launch held bit for bit (both kernels launched), then again
     for its time and peak memory (under 20 GB), the same image bit for
     bit; its mean within 2% of phase 3's.
 10. The five BASELINE configurations through their example modules
     (sycl_ray_tracing_tpu_torch/examples/), each in a temporary cwd, at
     full width (resolution, triangles, sky, bounces, tiles), depth cut
     for the script's time: config 1 unchanged (256x256, 16 spp, brute
     force), config 2 64 -> 4 spp, config 3 128 -> 1 spp, config 4 256 ->
     1 spp, config 5 100 -> 5 steps at its 32x32x16 spp.  MIS.obj and
     cornell_pbr.obj are procedural stand-ins written as OBJ + MTL under a
     temporary $SRT_REFERENCE_ROOT.  For each image config, the launch
     counters reset just before its _common.run (a warm-up render and the
     timed ones): its JSON line, overflow (must be False), a finite image
     above the example's mean bound, the files it wrote, peak device
     memory, both list kernels' launches (above 0, the first launch held
     bit for bit against the plain version as it happens, for each kernel
     the config's path reaches; 0 for the others: off the list tracer
     none, and list_tiles, the escalation, only where the scene has more
     clusters than a block list's 128 slots); config 4's frame once more
     with each list-kernel launch timed and bounded, and once under the
     profiler (device busy share).  Config 5 runs train.main
     with the example's arguments on a one-rank NCCL group: exit 0 (the
     diffuse error fell) and no list-kernel launch (the trainer builds no
     clusters).

The second-to-last lines are the card line and one JSON object describing
each kernel (time, plain version's time, launches, and the bound: the
least time an H100 could take for the same work); the last line is
{"ok": true, "device": {...}}.  Each kernel's entry also carries its
launches in the fwd+bwd frame (phase 7), the parity frame (phase 8), the
CLI frame (phase 9, "cli": launches, event ms, device ms, bound), the
trainer ("train": launches, those in the backward, launches held, the
largest held launch's rays, max |dt|), render_sharded ("sharded": the
same without the backward) and each BASELINE config ("examples": launches,
renders, launches held, the largest held launch's rays, max |dt|; and
"config4_frame": launches, event ms, device ms, bound of one frame).
Without CUDA, or without the rest of the
repository beside it, the script exits 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
SEED = 0
N_TRIS = 200_000
N_TRIS_BIG = 870_000   # the reference's pbrt_dragon size (bench.py:237-258)
PEAK_LIMIT = 20 << 30  # bytes of device memory the 870k frame may peak at
W = H = 512
BOUNCES = 8
TILE = 32768
LISTTRACE_CU = "sycl_ray_tracing_tpu_torch/csrc/listtrace.cu"
PROBES_CU = "sycl_ray_tracing_tpu_torch/csrc/probes.cu"
GRAD_RTOL = 1e-4       # gradients of one frame by two routes, of max |g|
# phase 8: two spheres in the dragon camera's view (tests/test_integrator.py
# :243-290), and the small scene every backend renders
SPHERES = (((1.5, 0.0, 0.0), 0.5, dict(diffuse=(0.8, 0.3, 0.2))),
           ((-1.2, 0.5, 0.8), 0.35, dict(metalness=0.5, roughness=0.3)))
SMALL_TRIS = 4_000
SMALL_W = 64
SMALL_SPP = 2
SMALL_BOUNCES = 3
# phase 9: the CLI frame's samples, the sky's size, the regrow's starting
# candidate depth, the trainer's frame and steps
CLI_SPP = 4
SKY_RES = (512, 1024)
REGROW_MAXC = 1
TRAIN_W = 128
TRAIN_SPP = 4
TRAIN_BOUNCES = 2
TRAIN_STEPS = 5
# what the CLI writes into its cwd
CLI_OUTPUTS = ("RT_output.png", "RT_output.hdr", "RT_output_denoised_1.png",
               "RT_output_denoised_0.75.png", "RT_output_denoised_0.5.png")
# phase 10: the BASELINE configs' depth cuts (samples a pixel; the
# trainer's steps), at full width otherwise
EX_SPP = {"config2_obj_bvh": 4, "config3_dragon_mis": 1,
          "config4_env_tonemap": 1}
EX_STEPS = 5
BLOCK_REPLACES = "sycl_ray_tracing_tpu/ops/pallas/listtrace.py:298"
LIST_REPLACES = "sycl_ray_tracing_tpu/ops/pallas/listtrace.py:245"


def log(msg: str):
    """One output line, led by the seconds since the script started."""
    print(f"[{time.perf_counter() - T_START:6.1f} s] {msg}", flush=True)


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
            def hook(*args, impl=None):
                # (cand, ctn, rays); tris is the scene's
                self.tiles[name].append(tuple(a.clone() for a in args[:-1]))
                return self._orig[name](*args, impl=impl)
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


class LaunchTimer:
    """Times every list-kernel launch of a render with CUDA events around
    the wrapper call (so an idle card's wait for the host's launch path
    is included) and with the host clock around the same call, and keeps
    its inputs and stop, for its bound."""

    def __init__(self, lt):
        self.lt = lt
        self.launches = []
        self._orig = {}

    def __enter__(self):
        import torch

        def hook(name):
            def timed(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                t0 = time.perf_counter()
                out = self._orig[name](*args, **kw)
                host = time.perf_counter() - t0
                end.record()
                # (cand, ctn, rays, tris, stop)
                self.launches.append((name, start, end, host,
                                      args + out[2:]))
                return out
            return timed

        for name in ("block_tiles", "list_tiles"):
            self._orig[name] = getattr(self.lt, name)
            setattr(self.lt, name, hook(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.lt, name, fn)

    def per_kernel(self, bounds) -> dict:
        """{name: (launches, kernel ms, host ms in the wrapper, sum of
        per-launch bound ms)}, each launch bounded on the rounds its guard
        ran."""
        import torch

        torch.cuda.synchronize()
        out = {}
        for name, start, end, host, args in self.launches:
            cand, _ctn, rays, tris, stop = args
            n, ms, h_ms, bms = out.get(name, (0, 0.0, 0.0, 0.0))
            b_ms, _by = bounds.bound(*getattr(bounds, f"{name}_work")(
                cand, rays, tris, stop))
            out[name] = (n + 1, ms + start.elapsed_time(end),
                         h_ms + host * 1e3, bms + b_ms)
        return out


class RunWatch:
    """Per _run call of a render: its rays, live rays, and live rays left
    uncertified (those make the honest overflow flag)."""

    def __init__(self, lt):
        self.lt = lt
        self.calls = []

    def __enter__(self):
        self._orig = self.lt._run

        def hook(scene, o, d, tl, maxc, any_hit, **kw):
            out = self._orig(scene, o, d, tl, maxc, any_hit, **kw)
            mask = kw.get("mask")
            live = out[2].new_ones(out[2].shape) if mask is None else mask
            left = live & ~self.lt._certain(any_hit, out[1], out[2])
            self.calls.append((o.shape[0], int(live.sum()), int(left.sum())))
            return out

        self.lt._run = hook
        return self

    def __exit__(self, *exc):
        self.lt._run = self._orig


class HoldEach:
    """While ``on``, every list-kernel launch of a run is held against its
    plain version on the same inputs as it happens: the run's own launch
    (through the wrapper, so counted once, as without the hold) must give
    the plain version's (at, ar, stop) bit for bit.  Keeps no tensor of
    the run; per kernel it keeps (launches held, rays of the largest, max
    |dt|), and the seconds the holds took.  With ``first`` it holds only
    the first ``first`` launches of each kernel."""

    def __init__(self, lt, first=None):
        self.lt = lt
        self.on = True
        self.first = first
        self.held = {"block_tiles": (0, 0, 0.0), "list_tiles": (0, 0, 0.0)}
        self.seconds = 0.0
        self._orig = {}

    def __enter__(self):
        import torch

        def hook(name):
            orig = self._orig[name] = getattr(self.lt, name)
            plain = getattr(self.lt, f"{name}_plain")

            def held(*args, **kw):
                out = orig(*args, **kw)
                if self.on and kw.get("impl") in (None, "cuda") and (
                        self.first is None
                        or self.held[name][0] < self.first):
                    t0 = time.perf_counter()
                    want = plain(*args[:4])
                    same = all(torch.equal(a, b) for a, b in zip(out, want))
                    n, rays, err = self.held[name]
                    rays = max(rays, args[2].shape[0])
                    err = max(err, max_abs_err(out[0], want[0]))
                    self.held[name] = (n + 1, rays, err)
                    self.seconds += time.perf_counter() - t0
                    if not same:
                        raise RuntimeError(
                            f"{name} disagrees with its plain version on a "
                            f"launch of {args[2].shape[0]} rays (max |dt| "
                            f"{err})")
                return out
            return held

        for name in self.held:
            setattr(self.lt, name, hook(name))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.lt, name, fn)


class BackwardWatch:
    """Counts the list-kernel launches made inside torch.autograd.grad (a
    train step's backward, remat replay included).  The first call ends
    the forward that ``hold`` covers: it turns the hold off and resets the
    peak-memory counter, so the peak read after the run is that of the
    steps without holds."""

    def __init__(self, lt, hold):
        self.lt, self.hold = lt, hold
        self.calls = 0
        self.launches = {k: 0 for k in lt.LAUNCHES}

    def __enter__(self):
        import torch

        self._orig = torch.autograd.grad

        def grad(*args, **kw):
            before = dict(self.lt.LAUNCHES)
            out = self._orig(*args, **kw)
            for k, n in self.lt.LAUNCHES.items():
                self.launches[k] += n - before[k]
            if not self.calls:
                self.hold.on = False
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            self.calls += 1
            return out

        torch.autograd.grad = grad
        return self

    def __exit__(self, *exc):
        import torch

        torch.autograd.grad = self._orig


def write_obj(path: str, triangles, material_indices, materials) -> None:
    """Write triangles [N,3,3], their material rows [N] and a Materials
    table as OBJ + MTL (``path`` and ``path`` with .mtl), for the loader
    to read back: three vertices per triangle (%.9g, exact for float32),
    faces in order under one ``usemtl`` per run of a material, MTL
    material k for row k >= 1 (row 0 is the loader's debug material)
    with illum 2, so Pm and Pr are read."""
    import numpy as np

    tris = np.asarray(triangles, np.float32).reshape(-1, 3)
    mi = np.asarray(material_indices)
    mtl_path = os.path.splitext(path)[0] + ".mtl"
    table = {f: np.asarray(getattr(materials, f).detach().cpu().numpy(),
                           np.float32)
             for f in ("emission", "diffuse", "metalness", "roughness")}
    with open(mtl_path, "w") as f:
        for k in range(1, table["emission"].shape[0]):
            f.write(f"newmtl m{k}\n"
                    "Kd {:.9g} {:.9g} {:.9g}\n".format(*table["diffuse"][k])
                    + "Ke {:.9g} {:.9g} {:.9g}\n".format(*table["emission"][k])
                    + f"Pm {table['metalness'][k]:.9g}\n"
                    f"Pr {table['roughness'][k]:.9g}\nillum 2\n")
    with open(path, "w") as f:
        f.write(f"mtllib {os.path.basename(mtl_path)}\n")
        np.savetxt(f, tris, fmt="v %.9g %.9g %.9g")
        starts = np.flatnonzero(np.r_[True, mi[1:] != mi[:-1]])
        ends = np.r_[starts[1:], mi.shape[0]]
        for a, b in zip(starts, ends):
            f.write(f"usemtl m{int(mi[a])}\n")
            ids = np.arange(3 * a + 1, 3 * b + 1).reshape(-1, 3)
            np.savetxt(f, ids, fmt="f %d %d %d")


def _quad(a, b, c, d, toward) -> list:
    """Two triangles of the planar quad a-b-c-d, wound so that their
    geometric normal points along ``toward`` (shading is one-sided)."""
    import numpy as np

    a, b, c, d = (np.asarray(p, np.float32) for p in (a, b, c, d))
    if np.dot(np.cross(b - a, c - a), toward) < 0:
        b, d = d, b
    return [[a, b, c], [a, c, d]]


def _box(lo, hi, turn_deg=0.0) -> list:
    """12 outward-facing triangles of the box [lo, hi] turned by
    ``turn_deg`` about its vertical axis."""
    import numpy as np

    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    mid = (lo + hi) / 2
    c, s = np.cos(np.radians(turn_deg)), np.sin(np.radians(turn_deg))

    def corner(ix, iy, iz):
        p = np.where([ix, iy, iz], hi, lo) - mid
        return mid + np.array(
            [c * p[0] + s * p[2], p[1], -s * p[0] + c * p[2]], np.float32)

    tris = []
    for axis in range(3):
        for side in (0, 1):
            ids = []
            for u, v in ((0, 0), (1, 0), (1, 1), (0, 1)):
                bits = [u, v]
                bits.insert(axis, side)
                ids.append(corner(*bits))
            tris += _quad(*ids, toward=np.mean(ids, axis=0) - mid)
    return tris


def _sphere(center, radius, seg) -> list:
    """A UV sphere of 4*seg*(seg-1) outward-facing triangles."""
    import numpy as np

    center = np.asarray(center, np.float32)
    th = np.linspace(0.0, np.pi, seg + 1)
    ph = np.linspace(0.0, 2 * np.pi, 2 * seg + 1)

    def p(i, j):
        return center + radius * np.array(
            [np.sin(th[i]) * np.cos(ph[j]), np.cos(th[i]),
             np.sin(th[i]) * np.sin(ph[j])], np.float32)

    tris = []
    for i in range(seg):
        for j in range(2 * seg):
            a, b, c, d = p(i, j), p(i + 1, j), p(i + 1, j + 1), p(i, j + 1)
            # the pole bands' quads have one degenerate triangle
            tris += [t for t in _quad(a, b, c, d, (a + c) / 2 - center)
                     if np.linalg.norm(np.cross(t[1] - t[0], t[2] - t[0]))
                     > 0]
    return tris


def mis_standin(seg: int = 16) -> tuple:
    """A procedural stand-in for the reference's MIS.obj (Veach's
    multiple-importance-sampling scene, 3860 triangles): four glossy
    metal plates of rising roughness under four spherical lights of
    falling size and rising radiance, a dim overhead panel, a floor and a
    back wall, in the view of models.camera.mis_camera.  ``seg`` sets the
    spheres' tessellation (16: 3,854 triangles).  Returns (triangles
    [N,3,3], material rows [N], {emission, diffuse, metalness,
    roughness}: row 0 the loader's debug material)."""
    import numpy as np

    parts = [
        (_quad((-10, -7.5, -6), (10, -7.5, -6), (10, -7.5, 6),
               (-10, -7.5, 6), (0, 1, 0)), 1),
        (_quad((-10, -7.5, -5), (10, -7.5, -5), (10, 4, -5), (-10, 4, -5),
               (0, 0, 1)), 1),
        (_quad((-3, 4, -2), (3, 4, -2), (3, 4, 2), (-3, 4, 2), (0, -1, 0)),
         2),
    ]
    # the plates rise toward the back wall, each tilted a little more
    for k, (y, z) in enumerate(((-6.0, 1.5), (-5.0, 0.5), (-4.0, -0.5),
                                (-3.0, -1.5))):
        tilt = np.radians(25.0 + 8.0 * k)
        dy, dz = 0.6 * np.sin(tilt), -0.6 * np.cos(tilt)
        parts.append((_quad((-3.5, y - dy, z - dz), (3.5, y - dy, z - dz),
                            (3.5, y + dy, z + dz), (-3.5, y + dy, z + dz),
                            (0, np.cos(tilt), np.sin(tilt))), 3 + k))
    radii = (0.05, 0.15, 0.4, 1.0)
    for k, (x, r) in enumerate(zip((-3.75, -1.25, 1.25, 3.75), radii)):
        parts.append((_sphere((x, 0.5, -3.0), r, seg), 7 + k))
    tris = np.array([t for p, _ in parts for t in p], np.float32)
    mat = np.concatenate([np.full(len(p), m, np.int32) for p, m in parts])
    colors = ((1.0, 0.3, 0.3), (0.3, 1.0, 0.3), (0.3, 0.5, 1.0),
              (1.0, 0.9, 0.6))
    table = dict(
        emission=[(1, 0, 1), (0, 0, 0), (2, 2, 2)] + [(0, 0, 0)] * 4
        + [tuple(4.0 / r ** 2 * c for c in col)
           for r, col in zip(radii, colors)],
        diffuse=[(0, 0, 0), (0.4, 0.4, 0.4), (0, 0, 0)]
        + [(0.7, 0.7, 0.7)] * 4 + [(0, 0, 0)] * 4,
        metalness=[0, 0, 0] + [1.0] * 4 + [0] * 4,
        roughness=[1, 0.9, 1] + [0.05, 0.15, 0.35, 0.7] + [1] * 4)
    return tris, mat, table


def cornell_standin() -> tuple:
    """A procedural stand-in for the reference's cornell_pbr.obj: the
    Cornell box (white floor, ceiling and back wall, red left and green
    right walls, a ceiling light) with a tall and a short box, in the view
    of models.camera.cornell_box_camera.  Returns what mis_standin
    returns."""
    import numpy as np

    parts = [
        (_quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1), (0, 1, 0)), 1),
        (_quad((-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1), (0, -1, 0)),
         1),
        (_quad((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1), (0, 0, 1)),
         1),
        (_quad((-1, 0, -1), (-1, 2, -1), (-1, 2, 1), (-1, 0, 1), (1, 0, 0)),
         2),
        (_quad((1, 0, -1), (1, 2, -1), (1, 2, 1), (1, 0, 1), (-1, 0, 0)), 3),
        (_quad((-0.25, 1.98, -0.25), (0.25, 1.98, -0.25),
               (0.25, 1.98, 0.25), (-0.25, 1.98, 0.25), (0, -1, 0)), 4),
        (_box((-0.7, 0.0, -0.6), (-0.1, 1.2, 0.0), 18.0), 5),
        (_box((0.1, 0.0, 0.0), (0.7, 0.6, 0.6), -17.0), 6),
    ]
    tris = np.array([t for p, _ in parts for t in p], np.float32)
    mat = np.concatenate([np.full(len(p), m, np.int32) for p, m in parts])
    table = dict(
        emission=[(1, 0, 1)] + [(0, 0, 0)] * 3 + [(17, 12, 4)]
        + [(0, 0, 0)] * 2,
        diffuse=[(0, 0, 0), (0.73, 0.73, 0.73), (0.65, 0.05, 0.05),
                 (0.12, 0.45, 0.15), (0, 0, 0), (0.73, 0.73, 0.73),
                 (0.6, 0.6, 0.8)],
        metalness=[0, 0, 0, 0, 0, 0.2, 0.5],
        roughness=[1, 0.8, 0.6, 0.6, 1, 0.5, 0.3])
    return tris, mat, table


def write_standin(path: str, standin: tuple) -> None:
    """Write mis_standin()'s or cornell_standin()'s scene as OBJ + MTL
    at ``path`` (its directories made)."""
    from sycl_ray_tracing_tpu_torch.models.scene import make_materials

    tris, mat, table = standin
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_obj(path, tris, mat, make_materials(**table, device="cpu"))


def max_abs_err(a, b) -> float:
    import torch

    diff = (a.double() - b.double()).abs()
    diff = diff[torch.isfinite(diff)]
    return float(diff.max()) if diff.numel() else 0.0


def live_note(cand, tris) -> str:
    live = (cand != tris.shape[0] - 1).sum(dim=1).float()
    return (f"{cand.shape[0]} lists, {int(live.sum())} live list rounds (per "
            f"list mean {float(live.mean()):.2f}, p90 "
            f"{float(live.quantile(0.9)):.0f}, max {int(live.max())})")


def hold_tiles(lt, name, launch, tris, label, **kw) -> tuple:
    """A list kernel (block_tiles or list_tiles) against its plain version
    on one launch's (cand, ctn, rays): (at, ar, stop) must be
    bit-identical.  Returns (the plain version's stop, max |dt|, lists the
    guard stopped before their count)."""
    import torch

    cand, ctn, rays = launch
    out = getattr(lt, f"{name}_cuda")(cand, ctn, rays, tris, **kw)
    want = getattr(lt, f"{name}_plain")(cand, ctn, rays, tris)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(out, want))
    err = max_abs_err(out[0], want[0])
    stop = want[2]
    early = int((stop < lt.list_counts(cand, tris.shape[0] - 1)).sum())
    log(f"{label}: rays {rays.shape[0]}, maxc {cand.shape[1]}, (at, ar, "
        f"stop) bit-identical={same}, the guard stopped {early} of "
        f"{cand.shape[0]} lists early")
    if not same:
        raise RuntimeError(f"{name} disagrees with its plain version at "
                           f"{label} (max |dt| {err})")
    return stop, err, early


def check_info(lt, name, label, **kw):
    """Print a built list kernel's registers, spill and occupancy; fail if
    it spills."""
    info = getattr(lt, f"{name}_info")(**kw)
    log(f"{label}: {info['registers']} registers, {info['local_bytes']} "
        f"local (spill) bytes per thread, {info['threads']} threads and "
        f"{info['shared_bytes']} shared bytes per block, "
        f"{info['blocks_per_sm']} blocks ({info['warps_per_sm']} warps) "
        f"per SM")
    if info["local_bytes"]:
        raise RuntimeError(f"{label} spills to local memory")


def tiles_phase(lt, name, bounds, cuda_ms, tris, held, timed, replaces,
                card) -> dict:
    """Phase 2 for a list kernel: bit-identity of (at, ar, stop) with the
    plain version at each of ``held`` ((label, launch) pairs); then the
    ``timed`` launch's rounds, time, bounds, registers and occupancy.
    Returns its kernels entry."""
    err = 0.0
    for label, launch in held:
        stop, e, _early = hold_tiles(lt, name, launch, tris,
                                     f"phase 2 {name} {label} launch")
        err = max(err, e)
        cand = launch[0]
        log(f"phase 2 {name} {label} launch: {live_note(cand, tris)}; "
            f"the guard let {bounds.rounds_run(cand, tris, stop)} of "
            f"{bounds.rounds_run(cand, tris)} live list-rounds run")
        if launch is timed:
            timed_stop = stop

    from sycl_ray_tracing_tpu_torch.probes import frame

    cand, ctn, rays = timed
    ms = cuda_ms(lambda: getattr(lt, name)(cand, ctn, rays, tris), 20)
    dev_ms = frame.kernel_ms(lambda: getattr(lt, name)(cand, ctn, rays, tris),
                             f"{name}_kernel")
    plain_ms = cuda_ms(lambda: getattr(lt, f"{name}_plain")(
        cand, ctn, rays, tris), 3)
    work = getattr(bounds, f"{name}_work")
    entry = kernel_entry(name, LISTTRACE_CU, replaces, ms, plain_ms,
                         work(cand, rays, tris, timed_stop), err, bounds)
    all_ms, all_by = bounds.bound(*work(cand, rays, tris))
    log(f"phase 2 {name} timed launch: {ms:.4f} ms kernel back to back "
        f"(CUDA events), {dev_ms:.4f} ms device time per launch "
        f"(profiler), vs {plain_ms:.4f} ms plain; bound on the rounds run "
        f"{entry['bound_ms']:.4f} ms by {entry['bound_by']} "
        f"({entry['ops']:.4g} operations, {entry['bytes']:.4g} bytes), "
        f"bound on all live rounds {all_ms:.4f} ms by {all_by} ({card})")
    check_info(lt, name, f"phase 2 {name}")
    return entry


def host_path(lt, launch, tris, card):
    """Host microseconds per call of list_tiles at one launch, and of its
    parts: the argument checks, the output allocation, and the kernel
    wrapper without the checks (allocation, ctypes launch, counter).  No
    synchronise between calls: the card runs each launch faster than the
    host issues the next."""
    import torch

    cand, ctn, rays = launch

    def us(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return t

    total = us(lambda: lt.list_tiles(cand, ctn, rays, tris))
    checks = us(lambda: lt._check_tile_args(cand, rays, tris, cand.shape[0],
                                            ctn))
    alloc = us(lambda: lt._list_outputs(cand.shape[0], cand.device))
    cuda = us(lambda: lt.list_tiles_cuda(cand, ctn, rays, tris))
    log(f"phase 2 list_tiles host path at the largest escalation launch: "
        f"{total:.1f} us per call of the wrapper (host clock), of which "
        f"argument checks {checks:.1f} us; list_tiles_cuda {cuda:.1f} us, "
        f"of which the three output allocations {alloc:.1f} us ({card})")


def guard_phase(lt, bounds, timer, name) -> tuple:
    """The tail guard in the kernel: every launch of ``name`` in the timed
    frame where the guard stopped a list is run again by the kernel and
    by the plain version, (at, ar, stop) bit-identical, and the frame's
    own stop must equal the plain one.  Returns (max |dt|, launches
    held)."""
    import torch

    err, held, cut, live = 0.0, 0, 0, 0
    for launch_name, _s, _e, _host, args in timer.launches:
        if launch_name != name:
            continue
        cand, ctn, rays, tris, stop = args
        live += bounds.rounds_run(cand, tris)
        cut += bounds.rounds_run(cand, tris) - bounds.rounds_run(cand, tris,
                                                                 stop)
        if not bool((stop < lt.list_counts(cand, tris.shape[0] - 1)).any()):
            continue
        want, e, _early = hold_tiles(
            lt, name, (cand, ctn, rays), tris,
            f"phase 3 guard: {name} launch {held + 1} of the frame where "
            "it fired")
        if not torch.equal(stop, want):
            raise RuntimeError(f"the frame's {name} stop differs from the "
                               "plain version's")
        err = max(err, e)
        held += 1
    log(f"phase 3 guard: it fired in {held} {name} launches of the frame "
        f"and cut {cut} of {live} live list-rounds; each of those launches "
        f"bit-identical to the plain version")
    return err, held


def kernel_entry(name, source, replaces, ms, plain_ms, work, err, bounds):
    ops, nbytes = work
    bound_ms, bound_by = bounds.bound(ops, nbytes)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                ops=ops, bytes=nbytes)


def big_frame_phase(kernels, card, cam, cfg, key, tile_key, px0, py0):
    """Phase 6: the 870k-triangle frame through the supercluster build
    (see the module docstring).  Adds each list kernel's per-frame numbers
    to its kernels entry."""
    import torch

    from sycl_ray_tracing_tpu_torch.models import pathtracer as pt
    from sycl_ray_tracing_tpu_torch.ops import cluster as pc
    from sycl_ray_tracing_tpu_torch.ops.intersect import (
        BIG_T,
        intersect_triangles,
    )
    from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as lt
    from sycl_ray_tracing_tpu_torch.probes import bounds, frame
    from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_scene

    t6 = time.perf_counter()
    scene = dragon_scene(N_TRIS_BIG, with_sky=True, build_accel=False,
                         device=px0.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scene = scene.build_acceleration()
    torch.cuda.synchronize()
    sah_s = time.perf_counter() - t0
    cs = scene.clusters
    k2, k1 = cs.num_clusters, cs.num_superclusters
    tables = [getattr(cs, f) for f in pc.CLUSTER_FIELDS] + [scene.slot_packed]
    nbytes = sum(t.numel() * t.element_size() for t in tables)
    maxc = lt.DEFAULT_MAXC_SHARE
    maxs = max(lt.HIER_MAXS, maxc // 3)
    cols = maxs * pc.S_CLUSTER
    bits_h, bits_d = pc._id_bits(cols), pc._id_bits(k2)
    log(f"phase 6 scene: {scene.num_triangles} triangles, K2 {k2} clusters, "
        f"K1 {k1} superclusters; SAH build and tables {sah_s:.1f} s wall; "
        f"cluster and slot tables {nbytes / 2**20:.1f} MiB on the card; "
        f"main passes: supercluster build, maxs {maxs}, C {cols} columns "
        f"({bits_h} id bits); escalation: dense over {k2} ({bits_d} id bits)")
    if k2 <= 2 * maxs * pc.S_CLUSTER:
        raise RuntimeError("the 870k scene does not take the supercluster "
                           "build")

    # the bounce-1 fused launch's hierarchical lists, kernels vs plain
    with Capture(lt) as cap:
        pt.render_rays(scene, cam, px0, py0, W, H, tile_key, 1, 1,
                       estimator="shared")
    torch.cuda.synchronize()
    tris = lt._tiles_with_dummy(cs)
    bounce = max(cap.tiles["block_tiles"], key=lambda c: c[-1].shape[0])
    cand_k, ctn, rays = bounce
    poisoned = ctn[:, -1] < 0
    chunks = len(list(pc._row_chunks(rays.shape[0], cols, lt.RB_SHARE)))
    log(f"phase 6 bounce-1 fused launch: {rays.shape[0]} rays, "
        f"{live_note(cand_k, tris)}; {int(poisoned.sum())} of "
        f"{cand_k.shape[0]} lists poisoned (SC overflow); the build ran in "
        f"{chunks} row chunks")
    _stop, err, _early = hold_tiles(lt, "block_tiles", bounce, tris,
                                    "phase 6 block_tiles bounce-1 launch "
                                    "(hierarchical lists)")
    if not bool(poisoned.any()):
        small = 4
        c2, t2, _of, _cov = pc.candidate_clusters_hier(
            cs, rays[:, 0:3], rays[:, 3:6], rays[:, 6], maxc, small,
            lt.RB_SHARE, grouped=True, ray_cert=True)
        n2 = int((t2[:, -1] < 0).sum())
        if not n2:
            raise RuntimeError(f"maxs {small} poisoned no list either")
        launch = (torch.where(c2 >= 0, c2, k2).to(torch.int32).contiguous(),
                  t2.contiguous(), rays)
        _s, e2, _e = hold_tiles(lt, "block_tiles", launch, tris,
                                f"phase 6 block_tiles at maxs {small} "
                                f"({n2} poisoned lists)")
        err = max(err, e2)
    o, d, tl, mc, ah, kw = cap.runs[1]
    outs = [lt._run(cs, o, d, tl, mc, ah, **dict(kw, impl=impl))
            for impl in (None, "plain")]
    same = all(torch.equal(a, b) for a, b in zip(*outs))
    log(f"phase 6 _run bounce 1 fused: rays {o.shape[0]}, (t, packed, "
        f"resolved, overflow) identical={same}, overflow={bool(outs[0][3])}")
    if not same:
        raise RuntimeError("_run at 870k differs between kernels and plain "
                           "versions")

    # the same rays' hierarchical lists against the dense build
    dc, dt, _dof, _dcov = pc.candidate_clusters_grouped(
        cs, rays[:, 0:3], rays[:, 3:6], rays[:, 6], maxc, lt.RB_SHARE)
    hc = torch.where(cand_k != k2, cand_k, -1)
    ok = ~poisoned
    counts = torch.equal((hc >= 0).sum(1)[ok], (dc >= 0).sum(1)[ok])
    fits = ok & (dc[:, -1] < 0)
    sets = torch.equal(hc[fits].sort(1).values, dc[fits].sort(1).values)
    live = (dc >= 0) & ok[:, None]
    quantum = 2.0 ** (max(bits_h, bits_d) - 23)
    near = bool(((ctn - dt).abs()[live]
                 <= quantum * torch.maximum(ctn, dt)[live]).all())
    same_rows = int((hc == dc).all(1)[ok].sum())
    log(f"phase 6 hierarchical vs dense lists on {int(ok.sum())} lists "
        f"without SC overflow: live counts equal={counts}; the same "
        f"candidates on the {int(fits.sum())} lists that fit={sets}; "
        f"entry-t within 2^{max(bits_h, bits_d) - 23} relative={near}; "
        f"{same_rows} lists identical slot for slot (the others differ "
        f"in order only among entry-t equal on the coarser key grid, or at "
        f"a full list's cut)")
    if not (counts and sets and near):
        raise RuntimeError("the hierarchical lists disagree with the dense "
                           "build")

    # certified closest hits against the brute-force oracle
    o, d = cap.runs[0][0][::256], cap.runs[0][1][::256]
    t_l, prim_l, _of, res = lt.closest_hit(cs, o, d, with_resolved=True)
    refs = [intersect_triangles(o[i:i + 32], d[i:i + 32], scene.triangles)
            for i in range(0, o.shape[0], 32)]
    ref_hit = torch.cat([r.hit for r in refs])
    ref_prim = torch.cat([r.prim for r in refs]).to(prim_l.dtype)
    ref_t = torch.cat([r.t for r in refs])
    hr = ref_hit & res
    agree = (torch.equal((prim_l >= 0)[res], ref_hit[res])
             and torch.equal(prim_l[hr], ref_prim[hr])
             and bool(((t_l - ref_t).abs()[hr] <= 1e-5).all()))
    log(f"phase 6 oracle: {o.shape[0]} primary rays, {int(res.sum())} "
        f"certified, {int(ref_hit.sum())} hits, agree={agree}")
    if not agree:
        raise RuntimeError("the 870k list tracer disagrees with the oracle")

    # the frame: a first one with every _run call's uncertified rays
    # counted, then one timed warm with the launch counters reset before
    t0 = time.perf_counter()
    with RunWatch(lt) as watch:
        pt.render(scene, cam, cfg, key, with_aux=True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    left = [(i, b, n, k) for i, (b, n, k) in enumerate(watch.calls) if k]
    lt.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img, aux = pt.render(scene, cam, cfg, key, with_aux=True)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t0
    launches = dict(lt.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(img).all())
    mean = float(img.mean())
    log(f"phase 6 frame: {tuple(img.shape)} finite={finite} mean={mean:.6f} "
        f"overflow={aux['overflow']} launches={launches}; {len(watch.calls)} "
        f"list-tracer passes, uncertified live rays left in "
        f"{len(left)} of them {left[:8]}")
    log(f"phase 6 frame time {frame_s * 1e3:.1f} ms warm ({first_s * 1e3:.1f} "
        f"ms for the counted frame before it), "
        f"{W * H * BOUNCES / frame_s / 1e6:.3f} Mrays/s ({W}x{H}x1spp "
        f"x{BOUNCES} bounces / frame time); peak device memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated), card {card}")
    if not finite or mean <= 1e-4 or aux["overflow"] \
            or tuple(img.shape) != (H, W, 3):
        raise RuntimeError("the 870k frame failed its checks")
    if min(launches.values()) < 1:
        raise RuntimeError(f"a kernel of the 870k path never launched: "
                           f"{launches}")
    if peak > PEAK_LIMIT:
        raise RuntimeError(f"the 870k frame peaked at {peak} bytes")

    # one more frame, every list-kernel launch timed and bounded, its
    # candidate builds recorded and replayed under the profiler
    with LaunchTimer(lt) as timer:
        builds = frame.build_ms(lambda: pt.render(scene, cam, cfg, key))
    per_frame = timer.per_kernel(bounds)
    blocks = [a for n, _s, _e, _h, a in timer.launches if n == "block_tiles"]
    esc = [a for n, _s, _e, _h, a in timer.launches if n == "list_tiles"]
    n_poisoned = [int((a[1][:, -1] < 0).sum()) for a in blocks]
    n_chunks = [len(list(pc._row_chunks(a[2].shape[0], cols, lt.RB_SHARE)))
                for a in blocks]
    redo = [int((a[2][:, 6] > -BIG_T).sum()) for a in esc]
    log(f"phase 6 poisoned (SC-overflow) lists per block_tiles launch: "
        f"{n_poisoned} (sum {sum(n_poisoned)} of "
        f"{sum(a[0].shape[0] for a in blocks)} lists); the build's row "
        f"chunks per launch: {n_chunks} (sum {sum(n_chunks)})")
    log(f"phase 6 escalation rays per list_tiles launch: {redo} (sum "
        f"{sum(redo)})")
    cand, ctn_e, rays_e, tris_e, stop = max(esc, key=lambda a: a[0].shape[0])
    want, e3, _early = hold_tiles(lt, "list_tiles", (cand, ctn_e, rays_e),
                                  tris_e, "phase 6 list_tiles largest "
                                  "escalation launch of the frame")
    if not torch.equal(stop, want):
        raise RuntimeError("the frame's list_tiles stop differs from the "
                           "plain version's")

    prof = frame.profile(lambda: pt.render(scene, cam, cfg, key))
    for entry in kernels[:2]:
        name = entry["name"]
        n, ms, h_ms, b_ms = per_frame[name]
        pn, dev_ms, top = prof["kernels"][f"{name}_kernel"]
        log(f"phase 6 per frame {name}: {n} launches, {ms:.4f} ms kernel "
            f"(CUDA events around each launch), {dev_ms:.4f} ms device "
            f"time ({pn} launches, the longest {top:.4f} ms; profiler), "
            f"{b_ms:.4f} ms sum of per-launch bounds, {h_ms:.4f} ms on the "
            f"host clock inside the wrapper ({card})")
        entry["frame_870k"] = dict(launches=launches[name], ms=ms,
                                   device_ms=dev_ms, bound_ms=b_ms)
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   err if name == "block_tiles" else e3)
    for line in frame.report(prof, "phase 6 profiled 870k", card) + \
            frame.build_report(builds, "phase 6 candidate build", card):
        log(line)
    build_dev = sum(ms for _n, ms in builds.values())
    kern_dev = sum(prof["kernels"][k][1] for k in prof["kernels"])
    rest = prof["device_ms"] - build_dev - kern_dev
    log(f"phase 6 device time per frame: candidate builds {build_dev:.1f} "
        f"ms, list kernels {kern_dev:.1f} ms, everything else (RNG, "
        f"shading, sorts, reduction tails) {rest:.1f} ms of "
        f"{prof['device_ms']:.1f} ms; host wall "
        f"{prof['wall_ms']:.1f} ms under the profiler, {frame_s * 1e3:.1f} "
        f"ms without ({card})")
    log(f"phase 6 took {time.perf_counter() - t6:.1f} s, card {card}")


def grad_phase(kernels, card, scene, cam, cfg, key, tile_key, px0, py0,
               fwd_launches, fwd_rise):
    """Phase 7: the backward pass (see the module docstring).  Adds each
    list kernel's launches in the fwd+bwd frame to its kernels entry."""
    import dataclasses

    import torch

    from sycl_ray_tracing_tpu_torch.models import pathtracer as pt
    from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as lt
    from sycl_ray_tracing_tpu_torch.probes import frame

    t7 = time.perf_counter()
    mats = scene.materials

    def with_diffuse():
        """(scene, diffuse leaf): the scene's diffuse as a new leaf that
        requires grad."""
        d = mats.diffuse.detach().clone().requires_grad_()
        return scene.with_materials(dataclasses.replace(mats, diffuse=d)), d

    def fwd(remat=True):
        s, d = with_diffuse()
        img, aux = pt.render(s, cam, dataclasses.replace(cfg, remat=remat),
                             key, with_aux=True)
        return img, aux, d

    def fwd_bwd(remat=True):
        """(frame, aux, grad, memory): memory in GiB held before the
        frame, the forward's peak, held after the forward (the graph and
        the frame), the backward's peak (max_memory_allocated)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mem = [torch.cuda.memory_allocated()]
        img, aux, d = fwd(remat)
        torch.cuda.synchronize()
        mem += [torch.cuda.max_memory_allocated(),
                torch.cuda.memory_allocated()]
        torch.cuda.reset_peak_memory_stats()
        img.mean().backward()
        torch.cuda.synchronize()
        mem.append(torch.cuda.max_memory_allocated())
        return img.detach(), aux, d.grad, [m / 2**30 for m in mem]

    def mem_note(mem):
        before, fpeak, held, bpeak = mem
        peak = max(fpeak, bpeak)
        return (f"peak {peak:.2f} GiB, {peak - before:.2f} above the "
                f"{before:.2f} held before the frame (forward peak "
                f"{fpeak:.2f}, held after the forward {held:.2f}, backward "
                f"peak {bpeak:.2f})")

    # remat=False first: it keeps every bounce's graph until backward()
    _img, _aux, g_keep, keep_mem = fwd_bwd(remat=False)
    del _img, _aux
    lt.reset_launch_counts()
    t0 = time.perf_counter()
    img, aux, grad, mem = fwd_bwd()
    step_s = time.perf_counter() - t0
    launches = dict(lt.LAUNCHES)
    finite = bool(torch.isfinite(img).all() and torch.isfinite(grad).all())
    gsum = float(grad.sum())
    log(f"phase 7 fwd+bwd frame (value and grad of the mean w.r.t. "
        f"materials.diffuse, remat=True): {step_s * 1e3:.1f} ms warm, "
        f"{W * H * BOUNCES / step_s / 1e6:.3f} Mrays/s ({W}x{H}x1spp "
        f"x{BOUNCES} bounces / fwd+bwd time); mean {float(img.mean()):.6f} "
        f"overflow={aux['overflow']} finite={finite}; grad sum {gsum:.6g}, "
        f"grad {grad.tolist()}; launches {launches} (forward frame "
        f"{fwd_launches}) ({card})")
    log(f"phase 7 device memory (max_memory_allocated): fwd+bwd with remat "
        f"{mem_note(mem)}; with remat=False {mem_note(keep_mem)}; the "
        f"forward-only frame (phase 3) peaked {fwd_rise:.2f} GiB above what "
        f"was held before it ({card})")
    if not finite or aux["overflow"] or gsum == 0.0 \
            or tuple(img.shape) != (H, W, 3):
        raise RuntimeError("the fwd+bwd frame failed its checks")
    if launches != fwd_launches:
        raise RuntimeError(f"the fwd+bwd frame launched {launches}, the "
                           f"forward frame {fwd_launches}")
    err = max_abs_err(grad, g_keep)
    top = float(g_keep.abs().max())
    log(f"phase 7 gradient with remat against remat=False: max |d| "
        f"{err:.3g} ({err / top:.3g} of max |g|; limit {GRAD_RTOL})")
    if err > GRAD_RTOL * top:
        raise RuntimeError("remat changed the gradient")
    for entry in kernels[:2]:
        entry["frame_fwd_bwd"] = dict(launches=launches[entry["name"]])

    # one more frame in two profiler windows: forward, then backward
    held = []
    prof_f = frame.profile(lambda: held.append(fwd()))
    loss = held[0][0].mean()
    prof_b = frame.profile(loss.backward)
    del held, loss
    for line in frame.report(prof_b, "phase 7 profiled backward", card):
        log(line)
    dev = prof_f["device_ms"] + prof_b["device_ms"]
    wall = prof_f["wall_ms"] + prof_b["wall_ms"]
    log(f"phase 7 profiled fwd+bwd frame: forward {prof_f['device_ms']:.1f} "
        f"ms device in {prof_f['wall_ms']:.1f} ms wall, backward "
        f"{prof_b['device_ms']:.1f} ms device in {prof_b['wall_ms']:.1f} ms "
        f"wall; device busy {dev / wall:.1%} of the fwd+bwd frame ({card})")
    if any(n for n, _ms, _top in prof_b["kernels"].values()):
        raise RuntimeError("the backward pass launched a list kernel")

    # one 8-bounce tile: kernels against plain versions, then AD against a
    # central finite difference of the ground's red diffuse
    def tile(impl=None):
        s, d = with_diffuse()
        rad = pt.render_rays(s, cam, px0, py0, W, H, tile_key, 1, BOUNCES,
                             estimator="shared", impl=impl)
        rad.mean().backward()
        return rad.detach(), d.grad

    rad_k, g_k = tile()
    rad_p, g_p = tile("plain")
    same = torch.equal(rad_k, rad_p)
    err = max_abs_err(g_k, g_p)
    top = float(g_p.abs().max())
    log(f"phase 7 tile: {rad_k.shape[0]} rays x {BOUNCES} bounces, forward "
        f"radiance bit-identical between kernels and plain versions={same}; "
        f"gradients max |d| {err:.3g} ({err / top:.3g} of max |g|; limit "
        f"{GRAD_RTOL})")
    if not same or err > GRAD_RTOL * top:
        raise RuntimeError("the tile's fwd+bwd differs between kernels and "
                           "plain versions")
    eps = 1e-2

    def tile_mean(delta):
        d = mats.diffuse.clone()
        d[2, 0] += delta
        s = scene.with_materials(dataclasses.replace(mats, diffuse=d))
        with torch.no_grad():
            return float(pt.render_rays(s, cam, px0, py0, W, H, tile_key, 1,
                                        BOUNCES, estimator="shared")
                         .double().mean())

    fd = (tile_mean(eps) - tile_mean(-eps)) / (2 * eps)
    ad = float(g_k[2, 0])
    log(f"phase 7 tile: d mean / d diffuse[2, 0] by AD {ad:.6g}, by central "
        f"difference (eps {eps}) {fd:.6g}; limit 2e-3 + 5%")
    if not abs(ad - fd) <= 2e-3 + 0.05 * abs(fd):
        raise RuntimeError("AD disagrees with the finite difference")
    log(f"phase 7 took {time.perf_counter() - t7:.1f} s, card {card}")


def parity_phase(card, scene, cam, key, tile_key, px0, py0, shared_mean):
    """Phase 8: the parity estimator and every other backend (see the
    module docstring).  Returns {kernel name: {launches, ms, device_ms,
    bound_ms}} of the parity flagship frame."""
    import dataclasses

    import torch

    from sycl_ray_tracing_tpu_torch.models import pathtracer as pt
    from sycl_ray_tracing_tpu_torch.models.scene import add_sphere
    from sycl_ray_tracing_tpu_torch.ops import bvh as bvh_ops
    from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as lt
    from sycl_ray_tracing_tpu_torch.probes import bounds, frame
    from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
    from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_scene

    t8 = time.perf_counter()
    dev = px0.device

    def timed_render(s, cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, aux = pt.render(s, cam, cfg, key, with_aux=True)
        torch.cuda.synchronize()
        return img, aux, time.perf_counter() - t0

    def tile_pair(s, estimator, label, px=px0, py=py0):
        """One 32768-ray tile through the kernels and the plain versions:
        the radiance must be bit-identical."""
        out = [pt.render_rays(s, cam, px, py, W, H, tile_key, 1, BOUNCES,
                              backend="list", estimator=estimator,
                              with_aux=True, impl=impl)
               for impl in (None, "plain")]
        torch.cuda.synchronize()
        same = torch.equal(out[0][0], out[1][0])
        log(f"phase 8 {label}: {out[0][0].shape[0]} rays x {BOUNCES} "
            f"bounces, radiance bit-identical between kernels and plain "
            f"versions={same}, overflow {bool(out[0][1]['overflow'])}/"
            f"{bool(out[1][1]['overflow'])}, mean "
            f"{float(out[0][0].mean()):.6f}")
        if not same:
            raise RuntimeError(f"{label}: radiance differs between kernels "
                               "and plain versions")

    # (a) the parity flagship frame
    cfg = RenderConfig(W, H, samples=1, bounces=BOUNCES, intersect="list",
                       estimator="parity", tile_rays=TILE)
    _img, _aux, cold = timed_render(scene, cfg)
    del _img, _aux
    lt.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    img, aux, frame_s = timed_render(scene, cfg)
    peak = torch.cuda.max_memory_allocated()
    launches = dict(lt.LAUNCHES)
    mean = float(img.mean())
    finite = bool(torch.isfinite(img).all())
    log(f"phase 8 parity frame: {tuple(img.shape)} finite={finite} "
        f"mean={mean:.6f} (phase 3's shared frame: {shared_mean:.6f}) "
        f"overflow={aux['overflow']} launches={launches}")
    log(f"phase 8 parity frame time {frame_s * 1e3:.1f} ms warm "
        f"({cold * 1e3:.1f} ms first), "
        f"{W * H * BOUNCES / frame_s / 1e6:.3f} Mrays/s ({W}x{H}x1spp "
        f"x{BOUNCES} bounces / frame time), peak device memory "
        f"{peak / 2**30:.2f} GiB ({before / 2**30:.2f} GiB held before the "
        f"frame), card {card}")
    if not finite or aux["overflow"] or tuple(img.shape) != (H, W, 3):
        raise RuntimeError("the parity frame failed its checks")
    if min(launches.values()) < 1:
        raise RuntimeError(f"a list kernel never launched in the parity "
                           f"frame: {launches}")
    del img
    # one more frame with every list-kernel launch timed and bounded, and
    # one under the profiler
    with LaunchTimer(lt) as timer:
        pt.render(scene, cam, cfg, key)
    per_frame = timer.per_kernel(bounds)
    prof = frame.profile(lambda: pt.render(scene, cam, cfg, key))
    parity = {}
    for name, (n, ms, h_ms, b_ms) in per_frame.items():
        pn, dev_ms, top = prof["kernels"][f"{name}_kernel"]
        log(f"phase 8 parity per frame {name}: {n} launches, {ms:.4f} ms "
            f"kernel (CUDA events around each launch), {dev_ms:.4f} ms "
            f"device time ({pn} launches, the longest {top:.4f} ms; "
            f"profiler), {b_ms:.4f} ms sum of per-launch bounds, "
            f"{h_ms:.4f} ms on the host clock inside the wrapper ({card})")
        parity[name] = dict(launches=launches[name], ms=ms, device_ms=dev_ms,
                            bound_ms=b_ms)
    for line in frame.report(prof, "phase 8 profiled parity", card):
        log(line)

    # (b) a parity tile, kernels against plain versions
    tile_pair(scene, "parity", "parity tile")

    # (c) spheres at full width, through the fused list path; the tile
    # that holds them starts at row 9/16 of the image
    sph = scene
    for center, radius, mat in SPHERES:
        sph = add_sphere(sph, center, radius, **mat)
    first = H * 9 // 16 * W
    pix = torch.arange(first, first + TILE, device=dev)
    px_s = (pix % W).to(torch.float32)
    py_s = torch.div(pix, W, rounding_mode="floor").to(torch.float32)
    o, d = cam.generate_rays(px_s + 0.5, py_s + 0.5, W, H)
    prim = pt.intersect_scene(sph, o, d, "list").prim
    on_spheres = int((prim >= sph.num_triangles).sum())
    cfg_s = RenderConfig(W, H, samples=1, bounces=BOUNCES, intersect="list",
                         estimator="shared", tile_rays=TILE)
    timed_render(sph, cfg_s)
    img, aux, frame_s = timed_render(sph, cfg_s)
    finite = bool(torch.isfinite(img).all())
    log(f"phase 8 spheres: {sph.num_spheres} spheres, {on_spheres} of the "
        f"{o.shape[0]} primary rays of the tile from row {first // W} end "
        f"on one; frame "
        f"{frame_s * 1e3:.1f} ms warm, mean {float(img.mean()):.6f} "
        f"finite={finite} overflow={aux['overflow']} ({card})")
    if not finite or aux["overflow"] or on_spheres == 0:
        raise RuntimeError("the sphere frame failed its checks")
    del img
    tile_pair(sph, "shared", f"sphere tile (from row {first // W})", px_s,
              py_s)

    # (d) more than 2048 materials: the unfused path against the fused
    # one; the fused loop runs uncompacted so both give each ray the same
    # lanes (and with them the same draws)
    m = scene.materials
    padded = scene.with_materials(dataclasses.replace(m, **{
        f: torch.cat([x, x[:1].repeat(2049 - m.count,
                                      *([1] * (x.dim() - 1)))])
        for f, x in vars(m).items()}))
    old_min_b = pt.COMPACT_MIN_B
    pt.COMPACT_MIN_B = 1 << 30
    try:
        rads = [pt.render_rays(s, cam, px0, py0, W, H, tile_key, 1, BOUNCES,
                               backend="list", estimator="shared")
                for s in (scene, padded)]
    finally:
        pt.COMPACT_MIN_B = old_min_b
    close = torch.isclose(rads[1], rads[0], rtol=1e-3, atol=1e-3).all(-1)
    share = float(close.float().mean())
    m0, m1 = float(rads[0].mean()), float(rads[1].mean())
    log(f"phase 8 unfused tile ({padded.materials.count} materials) against "
        f"the fused one: {share:.4%} of rays within 1e-3, means {m1:.6f} / "
        f"{m0:.6f}")
    if share < 0.99 or abs(m1 - m0) > 0.01 * abs(m0):
        raise RuntimeError("the unfused path disagrees with the fused one")

    # (e) the backends against each other on a small scene
    small = dragon_scene(SMALL_TRIS, with_sky=True, build_accel=False,
                         device=dev)
    for center, radius, mat in SPHERES:
        small = add_sphere(small, center, radius, **mat)
    t0 = time.perf_counter()
    small = small.build_acceleration(num_rays_hint=TILE)
    small = small.with_bvh(bvh_ops.build_bvh(
        small.triangles.cpu().numpy(), device=dev))
    log(f"phase 8 backends: {small.num_triangles} triangles, "
        f"{small.num_spheres} spheres, {small.clusters.num_clusters} "
        f"clusters, pair budgets {small.clusters.p1_budget}/"
        f"{small.clusters.p2_budget}, SAH BVH of {small.bvh.num_nodes} "
        f"nodes; built in {time.perf_counter() - t0:.1f} s")
    for est in ("shared", "parity"):
        imgs = {}
        for be in ("brute", "list", "cluster", "bvh"):
            cfg_b = RenderConfig(SMALL_W, SMALL_W, samples=SMALL_SPP,
                                 bounces=SMALL_BOUNCES, intersect=be,
                                 estimator=est, tile_rays=TILE)
            bvh_ops.reset_walk_steps()
            img, aux, frame_s = timed_render(small, cfg_b)
            steps = (f", BVH lockstep steps {dict(bvh_ops.WALK_STEPS)}"
                     if be == "bvh" else "")
            log(f"phase 8 backends {est} {be}: {frame_s * 1e3:.1f} ms (first "
                f"call), mean {float(img.mean()):.6f}, overflow="
                f"{aux['overflow']}{steps} ({card})")
            if aux["overflow"] or not bool(torch.isfinite(img).all()):
                raise RuntimeError(f"backend {be} ({est}) failed its checks")
            imgs[be] = img
        for be in ("list", "cluster", "bvh"):
            bad = ~torch.isclose(imgs[be], imgs["brute"], rtol=2e-4,
                                 atol=1e-5)
            log(f"phase 8 backends {est} {be} against brute: {int(bad.sum())}"
                f" of {bad.numel()} values outside rtol 2e-4 / atol 1e-5, "
                f"max |d| {max_abs_err(imgs[be], imgs['brute']):.3g}")
            if bool(bad.any()):
                raise RuntimeError(f"backend {be} ({est}) disagrees with "
                                   "brute force")
    log(f"phase 8 took {time.perf_counter() - t8:.1f} s, card {card}")
    return parity


def cli_phase(card, scene, shared_mean):
    """Phase 9: the CLI, checkpoint/resume, the overflow regrow, the
    trainer and render_sharded (see the module docstring).  Returns
    {kernel name: {launches, ms, device_ms, bound_ms}} of the CLI frame."""
    import contextlib
    import io
    import socket
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from sycl_ray_tracing_tpu_torch import main as cli
    from sycl_ray_tracing_tpu_torch import train
    from sycl_ray_tracing_tpu_torch.models import scene as scene_mod
    from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
    from sycl_ray_tracing_tpu_torch.models.progressive import (
        ProgressiveRenderer,
        ProgressiveState,
    )
    from sycl_ray_tracing_tpu_torch.ops import rng
    from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as lt
    from sycl_ray_tracing_tpu_torch.parallel import distributed
    from sycl_ray_tracing_tpu_torch.parallel.mesh import make_mesh
    from sycl_ray_tracing_tpu_torch.parallel.render import render_sharded
    from sycl_ray_tracing_tpu_torch.probes import bounds, frame
    from sycl_ray_tracing_tpu_torch.utils import hdr as hdr_mod
    from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig, parse_cli
    from sycl_ray_tracing_tpu_torch.utils.image_io import read_image_float
    from sycl_ray_tracing_tpu_torch.utils.obj_loader import (
        load_scene,
        parse_obj,
    )
    from sycl_ray_tracing_tpu_torch.utils.procedural import (
        dragon_scene,
        procedural_sky,
    )

    t9 = time.perf_counter()
    dev = scene.device
    phase9 = {"block_tiles": {}, "list_tiles": {}}

    def rgbe_close(a, b) -> bool:
        """Equal to RGBE precision: each channel within 1/128 of its
        pixel's largest channel."""
        a, b = np.asarray(a), np.asarray(b)
        return bool((np.abs(a - b)
                     <= np.maximum(a, b).max(axis=-1, keepdims=True) / 128
                     + 1e-30).all())

    def run_cli(argv):
        """The CLI in-process, its stdout kept; returns (code, lines, the
        HDR image it wrote)."""
        wrote = []
        orig = hdr_mod.write_hdr

        def keep(path, image):
            wrote.append(np.array(image, np.float32))
            orig(path, image)

        hdr_mod.write_hdr = keep
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                code = cli.main(argv, device=dev)
        finally:
            hdr_mod.write_hdr = orig
        return code, out.getvalue().splitlines(), (wrote[-1] if wrote
                                                   else None)

    def warnings_of(lines):
        return [ln for ln in lines if ln.startswith(("WARNING", "ERROR"))]

    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        # (a) I/O at full size: the 200k scene as OBJ + MTL, the sky as
        # .hdr, written upside down so that the CLI's flipped read gives
        # the scene's own sky
        big = dragon_scene(N_TRIS, with_sky=False, build_accel=False,
                           device="cpu")
        sky = procedural_sky(*SKY_RES)
        t0 = time.perf_counter()
        write_obj("dragon.obj", big.triangles, big.material_indices,
                  big.materials)
        hdr_mod.write_hdr("sky.hdr", sky[::-1])
        write_s = time.perf_counter() - t0
        parsed = {}
        for native_parse in (True, False):
            t0 = time.perf_counter()
            parsed[native_parse] = parse_obj("dragon.obj",
                                             use_native=native_parse)
            parsed[f"{native_parse} ms"] = (time.perf_counter() - t0) * 1e3
        same = all(np.array_equal(getattr(parsed[True], f),
                                  getattr(parsed[False], f))
                   for f in ("triangles", "material_indices",
                             "emissive_indices", "emission", "diffuse",
                             "metalness", "roughness"))
        exact = np.array_equal(parsed[True].triangles,
                               big.triangles.numpy())
        sky_back = read_image_float("sky.hdr", flip_y=True)
        sky_ok = rgbe_close(sky_back, sky)
        log(f"phase 9 I/O: dragon.obj {os.path.getsize('dragon.obj') / 2**20:.1f}"
            f" MiB ({parsed[True].triangles.shape[0]} triangles) and "
            f"sky.hdr {sky.shape[1]}x{sky.shape[0]} written in "
            f"{write_s:.2f} s; parse {parsed['True ms']:.1f} ms native (C++), "
            f"{parsed['False ms']:.1f} ms Python; arrays equal={same}, "
            f"triangles equal to the scene's={exact}; the sky read back "
            f"equal to RGBE precision={sky_ok}")
        if not (same and exact and sky_ok):
            raise RuntimeError("phase 9 I/O round trip failed")
        del parsed, big

        # (b) the CLI frame at full width, launch counters reset just
        # before, its stdout kept
        base = ["dragon.obj", "--sky=sky.hdr", f"--w={W}", f"--h={H}",
                f"--bounces={BOUNCES}", "--camera=pbrt_dragon",
                "--intersect=list", "--estimator=shared"]
        argv = base + [f"--samples={CLI_SPP}"]
        lt.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        code, lines, img = run_cli(argv)
        cli_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = dict(lt.LAUNCHES)
        said = warnings_of(lines)
        files = {f: os.path.exists(f) for f in CLI_OUTPUTS}
        back = hdr_mod.read_hdr("RT_output.hdr")
        hdr_ok = img is not None and rgbe_close(back, img)
        # the CLI's last line: its RenderMetrics report
        t = json.loads(lines[-1]) if code == 0 else {}
        log(f"phase 9 CLI frame ({' '.join(argv)}): exit {code}, "
            f"{len(lines)} lines, regrow warnings {said}, outputs {files}, "
            f"RT_output.hdr equal to the rendered image to RGBE "
            f"precision={hdr_ok}, mean {float(img.mean()):.6f} (phase 3's "
            f"1-spp frame: {shared_mean:.6f}), launches={launches}")
        log(f"phase 9 CLI metrics: scene_load {t.get('time/scene_load')} s, "
            f"accel_build {t.get('time/accel_build')} s, render "
            f"{t.get('time/render')} s, {t.get('Mrays_per_s')} Mrays/s "
            f"({W}x{H}x{CLI_SPP}spp x{BOUNCES} bounces / render time); the "
            f"whole CLI call {cli_s:.2f} s, peak device memory "
            f"{peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held before), "
            f"card {card}")
        if code != 0 or said or not all(files.values()) or not hdr_ok \
                or not np.isfinite(img).all():
            raise RuntimeError("the CLI frame failed its checks")
        if min(launches.values()) < 1:
            raise RuntimeError(f"a list kernel never launched in the CLI "
                               f"frame: {launches}")
        del img, back
        # the same CLI frame again with every list-kernel launch timed
        # and bounded, and once more under the profiler
        with LaunchTimer(lt) as timer:
            run_cli(argv)
        per_frame = timer.per_kernel(bounds)
        prof = frame.profile(lambda: run_cli(argv))
        for name, (n, ms, h_ms, b_ms) in per_frame.items():
            pn, dev_ms, top = prof["kernels"][f"{name}_kernel"]
            log(f"phase 9 CLI frame {name}: {n} launches, {ms:.4f} ms "
                f"kernel (CUDA events around each launch), {dev_ms:.4f} ms "
                f"device time ({pn} launches, the longest {top:.4f} ms; "
                f"profiler), {b_ms:.4f} ms sum of per-launch bounds, "
                f"{h_ms:.4f} ms on the host clock inside the wrapper "
                f"({card})")
            phase9[name]["cli"] = dict(launches=launches[name], ms=ms,
                                       device_ms=dev_ms, bound_ms=b_ms)
        for line in frame.report(prof, "phase 9 profiled CLI call", card):
            log(line)

        # (c) checkpoint/resume: one batch saved by ProgressiveRenderer,
        # the CLI resumes it; against the same render without a break
        argv = base + ["--samples=2", "--checkpoint=ck.npz",
                       "--checkpoint-batch=1"]
        cfg = parse_cli(argv)[0]
        loaded = load_scene("dragon.obj", env_map_image=sky_back,
                            device=dev).build_acceleration(
                                num_rays_hint=cfg.tile_rays)
        cam = pbrt_dragon_camera(dev)
        first = ProgressiveRenderer(loaded, cam, cfg, samples_per_batch=1)
        first.step()
        first.state.save("ck.npz")
        code, lines, _ = run_cli(argv)
        resumed = ProgressiveState.load("ck.npz")
        whole = ProgressiveRenderer(loaded, cam, cfg, samples_per_batch=1)
        whole.run()
        diff = np.abs(resumed.image - whole.state.image)
        rel = float(diff.max() / np.abs(whole.state.image).max())
        identical = np.array_equal(resumed.image, whole.state.image)
        log(f"phase 9 resume: exit {code}, {[ln for ln in lines if 'resum' in ln]}"
            f", {resumed.samples_done} samples, overflow {resumed.overflow}"
            f"; against the render without a break: bit-identical="
            f"{identical}, max |d| {float(diff.max()):.3g} ({rel:.3g} of the "
            f"image's largest value)")
        if code != 0 or resumed.samples_done != 2 or resumed.overflow \
                or not identical:
            raise RuntimeError("the resumed render differs from the one "
                               "without a break")
        del loaded, first, whole

        # (d) the regrow: the 4k scene with clusters of candidate depth 1
        small = dragon_scene(SMALL_TRIS, with_sky=False, build_accel=False,
                             device="cpu")
        write_obj("small.obj", small.triangles, small.material_indices,
                  small.materials)
        build = scene_mod.Scene.build_acceleration

        def shallow(self, *a, **kw):
            s = build(self, *a, **kw)
            return s.with_clusters(s.clusters.with_list_maxc(REGROW_MAXC))

        scene_mod.Scene.build_acceleration = shallow
        try:
            code, lines, img = run_cli([
                "small.obj", "--sky=sky.hdr", f"--w={SMALL_W}",
                f"--h={SMALL_W}", f"--samples={SMALL_SPP}",
                f"--bounces={SMALL_BOUNCES}", "--camera=pbrt_dragon",
                "--intersect=list", "--estimator=shared"])
        finally:
            scene_mod.Scene.build_acceleration = build
        said = warnings_of(lines)
        log(f"phase 9 regrow: {small.num_triangles} triangles at list_maxc "
            f"{REGROW_MAXC}, {SMALL_W}x{SMALL_W}x{SMALL_SPP}spp x"
            f"{SMALL_BOUNCES} bounces: exit {code}, {said}")
        if code != 0 or not said or any(w.startswith("ERROR")
                                        for w in said):
            raise RuntimeError("the regrow did not end with every ray "
                               "certified")

    # (e) the trainer on a one-rank NCCL group; (f) render_sharded
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    rank_dev = distributed.initialize(f"127.0.0.1:{port}", 1, 0, device=dev)
    try:
        if rank_dev != dev:
            raise RuntimeError(f"the rank renders on {rank_dev}, the scene "
                               f"is on {dev}")
        mesh = make_mesh(1, 1)
        backend = dist.get_backend()
        cam = pbrt_dragon_camera(rank_dev)
        tcfg = RenderConfig(TRAIN_W, TRAIN_W, samples=TRAIN_SPP,
                            bounces=TRAIN_BOUNCES, tile_rays=None)
        # counters reset just before; every launch of step 0's forward
        # (target and guess) held against the plain versions; the
        # launches inside each backward counted
        lt.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with HoldEach(lt) as hold, BackwardWatch(lt, hold) as bwd:
            out = train.run(scene, cam, tcfg, TRAIN_STEPS, mesh,
                            log=lambda m: log(f"phase 9 train: {m}"))
            torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0 - hold.seconds) / TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated()
        launches = dict(lt.LAUNCHES)
        g = torch.cat([x.flatten() for x in out["grads"]])
        losses_ok = all(np.isfinite(x) for x in out["losses"])
        grads_ok = bool(torch.isfinite(g).all()) and bool((g != 0).any())
        log(f"phase 9 train ({backend} group of {dist.get_world_size()}, "
            f"mesh {mesh.shape}): {TRAIN_STEPS} steps at {TRAIN_W}x{TRAIN_W}"
            f"x{TRAIN_SPP}spp x{TRAIN_BOUNCES} bounces, {step_s:.3f} s a "
            f"step (the holds' {hold.seconds:.2f} s taken out), losses "
            f"{[round(x, 6) for x in out['losses']]}, last gradients finite "
            f"and nonzero={grads_ok}, diffuse error {out['err0_d']:.4f} -> "
            f"{out['err_d']:.4f}, roughness {out['err0_r']:.4f} -> "
            f"{out['err_r']:.4f}, peak device memory of steps 1-"
            f"{TRAIN_STEPS - 1} {peak / 2**30:.2f} GiB ({held / 2**30:.2f} "
            f"GiB held before the run), card {card}")
        log(f"phase 9 train launches: {launches} in the {TRAIN_STEPS} steps,"
            f" {bwd.launches} of them inside the {bwd.calls} backward calls; "
            f"step 0's forward held launch by launch (launches, rays of the "
            f"largest, max |dt|): {hold.held}, each bit-identical")
        if not (losses_ok and grads_ok and out["err_d"] < out["err0_d"]):
            raise RuntimeError("the trainer failed its checks")
        if min(launches.values()) < 1 or any(bwd.launches.values()) \
                or bwd.calls != TRAIN_STEPS \
                or hold.held["block_tiles"][0] < 1:
            raise RuntimeError(f"the trainer's launches: {launches}, in its "
                               f"backward {bwd.launches}, held {hold.held}")
        for name, n in launches.items():
            phase9[name]["train"] = dict(
                launches=n, backward_launches=bwd.launches[name],
                held=hold.held[name][0], largest_rays=hold.held[name][1],
                max_abs_err=hold.held[name][2])

        # render_sharded at 512x512 in one render_rays call: first with
        # the counters reset just before and every launch held against
        # the plain versions, then again for its time and peak memory,
        # which must give the same image bit for bit
        scfg = RenderConfig(W, H, samples=1, bounces=BOUNCES,
                            intersect="list", estimator="shared")
        lt.reset_launch_counts()
        with HoldEach(lt) as hold:
            sharded = render_sharded(scene, cam, scfg, rng.prng_key(SEED),
                                     mesh)
        launches = dict(lt.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        again = render_sharded(scene, cam, scfg, rng.prng_key(SEED), mesh)
        torch.cuda.synchronize()
        s_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        same = torch.equal(again, sharded)
        s_mean = float(sharded.mean())
        off = abs(s_mean - shared_mean) / shared_mean
        log(f"phase 9 render_sharded ({backend}, one rank): {W}x{H}x1spp "
            f"x{BOUNCES} bounces in one render_rays call ({W * H} rays), "
            f"launches {launches}, each held against the plain versions "
            f"(launches, rays of the largest, max |dt|): {hold.held}, "
            f"bit-identical, in {hold.seconds:.2f} s")
        log(f"phase 9 render_sharded again: {s_ms:.1f} ms, the same image "
            f"bit for bit={same}, mean {s_mean:.6f} against phase 3's "
            f"{shared_mean:.6f} ({off:.2%} apart; other RNG streams), peak "
            f"device memory {peak / 2**30:.2f} GiB ({before / 2**30:.2f} "
            f"GiB held before), limit {PEAK_LIMIT / 2**30:.0f} GiB, card "
            f"{card}")
        if not bool(torch.isfinite(sharded).all()) or off > 0.02 \
                or peak > PEAK_LIMIT or not same \
                or min(launches.values()) < 1:
            raise RuntimeError("render_sharded failed its checks")
        for name, n in launches.items():
            phase9[name]["sharded"] = dict(
                launches=n, held=hold.held[name][0],
                largest_rays=hold.held[name][1],
                max_abs_err=hold.held[name][2])
    finally:
        dist.destroy_process_group()
    log(f"phase 9 took {time.perf_counter() - t9:.1f} s, card {card}")
    return phase9


def examples_phase(card, dev) -> dict:
    """Phase 10: the five BASELINE configurations through their example
    modules (see the module docstring).  Returns {kernel name:
    {"examples": {config: {launches, renders, held, largest_rays,
    max_abs_err}}, "config4_frame": {launches, ms, device_ms,
    bound_ms}}}."""
    import contextlib
    import dataclasses
    import io
    import socket
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from sycl_ray_tracing_tpu_torch import train
    from sycl_ray_tracing_tpu_torch.examples import (
        _common,
        config1_spheres_direct,
        config2_obj_bvh,
        config3_dragon_mis,
        config4_env_tonemap,
        config5_inverse_sharded,
    )
    from sycl_ray_tracing_tpu_torch.models import pathtracer as pt
    from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as lt
    from sycl_ray_tracing_tpu_torch.probes import bounds, frame
    from sycl_ray_tracing_tpu_torch.utils.config import REFERENCE_ROOT_ENV

    t10 = time.perf_counter()
    found = {k: {"examples": {}} for k in ("block_tiles", "list_tiles")}

    @contextlib.contextmanager
    def env(**values):
        old = {k: os.environ.get(k) for k in values}
        os.environ.update(values)
        try:
            yield
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    with tempfile.TemporaryDirectory() as root, \
            env(**{REFERENCE_ROOT_ENV: root}):
        for name, standin in (("MIS.obj", mis_standin()),
                              ("cornell_pbr.obj", cornell_standin())):
            write_standin(os.path.join(root, "data/OBJs", name), standin)
            tris, mat, table = standin
            lit = np.any(np.asarray(table["emission"])[mat] > 0, axis=-1)
            log(f"phase 10 stand-in: data/OBJs/{name} is a procedural "
                f"stand-in ({tris.shape[0]} triangles, "
                f"{np.unique(mat[lit]).size} emissive materials): the "
                "reference's file is not in the repository")

        mis = config2_obj_bvh.find_data(config2_obj_bvh.MIS_OBJ)
        builds = (lambda: config1_spheres_direct.build(device=dev),
                  lambda: config2_obj_bvh.build(mis, device=dev),
                  lambda: config3_dragon_mis.build(device=dev),
                  lambda: config4_env_tonemap.build(device=dev))
        for build in builds:
            t0 = time.perf_counter()
            ex = build()
            build_s = time.perf_counter() - t0
            spp = EX_SPP.get(ex.name)
            if spp is not None:
                log(f"phase 10 {ex.name} cut: {ex.config.samples} -> {spp} "
                    "samples a pixel (the script's time)")
                ex = dataclasses.replace(ex, config=dataclasses.replace(
                    ex.config, samples=spp))
            c = ex.config
            with tempfile.TemporaryDirectory() as cwd, contextlib.chdir(cwd):
                # the counters reset just before; the first launch of each
                # list kernel held against its plain version as it happens
                lt.reset_launch_counts()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                out = io.StringIO()
                with HoldEach(lt, first=1) as hold, \
                        contextlib.redirect_stdout(out):
                    res = _common.run(ex)
                launches = dict(lt.LAUNCHES)
                peak = torch.cuda.max_memory_allocated()
                files = sorted(os.listdir("."))
            line = json.loads(out.getvalue().splitlines()[-1])
            renders = 1 + ex.runs
            img = res["image"]
            backend = pt._resolve_backend(ex.scene, c.intersect)
            sky = ex.scene.env_map and tuple(ex.scene.env_map.image.shape)
            log(f"phase 10 {ex.name}: {line}")
            log(f"phase 10 {ex.name}: {c.width}x{c.height}x{c.samples}spp x"
                f"{c.bounces} bounces, {ex.scene.num_triangles} triangles, "
                f"{ex.scene.num_spheres} spheres, sky {sky}, tiles "
                f"{c.tile_rays}, intersect {c.intersect} -> {backend}; "
                f"built in {build_s:.1f} s; overflow={res['overflow']}, "
                f"finite={bool(np.isfinite(img).all())}, mean "
                f"{float(img.mean()):.6f} (the example's bound: "
                f"{ex.min_mean}), wrote {files}; launches {launches} in "
                f"{renders} renders (warm-up + {ex.runs} timed), held "
                f"(launches, rays of the largest, max |dt|) {hold.held} in "
                f"{hold.seconds:.2f} s; peak device memory "
                f"{peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held "
                f"before), card {card}")
            if res["overflow"] or not np.isfinite(img).all() \
                    or peak > PEAK_LIMIT:
                raise RuntimeError(f"{ex.name} failed its checks")
            # the kernels this config's path reaches: none off the list
            # tracer; block_tiles on it; list_tiles only where a ray can
            # be left uncertified, i.e. where the scene has more clusters
            # than a block's shared list has slots
            reach = {k: backend == "list" for k in launches}
            reach["list_tiles"] &= ex.scene.clusters is not None and \
                ex.scene.clusters.num_clusters > lt.DEFAULT_MAXC_SHARE
            log(f"phase 10 {ex.name}: list kernels its path reaches: "
                f"{reach} ({backend}, "
                f"{ex.scene.clusters.num_clusters if ex.scene.clusters else 0}"
                f" clusters, {lt.DEFAULT_MAXC_SHARE} slots a block list)")
            for k, n in launches.items():
                if (n > 0) != reach[k] or (hold.held[k][0] > 0) != reach[k]:
                    raise RuntimeError(f"{ex.name}: {k} launched {n} times, "
                                       f"held {hold.held[k][0]}; reaches it:"
                                       f" {reach[k]}")
            for k, n in launches.items():
                found[k]["examples"][ex.name] = dict(
                    launches=n, renders=renders, held=hold.held[k][0],
                    largest_rays=hold.held[k][1],
                    max_abs_err=hold.held[k][2])
            if ex.name == "config4_env_tonemap":
                # its frame once more with every list-kernel launch timed
                # and bounded, and once under the profiler
                with LaunchTimer(lt) as timer:
                    _common._frame(ex.scene, ex.camera, ex.config, ex.key)
                per_frame = timer.per_kernel(bounds)
                del timer   # it holds every launch's inputs
                prof = frame.profile(lambda: _common._frame(
                    ex.scene, ex.camera, ex.config, ex.key))
                for k, (n, ms, h_ms, b_ms) in per_frame.items():
                    pn, dev_ms, top = prof["kernels"][f"{k}_kernel"]
                    log(f"phase 10 {ex.name} frame {k}: {n} launches, "
                        f"{ms:.4f} ms kernel (CUDA events around each "
                        f"launch), {dev_ms:.4f} ms device time ({pn} "
                        f"launches, the longest {top:.4f} ms; profiler), "
                        f"{b_ms:.4f} ms sum of per-launch bounds, {h_ms:.4f}"
                        f" ms on the host clock inside the wrapper ({card})")
                    found[k]["config4_frame"] = dict(
                        launches=n, ms=ms, device_ms=dev_ms, bound_ms=b_ms)
                for ln in frame.report(prof, f"phase 10 profiled {ex.name}",
                                       card):
                    log(ln)
            del ex, res, img

        # config 5: the trainer on a one-rank NCCL group, as torchrun
        # would start it
        args = [f"--steps={EX_STEPS}" if a.startswith("--steps=") else a
                for a in config5_inverse_sharded.train_args()]
        log(f"phase 10 config5_inverse_sharded cut: "
            f"{config5_inverse_sharded.train_args()[0]} -> {args[0]} (the "
            "script's time)")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        with tempfile.TemporaryDirectory() as cwd, contextlib.chdir(cwd), \
                env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                    WORLD_SIZE="1", RANK="0", LOCAL_RANK="0"):
            lt.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            out = io.StringIO()
            t0 = time.perf_counter()
            try:
                with contextlib.redirect_stdout(out):
                    code = train.main(args, device=dev)
                torch.cuda.synchronize()
                backend = dist.get_backend() if dist.is_initialized() \
                    else None
            finally:
                if dist.is_initialized():
                    dist.destroy_process_group()
            train_s = time.perf_counter() - t0
            launches = dict(lt.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
        for ln in out.getvalue().splitlines():
            log(f"phase 10 config5_inverse_sharded: {ln}")
        log(f"phase 10 config5_inverse_sharded (train.main {' '.join(args)},"
            f" a {backend} group of 1): exit {code} in {train_s:.1f} s "
            f"({train_s / EX_STEPS:.3f} s a step with the set-up); launches "
            f"{launches} (its scene has no clusters, so brute force); peak "
            f"device memory {peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB "
            f"held before), card {card}")
        if code != 0 or backend != "nccl" or any(launches.values()):
            raise RuntimeError("config 5 failed its checks")
        for k, n in launches.items():
            found[k]["examples"]["config5_inverse_sharded"] = dict(
                launches=n, renders=None, held=0, largest_rays=0,
                max_abs_err=0.0)
    log(f"phase 10 took {time.perf_counter() - t10:.1f} s, card {card}")
    return found


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
        from sycl_ray_tracing_tpu_torch.ops.kernels import probes as pk
        from sycl_ray_tracing_tpu_torch.ops.tonemap import tonemap
        from sycl_ray_tracing_tpu_torch.probes import (
            bounds,
            feature_smoke,
            frame,
            kernel_shape,
            micro_round,
        )
        from sycl_ray_tracing_tpu_torch.probes.__main__ import (
            PROBES,
            run_probes,
        )
        from sycl_ray_tracing_tpu_torch.probes.common import (
            card_line,
            cuda_ms,
        )
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

    # ---- phase 1: build every kernel from the sources, all at once ----
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    builds = {"nvcc listtrace.cu": lt.load_cuda_library,
              "nvcc probes.cu": pk.load_cuda_library,
              "g++ bvh_builder.cpp": native.load}
    with ThreadPoolExecutor(len(builds)) as ex:
        futs = {k: ex.submit(timed, fn) for k, fn in builds.items()}
        took = {k: f.result() for k, f in futs.items()}
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s wall ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in took.items()) + ")")
    for pattern in ("liblisttrace_*.log", "libprobes_*.log"):
        for logf in sorted(native.BUILD_DIR.glob(pattern)):
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line \
                        or "Compiling" in line:
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
            pt.render_rays(scene, cam, px0, py0, W, H, tile_key, 1, 1,
                           estimator="shared")
        torch.cuda.synchronize()
        blocks = cap.tiles["block_tiles"]
        lists = cap.tiles["list_tiles"]
        if len(blocks) < 2 or not lists:
            raise RuntimeError(
                f"capture saw {len(blocks)} block and {len(lists)} per-ray "
                "launches; expected the primary and the first bounce's")
        tris = lt._tiles_with_dummy(scene.clusters)
        prim_launch, bounce_launch = blocks[0], max(
            blocks, key=lambda c: c[-1].shape[0])
        esc_launch = max(lists, key=lambda c: c[-1].shape[0])
        kernels = [tiles_phase(lt, "block_tiles", bounds, cuda_ms, tris,
                               [("primary", prim_launch),
                                ("bounce 1", bounce_launch)],
                               bounce_launch, BLOCK_REPLACES, card),
                   tiles_phase(lt, "list_tiles", bounds, cuda_ms, tris,
                               [("largest escalation", esc_launch)],
                               esc_launch, LIST_REPLACES, card)]
        host_path(lt, esc_launch, tris, card)
        # every rays-per-block instance of the per-ray kernel there: the
        # main path keeps the fastest
        cand, ctn, rays = esc_launch
        for k in lt.LIST_RAYS_PER_BLOCK:
            def call():
                lt.list_tiles(cand, ctn, rays, tris, rays_per_block=k)
            log(f"phase 2 list_tiles largest escalation launch at {k} rays "
                f"per block: {cuda_ms(call, 20):.4f} ms back to back (CUDA "
                f"events), {frame.kernel_ms(call, 'list_tiles_kernel'):.4f} "
                f"ms device time per launch (profiler) ({card})")

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
        torch.cuda.reset_peak_memory_stats()
        fwd_before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        img, aux = pt.render(scene, cam, cfg, key, with_aux=True)
        torch.cuda.synchronize()
        frame_s = time.perf_counter() - t0
        fwd_peak = torch.cuda.max_memory_allocated()
        launches = dict(lt.LAUNCHES)
        for k in kernels:
            k["launches"] = launches[k["name"]]
        mean = float(img.mean())
        finite = bool(torch.isfinite(img).all())
        tm = tonemap(img)
        mrays = W * H * 1 * BOUNCES / frame_s / 1e6
        log(f"phase 3 frame: {tuple(img.shape)} finite={finite} mean={mean:.6f} "
            f"tonemapped mean={float(tm.mean()):.6f} "
            f"overflow={aux['overflow']} launches={launches}")
        log(f"phase 3 frame time {frame_s * 1e3:.1f} ms warm ({cold * 1e3:.1f} "
            f"ms first), {mrays:.3f} Mrays/s ({W}x{H}x1spp x{BOUNCES} bounces "
            f"/ frame time), peak device memory {fwd_peak / 2**30:.2f} GiB "
            f"({fwd_before / 2**30:.2f} GiB held before the frame), card "
            f"{card}")
        if not finite or mean <= 1e-4 or aux["overflow"] \
                or tuple(img.shape) != (H, W, 3):
            raise RuntimeError("main-path frame failed its checks")
        if min(launches.values()) < 1:
            raise RuntimeError(f"a kernel of the path never launched: "
                               f"{launches}")

        # one more frame with every list-kernel launch timed and bounded
        with LaunchTimer(lt) as timer:
            pt.render(scene, cam, cfg, key)
        per_frame = timer.per_kernel(bounds)
        # one more frame under the profiler: each list kernel's device
        # time, without the host's launch path that the events hold
        prof = frame.profile(lambda: pt.render(scene, cam, cfg, key))
        for name, (n, ms, h_ms, b_ms) in per_frame.items():
            pn, dev_ms, _top = prof["kernels"][f"{name}_kernel"]
            log(f"phase 3 per frame {name}: {n} launches, {ms:.4f} ms kernel "
                f"(CUDA events around each launch), {b_ms:.4f} ms sum of "
                f"per-launch bounds, {ms - b_ms:.4f} ms above them; "
                f"{h_ms:.4f} ms on the host clock inside the wrapper; "
                f"profiled frame: {pn} launches, {dev_ms:.4f} ms device "
                f"time, so {ms - dev_ms:.4f} ms of the event time is the "
                f"host's launch path and idle card ({card})")
        for line in frame.report(prof, "phase 3 profiled", card):
            log(line)
        for entry in kernels[:2]:
            err, held = guard_phase(lt, bounds, timer, entry["name"])
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            if entry["name"] == "block_tiles" and not held:
                raise RuntimeError("the tail guard stopped no block list in "
                                   "the frame, so its kernel path went "
                                   "unchecked")
        block, per_ray = kernels[0], kernels[1]

        # ---- phase 4: one 8-bounce tile, kernels vs plain versions ----
        rad_k, aux_k = pt.render_rays(scene, cam, px0, py0, W, H, tile_key,
                                      1, BOUNCES, estimator="shared",
                                      with_aux=True)
        rad_p, aux_p = pt.render_rays(scene, cam, px0, py0, W, H, tile_key,
                                      1, BOUNCES, estimator="shared",
                                      with_aux=True, impl="plain")
        torch.cuda.synchronize()
        same = torch.equal(rad_k, rad_p)
        log(f"phase 4 tile: {rad_k.shape[0]} rays x {BOUNCES} bounces, "
            f"radiance bit-identical={same}, overflow "
            f"{bool(aux_k['overflow'])}/{bool(aux_p['overflow'])}, "
            f"mean {float(rad_k.mean()):.6f}")
        if not same:
            raise RuntimeError("tile radiance differs between kernels and "
                               "plain versions")

        # ---- phase 5: the probe path ----
        t5 = time.perf_counter()

        def hold(label, kernel, plain, want=None):
            """Kernel output == plain output (== want, a closed form)."""
            out_k, out_p = kernel(), plain()
            torch.cuda.synchronize()
            pairs = list(zip(out_k, out_p)) if isinstance(out_k, tuple) \
                else [(out_k, out_p)]
            same = all(torch.equal(a, b) for a, b in pairs)
            err = max(max_abs_err(a, b) for a, b in pairs)
            closed_ok = want is None or torch.equal(out_k, want)
            closed = "" if want is None else \
                f", equal to the script's closed form={closed_ok}"
            log(f"phase 5 {label}: bit-identical={same}{closed}")
            if not (same and closed_ok):
                raise RuntimeError(f"{label} disagrees (max |d| {err})")
            return err

        def probe_entry(name, replaces, kernel, plain, work, err, label):
            ms = cuda_ms(kernel, 20)
            plain_ms = cuda_ms(plain, 3)
            entry = kernel_entry(name, PROBES_CU, replaces, ms, plain_ms,
                                 work, err, bounds)
            log(f"phase 5 {name}: {ms:.4f} ms kernel vs {plain_ms:.4f} ms "
                f"plain at {label}; bound {entry['bound_ms']:.6f} ms by "
                f"{entry['bound_by']} ({entry['ops']:.4g} operations, "
                f"{entry['bytes']:.4g} bytes)")
            kernels.append(entry)

        # kernel_shape's 98,304-ray sorted surface wavefront and its lists
        ks = kernel_shape.workload(scene)
        rays5, tris5 = ks["rays"], ks["tris"]
        # the block kernel on the grouped lists at maxc 96, where the
        # guard stops lists of the sorted wavefront
        _stop, err, early = hold_tiles(
            lt, "block_tiles",
            (*kernel_shape.block_lists(ks, kernel_shape.SHARE_MAXC), rays5),
            tris5, "phase 5 block_tiles on kernel_shape's grouped lists")
        if not early:
            raise RuntimeError("the tail guard stopped no list of "
                               "kernel_shape's grouped lists")
        block["max_abs_err"] = max(block["max_abs_err"], err)
        # the per-ray kernel at every rays-per-block instance on the
        # per-ray lists at maxc 32, where the guard must stop rays
        cnd, ctn5 = kernel_shape.per_ray_lists(ks, 32)
        for k in lt.LIST_RAYS_PER_BLOCK:
            _stop, err, early = hold_tiles(
                lt, "list_tiles", (cnd, ctn5, rays5), tris5,
                f"phase 5 list_tiles rays_per_block={k} on kernel_shape's "
                "per-ray lists", rays_per_block=k)
            if not early:
                raise RuntimeError("the tail guard stopped no ray of "
                                   "kernel_shape's per-ray lists")
            per_ray["max_abs_err"] = max(per_ray["max_abs_err"], err)
            check_info(lt, "list_tiles",
                       f"phase 5 list_tiles rays_per_block={k}",
                       rays_per_block=k)
        log(f"phase 5 list_tiles: {live_note(cnd, tris5)}; the guard let "
            f"{bounds.rounds_run(cnd, tris5, _stop)} of "
            f"{bounds.rounds_run(cnd, tris5)} live ray-rounds run")
        err = hold("list_tiles_min (lane min of the unguarded walk)",
                   lambda: pk.list_tiles_min(cnd, rays5, tris5),
                   lambda: pk.list_tiles_min_plain(cnd, rays5, tris5))
        probe_entry("list_tiles_min", "scratch/kernel_shape_bench.py:90",
                    lambda: pk.list_tiles_min(cnd, rays5, tris5),
                    lambda: pk.list_tiles_min(cnd, rays5, tris5,
                                              impl="plain"),
                    bounds.list_tiles_min_work(cnd, rays5, tris5), err,
                    f"{cnd.shape[0]} rays, maxc 32")

        # the synthetic round: every variant, every sub-block count
        mr = micro_round.workload(dev)
        cand_r, tris_r = mr["cand"], mr["tris"]
        err = 0.0
        for variant in pk.ROUND_VARIANTS:
            plain_out = pk.round_probe(cand_r, tris_r, variant, impl="plain")
            for sb in micro_round.SUBBLOCKS:
                err = max(err, hold(
                    f"round_probe {variant} sub-blocks={sb}",
                    lambda: pk.round_probe(cand_r, tris_r, variant, sb),
                    lambda: plain_out))
        probe_entry("round_probe", "scratch/micro_copy.py:58",
                    lambda: pk.round_probe(cand_r, tris_r, "dynmt"),
                    lambda: pk.round_probe(cand_r, tris_r, "dynmt",
                                           impl="plain"),
                    bounds.round_probe_work(cand_r, tris_r, "dynmt"), err,
                    f"dynmt, {cand_r.shape[0]} rays x {cand_r.shape[1]} "
                    "rounds, 1 sub-block")

        # the feature smoke kernels on the scripts' own inputs
        g = feature_smoke.gather_inputs(dev)
        args = (g["cid"], g["table"], g["rays"])
        err = hold("smoke_gather", lambda: pk.smoke_gather(*args),
                   lambda: pk.smoke_gather(*args, impl="plain"),
                   feature_smoke.gather_want(g))
        probe_entry("smoke_gather", "scratch/pallas_smoke.py:67",
                    lambda: pk.smoke_gather(*args, check_values=False),
                    lambda: pk.smoke_gather(*args, impl="plain"),
                    bounds.smoke_gather_work(*args), err,
                    f"{g['rays'].shape[0]} rays")
        rs = feature_smoke.rank_select_inputs(dev)
        args = (rs["mask"], rs["table"])
        err = hold("smoke_rank_select", lambda: pk.smoke_rank_select(*args),
                   lambda: pk.smoke_rank_select(*args, impl="plain"),
                   feature_smoke.rank_select_want(rs))
        probe_entry("smoke_rank_select", "scratch/pallas_smoke2.py:61",
                    lambda: pk.smoke_rank_select(*args),
                    lambda: pk.smoke_rank_select(*args, impl="plain"),
                    bounds.smoke_rank_select_work(*args), err,
                    "mask [8, 128]")
        mo = feature_smoke.mosaic_inputs(dev)
        args = (mo["ns"], mo["cand"], mo["x"])
        err = 0.0
        for feat in pk.MOSAIC_FEATURES:
            err = max(err, hold(
                f"mosaic_probe {feat}",
                lambda: pk.mosaic_probe(*args, feat),
                lambda: pk.mosaic_probe(*args, feat, impl="plain")))
        probe_entry("mosaic_probe", "scratch/probe_mosaic.py:59",
                    lambda: pk.mosaic_probe(*args, "all",
                                            check_values=False),
                    lambda: pk.mosaic_probe(*args, "all", impl="plain"),
                    bounds.mosaic_probe_work(*args, "all"), err,
                    "feature all, x [8, 128]")
        t5h = time.perf_counter()

        # every probe sweep once, the probe kernels' counters reset first
        pk.reset_launch_counts()
        lt.reset_launch_counts()
        run_probes(PROBES, scene, dev, reps=3)
        torch.cuda.synchronize()
        probe_launches = dict(pk.LAUNCHES)
        log(f"phase 5 probe sweeps: launches {probe_launches}, list kernels "
            f"{dict(lt.LAUNCHES)}")
        for k in kernels:
            if k["name"] in probe_launches:
                k["launches"] = probe_launches[k["name"]]
        if min(probe_launches.values()) < 1:
            raise RuntimeError(f"a probe kernel never launched: "
                               f"{probe_launches}")
        log(f"phase 5 took {time.perf_counter() - t5:.1f} s "
            f"({t5h - t5:.1f} s checks, {time.perf_counter() - t5h:.1f} s "
            f"sweeps), card {card}")

        # ---- phase 6: the 870k-triangle frame ----
        big_frame_phase(kernels, card, cam, cfg, key, tile_key, px0, py0)

    # ---- phase 7: the backward pass (bench.py section 2) ----
    grad_phase(kernels, card, scene, cam, cfg, key, tile_key, px0, py0,
               launches, (fwd_peak - fwd_before) / 2**30)

    # ---- phase 8: the parity estimator and the other backends ----
    with torch.no_grad():
        parity = parity_phase(card, scene, cam, key, tile_key, px0, py0,
                              mean)
    for entry in kernels[:2]:
        entry["frame_parity"] = parity[entry["name"]]

    # ---- phase 9: the CLI, resume, regrow, the trainer, render_sharded ----
    phase9 = cli_phase(card, scene, mean)
    for entry in kernels[:2]:
        entry.update(phase9[entry["name"]])
        entry["max_abs_err"] = max(
            entry["max_abs_err"], entry["train"]["max_abs_err"],
            entry["sharded"]["max_abs_err"])

    # ---- phase 10: the five BASELINE configurations (the examples) ----
    phase10 = examples_phase(card, dev)
    for entry in kernels[:2]:
        entry.update(phase10[entry["name"]])
        entry["max_abs_err"] = max(
            [entry["max_abs_err"]]
            + [v["max_abs_err"] for v in entry["examples"].values()])

    for k in kernels:
        del k["ops"], k["bytes"]
    log(f"chip_smoke took {time.perf_counter() - T_START:.1f} s, card {card}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
