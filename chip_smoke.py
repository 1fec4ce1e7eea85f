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

The second-to-last lines are the card line and one JSON object describing
each kernel (time, plain version's time, launches, and the bound: the
least time an H100 could take for the same work); the last line is
{"ok": true, "device": {...}}.  Without CUDA, or without the rest of the
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
        pt.render_rays(scene, cam, px0, py0, W, H, tile_key, 1, 1)
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
        t0 = time.perf_counter()
        img, aux = pt.render(scene, cam, cfg, key, with_aux=True)
        torch.cuda.synchronize()
        frame_s = time.perf_counter() - t0
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
            f"/ frame time), card {card}")
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
