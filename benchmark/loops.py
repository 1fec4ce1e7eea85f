"""The closed loops a cell drives, one per traffic kind, each: set-up
(inputs, the program's scene and acceleration, warm-up), the measured
window, the traced reading (``--trace 1``), then the check against the
reference once the program's state is freed.

  * "progressive": 1-spp frames back to back, frame i under the key
    fold_in(key(seed), i), each image copied to the host; the program's
    ``models.pathtracer.render`` under ``torch.no_grad()``.
  * "trainer": the inverse-rendering trainer on a one-rank mesh,
    ``parallel.render.make_train_step`` (optimize_env=False) and
    ``train.run``'s update (Adam on diffuse and roughness, then the
    clamps), step i under fold_in(key(seed), i), from the true materials
    perturbed from the seed; each step ends in its loss on the host, and
    keeps its state before it and its gradient on the card, for the check
    of one window step drawn from the seed.

From the program the loops take only its public entries, the list
kernels' launch counter ``listtrace.LAUNCHES`` and, in the traced run,
the list tracer's kernel and build wrappers, wrapped from here.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import check, stats, trace
from benchmark.inputs import scene_arrays
from benchmark.reference import rng

TRACED_CALLS = 2          # profiled calls of the traced reading
WARM_KEY = 0xFFFFFF00     # warm-up calls use keys past any window's


@dataclasses.dataclass
class Context:
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _key(base, i):
    return torch.tensor(rng.fold_in(base, i), dtype=torch.int64)


def build_libraries(dev) -> dict:
    """Loads the program's native libraries (the SAH builder, and on a card
    the list kernels) as its first use would, and says which of them this
    run built into the package's build/ directory and in how many seconds:
    only a checkout's first run builds, and its set-up holds that time."""
    if dev.type != "cuda":
        return {"built": [], "seconds": 0.0}
    from sycl_ray_tracing_tpu_torch import native
    from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace

    def libs():
        return set(p.name for p in native.BUILD_DIR.glob("*.so"))

    t0 = time.perf_counter()
    there = libs()
    native.load()
    listtrace.load_cuda_library()
    return {"built": sorted(libs() - there),
            "seconds": time.perf_counter() - t0}


def program_scene(inputs, dev):
    from sycl_ray_tracing_tpu_torch.models.scene import (
        make_materials,
        make_scene,
    )

    mats = make_materials(inputs.emission, inputs.diffuse, inputs.metalness,
                          inputs.roughness, device=dev)
    scene = make_scene(inputs.triangles, inputs.material_indices, mats,
                       env_map_image=inputs.sky, device=dev)
    return scene.build_acceleration()


def _render_config(cfg, tiled: bool):
    from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig

    return RenderConfig(width=cfg["width"], height=cfg["height"],
                        samples=cfg["samples"], bounces=cfg["bounces"],
                        intersect=cfg["intersect"],
                        estimator=cfg["estimator"],
                        tile_rays=cfg["tile_rays"] if tiled else None)


def _camera(cfg, dev):
    from sycl_ray_tracing_tpu_torch.models.camera import PRESETS

    return PRESETS[cfg["camera"]["preset"]](dev)


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _window(ctx, call, first: int, lt) -> dict:
    """Calls ``call(i)`` for i = first, first+1, ... until ``seconds``
    have passed; the last call ends the window.  Per call: its wall time,
    its result and its list-kernel launches."""
    dev = ctx.device
    _reset_peak(dev)
    out = {"times": [], "results": [], "launches": []}
    t0 = time.perf_counter()
    i = first
    while True:
        lt.reset_launch_counts()
        t = time.perf_counter()
        out["results"].append(call(i))
        out["times"].append(time.perf_counter() - t)
        out["launches"].append(sum(lt.LAUNCHES.values()))
        i += 1
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    out["window_s"] = time.perf_counter() - t0
    out["peak_bytes"] = _peak(dev)
    return out


def _traced(call, keys, lt) -> dict:
    """The per-layer readings over TRACED_CALLS calls after the window:
    profiled once for device activity, run again with the list kernels'
    inputs captured, and each call's candidate builds replayed."""
    rec = trace.profiled([lambda i=i: call(i) for i in keys])
    busy, gaps = stats.union(rec["events"])
    with trace.KernelInputs(lt) as cap:
        for i in keys:
            call(i)
    builds = [trace.build_device_s(lambda i=i: call(i), lt)[1]
              for i in keys]
    by_gap = {}
    for s, name in gaps:
        label = f"after {trace.short(name)}"
        by_gap[label] = by_gap.get(label, 0.0) + s
    return {"traced_calls": len(keys), "busy_s": busy,
            "traced_wall_s": sum(rec["walls"]),
            "kernel_device": trace.kernel_seconds(rec["events"]),
            "kernel_bound_s": cap.bound_s, "kernel_captured": cap.launches,
            "build_device_s": builds,
            "breakdown": {
                "device_ops": trace.top_ops(rec["events"]),
                "idle_gaps": [[k, v] for k, v in sorted(
                    by_gap.items(), key=lambda kv: -kv[1])[:10]]}}


class Frames:
    """The program's progressive frames of one scene: ``frame(base, i)``
    renders frame i under fold_in(base, i) with ``models.pathtracer
    .render`` (no grad) and returns (the image on the host, overflow)."""

    def __init__(self, inputs, cfg: dict, dev):
        self.scene = program_scene(inputs, dev)
        self.camera = _camera(cfg, dev)
        self.rcfg = _render_config(cfg, tiled=True)
        self.dev = dev

    def frame(self, base, i):
        from sycl_ray_tracing_tpu_torch.models import pathtracer

        with torch.no_grad():
            img, aux = pathtracer.render(self.scene, self.camera, self.rcfg,
                                         _key(base, i), with_aux=True)
        _sync(self.dev)
        return img.cpu(), bool(aux["overflow"])


def frame_checks(inputs, cfg: dict, traffic: dict, seed: int, images: list,
                 dev, dtype=torch.float32) -> float:
    """pixels_off of a sample of (frame, tile) pairs of ``images`` (the
    frames 0.. of the seed's key) against the reference; with another
    dtype, the reference in that precision stands in the program's
    place."""
    base = rng.key_of_seed(seed)
    tiles = -(-cfg["width"] * cfg["height"] // cfg["tile_rays"])
    pairs = check.frame_sample(seed, len(images), tiles,
                               traffic["check_tiles"])
    ref = check.reference_tiles(inputs, cfg, base, pairs, dev)
    if dtype == torch.float32:
        prog = {(f, t): check.tile_rows(images[f], t, cfg["tile_rays"])
                for f, t in pairs}
    else:
        prog = {k: v[0] for k, v in check.reference_tiles(
            inputs, cfg, base, pairs, dev, dtype, rules=(False,)).items()}
    return check.pixels_off(prog, ref, cfg, traffic)


def progressive(ctx: Context):
    """Returns (record, checks, failed)."""
    from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as lt

    cfg, dev = ctx.cfg, ctx.device
    build = build_libraries(dev)
    inputs = scene_arrays(cfg)
    frames = Frames(inputs, cfg, dev)
    base = rng.key_of_seed(ctx.seed)

    def frame(i):
        return frames.frame(base, i)

    for j in range(ctx.traffic["warm_calls"]):
        frame(WARM_KEY + j)
    setup_peak = _peak(dev)
    setup_s = time.perf_counter() - ctx.t_start
    win = _window(ctx, frame, 0, lt)
    record = {"kind": "render", "setup_s": setup_s, "build": build,
              "window_s": win["window_s"], "call_s": win["times"],
              "calls": len(win["times"]),
              "work_per_call": stats.rays_per_frame(cfg),
              "launches": win["launches"],
              "peak_bytes": win["peak_bytes"]}
    if ctx.trace:
        record.update(_traced(frame, range(TRACED_CALLS), lt))
    record["memory_peak_bytes"] = max(setup_peak, _peak(dev))
    images = [img for img, _ in win["results"]]
    overflow = sum(of for _, of in win["results"])
    failed = sum(of or not bool(torch.isfinite(img).all())
                 for img, of in win["results"])
    del frames, win
    free(dev)
    record["check_t0"] = time.perf_counter()
    checks = {
        "pixels_off": (frame_checks(inputs, cfg, ctx.traffic, ctx.seed,
                                    images, dev),
                       ctx.traffic["limits"]["pixels_off"]),
        "overflow_frames": (overflow, 0),
    }
    return record, checks, failed


def perturb(start_diffuse, start_roughness, seed: int, traffic: dict):
    """The trainer's start: the true diffuse albedo +-diffuse_noise and
    roughness +-roughness_noise, uniform from default_rng(seed), clamped
    to [0, 1] and [roughness_min, 1] (train.perturb with the seed)."""
    g = np.random.default_rng(int(seed))
    d = np.asarray(start_diffuse, np.float32)
    r = np.asarray(start_roughness, np.float32)
    d = np.clip(d + g.uniform(-traffic["diffuse_noise"],
                              traffic["diffuse_noise"], d.shape)
                .astype(np.float32), 0.0, 1.0)
    r = np.clip(r + g.uniform(-traffic["roughness_noise"],
                              traffic["roughness_noise"], r.shape)
                .astype(np.float32), traffic["roughness_min"], 1.0)
    return torch.tensor(d), torch.tensor(r)


class Trainer:
    """The program's trainer on a one-rank mesh from the seed's start:
    ``step(i)`` runs make_train_step's step under fold_in(key(seed), i),
    then train.run's update (Adam, the clamps), and returns the loss."""

    def __init__(self, inputs, scene, cfg: dict, traffic: dict, seed: int,
                 dev):
        from sycl_ray_tracing_tpu_torch.parallel.mesh import make_mesh
        from sycl_ray_tracing_tpu_torch.parallel.render import (
            make_train_step,
        )

        self.scene, self.traffic, self.dev = scene, traffic, dev
        self.camera = _camera(cfg, dev)
        self.base = rng.key_of_seed(seed)
        self.true_mats = scene.materials
        self.d0, self.r0 = perturb(inputs.diffuse, inputs.roughness, seed,
                                   traffic)
        self.start = dataclasses.replace(
            self.true_mats, diffuse=self.d0.to(dev),
            roughness=self.r0.to(dev))
        self.step_fn = make_train_step(scene, _render_config(cfg, False),
                                       make_mesh(1, 1), optimize_env=False)
        self.diffuse = self.start.diffuse.clone().requires_grad_()
        self.roughness = self.start.roughness.clone().requires_grad_()
        self.opt = torch.optim.Adam([self.diffuse, self.roughness],
                                    lr=traffic["lr"], betas=check.BETAS,
                                    eps=check.ADAM_EPS)
        ys, xs = torch.meshgrid(
            torch.arange(cfg["height"], dtype=torch.float32, device=dev),
            torch.arange(cfg["width"], dtype=torch.float32, device=dev),
            indexing="ij")
        self.px, self.py = xs.reshape(-1), ys.reshape(-1)
        self.kept = {}

    def _params(self):
        return [p.detach().clone() for p in (self.diffuse, self.roughness)]

    def _moment(self, name):
        return [self.opt.state[p][name].clone() if name in self.opt.state[p]
                else torch.zeros_like(p)
                for p in (self.diffuse, self.roughness)]

    def step(self, i) -> float:
        d, r = self.diffuse, self.roughness
        # the state before the step and the gradient it hands the
        # optimizer, kept on the card for the check of a window's step
        kept = {"params": self._params(), "m": self._moment("exp_avg"),
                "v": self._moment("exp_avg_sq")}
        mats = dataclasses.replace(self.start, diffuse=d.detach(),
                                   roughness=r.detach())
        loss, (g,) = self.step_fn(mats, None, self.true_mats, None,
                                  self.camera, self.px, self.py,
                                  _key(self.base, i))
        d.grad = g.diffuse.clone()
        r.grad = g.roughness.clone()
        self.opt.step()
        with torch.no_grad():
            d.clamp_(0.0, 1.0)
            r.clamp_(self.traffic["roughness_min"], 1.0)
        kept["grad"] = [d.grad, r.grad]
        kept["loss"] = float(loss)
        self.kept[i] = kept
        return kept["loss"]

    def followed(self, k: int) -> dict:
        """Step k on the host: its start ({"diffuse", "roughness"}), Adam's
        moments before it, and what it gave (first_steps' keys)."""
        def host(ts):
            return [t.float().cpu() for t in ts]

        kept = self.kept[k]
        after = (self.kept[k + 1]["params"] if k + 1 in self.kept
                 else self._params())
        d, r = host(kept["params"])
        return {"step": k, "start": {"diffuse": d, "roughness": r},
                "moments": {"m": host(kept["m"]), "v": host(kept["v"])},
                "program": {"losses": [kept["loss"]],
                            "grad": host(kept["grad"]),
                            "params": host(after)}}

    def first_steps(self, n: int) -> dict:
        """Steps 0..n-1: each loss, the first gradient as the optimizer got
        it (its first moment after one step over 1 - beta1) and the
        parameters after the n steps, on the host."""
        out = {"losses": []}
        for i in range(n):
            out["losses"].append(self.step(i))
            if i == 0:
                out["grad"] = [
                    (self.opt.state[p].get("exp_avg", torch.zeros_like(p))
                     / (1 - check.BETAS[0])).float().cpu()
                    for p in (self.diffuse, self.roughness)]
        out["params"] = [p.detach().float().cpu().clone()
                         for p in (self.diffuse, self.roughness)]
        return out

    def start_params(self) -> dict:
        return {"diffuse": self.d0, "roughness": self.r0}


def step_checks(inputs, cfg: dict, traffic: dict, seed: int, program: dict,
                start: dict, window: dict, dev, dtype=torch.float32) -> dict:
    """loss_gap, grad_gap, change_gap of ``program`` (first_steps' result)
    against the reference's first steps, and of ``window`` (followed's
    result) against the reference's step from the state the program held
    before it, the worse of the two each; with another dtype, the
    reference in that precision stands in the program's place."""
    base = rng.key_of_seed(seed)
    limits = traffic["limits"]
    n = traffic["reference_steps"]
    ref = check.reference_steps(inputs, cfg, traffic, base, start, n, dev)
    if dtype != torch.float32:
        program = check.reference_steps(inputs, cfg, traffic, base, start,
                                        n, dev, dtype, max_branches=1)[0]
    gaps = check.step_gaps(program, ref, start, limits)
    at = {"first": window["step"], "moments": window["moments"]}
    ref = check.reference_steps(inputs, cfg, traffic, base, window["start"],
                                1, dev, **at)
    followed = window["program"]
    if dtype != torch.float32:
        followed = check.reference_steps(inputs, cfg, traffic, base,
                                         window["start"], 1, dev, dtype,
                                         max_branches=1, **at)[0]
    wgaps = check.step_gaps(followed, ref, window["start"], limits)
    return {k: max(v, wgaps[k]) for k, v in gaps.items()}


def trainer(ctx: Context):
    """Returns (record, checks, failed)."""
    from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as lt

    cfg, dev, tr = ctx.cfg, ctx.device, ctx.traffic
    build = build_libraries(dev)
    inputs = scene_arrays(cfg)
    run = Trainer(inputs, program_scene(inputs, dev), cfg, tr, ctx.seed,
                  dev)
    n_ref = tr["reference_steps"]
    program = run.first_steps(n_ref)
    start = run.start_params()
    setup_peak = _peak(dev)
    setup_s = time.perf_counter() - ctx.t_start
    win = _window(ctx, run.step, n_ref, lt)
    record = {"kind": "train", "setup_s": setup_s, "build": build,
              "window_s": win["window_s"], "call_s": win["times"],
              "calls": len(win["times"]), "launches": win["launches"],
              "peak_bytes": win["peak_bytes"]}
    if ctx.trace:
        nxt = n_ref + len(win["times"])
        record.update(_traced(run.step, range(nxt, nxt + TRACED_CALLS), lt))
    record["memory_peak_bytes"] = max(setup_peak, _peak(dev))
    failed = sum(not np.isfinite(x) for x in win["results"])
    window = run.followed(check.window_pick(ctx.seed, n_ref,
                                            len(win["times"])))
    del run, win
    free(dev)
    record["check_t0"] = time.perf_counter()
    gaps = step_checks(inputs, cfg, tr, ctx.seed, program, start, window,
                       dev)
    checks = {k: (v, tr["limits"][k]) for k, v in gaps.items()}
    return record, checks, failed


def free(dev):
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


LOOPS = {"progressive": progressive, "trainer": trainer}
