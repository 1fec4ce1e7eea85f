"""The command-line renderer (counterpart of the repository's main.py;
reference main.cpp:63-128):

  parse args -> load OBJ -> build the acceleration structure -> load the
  HDR env map -> render -> report wall-clock -> tone map -> write PNG +
  HDR outputs and three denoised blends.

    python -m sycl_ray_tracing_tpu_torch.main <obj> --sky=<hdr> --w= --h=
        --samples= --bounces= --camera= --intersect= --estimator=
        --spp-pass= --checkpoint= --checkpoint-batch=

It renders on the card and writes RT_output.png, RT_output.hdr and
RT_output_denoised_{1,0.75,0.5}.png into the current directory.  A
traversal overflow (an uncertified ray, or a pair-budget overflow) grows
the backend's budget and renders again, restarting a checkpoint.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch


def main(argv=None, device="cuda") -> int:
    """Run the CLI on ``argv`` (sys.argv[1:] when None); the render runs
    on ``device`` (the card unless the caller asks for the CPU).  The
    last line printed is the RenderMetrics report as JSON."""
    argv = sys.argv[1:] if argv is None else argv
    from sycl_ray_tracing_tpu_torch.models import pathtracer
    from sycl_ray_tracing_tpu_torch.models.camera import PRESETS
    from sycl_ray_tracing_tpu_torch.models.progressive import (
        ProgressiveRenderer,
    )
    from sycl_ray_tracing_tpu_torch.ops.bvh import build_bvh
    from sycl_ray_tracing_tpu_torch.ops.kernels.listtrace import DEFAULT_MAXC
    from sycl_ray_tracing_tpu_torch.ops.rng import prng_key
    from sycl_ray_tracing_tpu_torch.ops.tonemap import tonemap
    from sycl_ray_tracing_tpu_torch.utils.config import find_data, parse_cli
    from sycl_ray_tracing_tpu_torch.utils.denoise import denoise
    from sycl_ray_tracing_tpu_torch.utils.device import resolve_device
    from sycl_ray_tracing_tpu_torch.utils.hdr import write_hdr
    from sycl_ray_tracing_tpu_torch.utils.image_io import read_image_float
    from sycl_ray_tracing_tpu_torch.utils.metrics import RenderMetrics
    from sycl_ray_tracing_tpu_torch.utils.obj_loader import load_scene
    from sycl_ray_tracing_tpu_torch.utils.png import write_png

    device = resolve_device(device)
    config, obj_path, sky_path = parse_cli(argv)

    if config.camera not in PRESETS:
        print(f"error: unknown camera {config.camera!r}; "
              f"choose from {sorted(PRESETS)}")
        return 2
    # convenience: a relative default path is also looked up in the
    # reference's data directory
    found = find_data(obj_path)
    if found is None:
        print(f"error: OBJ file not found: {obj_path}")
        return 2
    obj_path = found

    metrics = RenderMetrics()
    print(f"Reading OBJ {obj_path} ...")
    env_img = None
    if sky_path and os.path.exists(sky_path):
        print(f"Reading Environment Map {sky_path} ...")
        env_img = read_image_float(sky_path, flip_y=True)
    elif sky_path:
        print(f"(env map {sky_path} not found; rendering without sky)")

    with metrics.phase("scene_load"):
        scene = load_scene(obj_path, env_map_image=env_img, device=device)
    print(f"{scene.num_triangles} triangles, {scene.num_lights} lights")

    if config.intersect == "bvh" and scene.num_triangles > 64:
        t0 = time.time()
        scene = scene.with_bvh(build_bvh(scene.triangles.cpu().numpy(),
                                         device=device))
        print(f"BVH build: {(time.time() - t0) * 1000:.0f}ms")
    # "auto" builds clusters: it resolves to the list tracer (or the
    # cluster pair tracer past its cluster cap), pathtracer._resolve_backend
    if config.intersect in ("cluster", "list", "auto"):
        hint = config.tile_rays or config.width * config.height
        with metrics.phase("accel_build"):
            scene = scene.build_acceleration(num_rays_hint=hint)
        print(f"cluster build: {metrics.timers['accel_build'] * 1000:.0f}ms")

    camera = PRESETS[config.camera](device)
    print(f"[{config.width}x{config.height}]: {config.samples} samples\n")

    key = prng_key(0)

    def render(scene, camera, key):
        """Tiled render with in-flight progress prints (the reference
        prints % per scanline band, render_kernel.cpp:205-209).  Each
        tile's result is copied to the host, so the percentage is real
        progress."""
        W, H = config.width, config.height
        tile = config.tile_rays
        if (not tile or tile >= W * H) and config.samples >= 8:
            # untiled multi-sample renders go through the progressive
            # batcher for in-flight % progress; sample streams are keyed
            # by absolute sample index, identical to the --checkpoint path
            spb = next(b for b in range(max(1, config.samples // 8), 0, -1)
                       if config.samples % b == 0)
            pr = ProgressiveRenderer(scene, camera, config,
                                     samples_per_batch=spb)
            pr.run(on_batch=lambda st: print(
                f"{st.samples_done * 100.0 / config.samples:0.6g}%",
                flush=True))
            return (pr.state.image.reshape(H, W, 3),
                    {"overflow": pr.state.overflow})

        def progress(i, n_tiles, hdr):
            hdr.cpu()  # wait for the tile: the percentage is real progress
            print(f"{(i + 1) * 100.0 / n_tiles:0.6g}%", flush=True)

        # render's tiles and keys: fold_in(key, tile index) over the
        # zero-padded pixel list, as the reference CLI's tiled path
        with torch.no_grad():
            hdr, aux = pathtracer.render(scene, camera, config, key,
                                         with_aux=True, on_tile=progress)
        return hdr.cpu().numpy(), aux

    def render_checkpointed(scene, resume_ok=True):
        """Progressive render with checkpoint/resume (the reference cannot
        resume: its tone mapping destroys the linear accumulation,
        render_kernel.cpp:169-180; see models/progressive.py).  Returns
        (hdr, aux) like render(); aux carries the accumulated overflow
        flag so the budget auto-regrow covers this path too."""
        if resume_ok and os.path.exists(config.checkpoint):
            pr = ProgressiveRenderer.resume(
                scene, camera, config, config.checkpoint,
                samples_per_batch=config.checkpoint_batch,
            )
            print(f"resuming at {pr.state.samples_done}/"
                  f"{config.samples} samples")
        else:
            pr = ProgressiveRenderer(
                scene, camera, config,
                samples_per_batch=config.checkpoint_batch,
            )
        total = config.samples

        def _tick(state):
            print(f"{state.samples_done * 100.0 / total:0.6g}%",
                  flush=True)

        hdr = pr.run(checkpoint_path=config.checkpoint, on_batch=_tick)
        return hdr, {"overflow": pr.state.overflow}

    with metrics.phase("render"):
        if config.checkpoint:
            hdr, aux = render_checkpointed(scene)
        else:
            hdr, aux = render(scene, camera, key)
    metrics.count("rays",
                  config.width * config.height * config.samples
                  * config.bounces)
    print(f"{metrics.timers['render'] * 1000:.0f}ms")

    # Traversal overflow means some ray's answer is UNCERTIFIED (list
    # backend: any(~resolved & live); cluster backend: pair budget
    # exceeded), so hits MAY have been dropped.  Grow the backend's real
    # knob and re-render rather than write a corrupt image: the
    # candidate-list depth (ClusterScene.list_maxc) for the list tracer,
    # the pair budgets for the cluster pair tracer.
    for attempt in range(2):
        if scene.clusters is None or not aux["overflow"]:
            break
        cl = scene.clusters
        if pathtracer._resolve_backend(scene, config.intersect) == "list":
            cur = cl.list_maxc or DEFAULT_MAXC
            if cur >= 128:          # packed-winner encoding cap
                print("ERROR: uncertified rays persist at the maximum "
                      "candidate depth (128); image may be missing hits")
                break
            print(
                f"WARNING: uncertified rays at candidate depth "
                f"maxc={cur}; doubling and re-rendering"
            )
            scene = scene.with_clusters(
                cl.with_list_maxc(min(128, cur * 2))
            )
        else:
            print(
                f"WARNING: cluster pair budget overflow "
                f"(p1={cl.p1_budget}, p2={cl.p2_budget}); doubling and "
                f"re-rendering"
            )
            scene = scene.with_clusters(
                cl.with_budgets(cl.p1_budget * 2, cl.p2_budget * 2)
            )
        if config.checkpoint:
            # overflowing batches are already baked into the checkpoint:
            # the accumulation is suspect, so restart it from scratch
            print("(discarding suspect checkpoint and restarting)")
            hdr, aux = render_checkpointed(scene, resume_ok=False)
        else:
            hdr, aux = render(scene, camera, key)
    else:
        if scene.clusters is not None and aux["overflow"]:
            print("ERROR: cluster budgets still overflowing after growth; "
                  "image may be missing hits")

    hdr_t = torch.as_tensor(np.ascontiguousarray(hdr), device=device)
    write_png("RT_output.png", tonemap(hdr_t).cpu().numpy())
    write_hdr("RT_output.hdr", hdr)
    outputs = ["RT_output.png", "RT_output.hdr"]

    # denoised blends, like the reference's three OIDN outputs
    # (main.cpp:118-125) but via the in-tree a-trous denoiser
    for blend in (1.0, 0.75, 0.5):
        den = denoise(hdr_t, blend=blend)
        name = f"RT_output_denoised_{blend:g}.png"
        write_png(name, tonemap(den).cpu().numpy())
        outputs.append(name)
    print("wrote " + ", ".join(outputs))
    print(metrics.dump())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
