"""Inverse rendering demo (counterpart of the repository's train.py):
optimize scene materials to match a target image.

Renders a ground-truth target with the true materials, perturbs them, and
recovers them by gradient descent through the differentiable path tracer,
with the distributed train step (one rank per device on the ("data",
"sample") mesh, gradients averaged over it) when torchrun starts more than
one process.

Usage (on the card; torchrun --nproc-per-node=N for N devices):
  python -m sycl_ray_tracing_tpu_torch.train [--steps=N] [--w=W] [--h=H]
      [--samples=S] [--scene=cornell]

It renders the reference's cornell_pbr.obj, looked up like the CLI's
default OBJ path (utils/config.find_data), and exits 1 unless the diffuse
error fell.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

SCENE_OBJ = "data/OBJs/cornell_pbr.obj"
LR = 2e-2


def perturb(materials):
    """The demo's start point: the true diffuse albedo +-0.25 and roughness
    +-0.2, uniform from default_rng(1), clamped to [0, 1] and [1e-2, 1]."""
    rng = np.random.default_rng(1)
    dev = materials.diffuse.device

    def noise(t, half):
        return torch.as_tensor(
            rng.uniform(-half, half, tuple(t.shape)).astype(np.float32),
            device=dev)

    return dataclasses.replace(
        materials,
        diffuse=torch.clamp(materials.diffuse + noise(materials.diffuse,
                                                      0.25), 0.0, 1.0),
        roughness=torch.clamp(materials.roughness
                              + noise(materials.roughness, 0.2), 1e-2, 1.0),
    )


def run(scene, camera, config, steps: int, mesh, log=print) -> dict:
    """``steps`` Adam steps (optax.adam(2e-2)'s update: b1 0.9, b2 0.999,
    eps 1e-8 outside the square root) on the diffuse albedo and roughness
    of ``perturb(scene.materials)``, each step's gradient from
    make_train_step with the key fold_in(prng_key(1000), step), the
    materials clamped after each update (train.py:80-105).

    Returns {"materials": the final Materials, "losses": [float] per
    step, "grads": the last step's (diffuse, roughness) gradients,
    "err0_d"/"err0_r": the start's mean abs error, "err_d"/"err_r": the
    end's}."""
    from sycl_ray_tracing_tpu_torch.ops.rng import fold_in, prng_key
    from sycl_ray_tracing_tpu_torch.parallel.render import make_train_step

    W, H = config.width, config.height
    true_mats = scene.materials
    init_mats = perturb(true_mats)
    step_fn = make_train_step(scene, config, mesh, optimize_env=False)
    diffuse = init_mats.diffuse.clone().requires_grad_()
    roughness = init_mats.roughness.clone().requires_grad_()
    opt = torch.optim.Adam([diffuse, roughness], lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)

    dev = scene.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    px, py = xs.reshape(-1), ys.reshape(-1)

    def errors():
        return (float((diffuse.detach() - true_mats.diffuse).abs().mean()),
                float((roughness.detach() - true_mats.roughness).abs()
                      .mean()))

    err0_d, err0_r = errors()
    log(f"init err: diffuse {err0_d:.4f} roughness {err0_r:.4f}")

    losses = []
    grads = None
    t0 = time.time()
    for it in range(steps):
        k = fold_in(prng_key(1000), it)
        mats = dataclasses.replace(init_mats, diffuse=diffuse.detach(),
                                   roughness=roughness.detach())
        loss, (g_mats,) = step_fn(mats, None, true_mats, None, camera,
                                  px, py, k)
        grads = (g_mats.diffuse, g_mats.roughness)
        diffuse.grad = grads[0].clone()
        roughness.grad = grads[1].clone()
        opt.step()
        with torch.no_grad():
            diffuse.clamp_(0.0, 1.0)
            roughness.clamp_(1e-2, 1.0)
        losses.append(float(loss))
        if it % 10 == 0 or it == steps - 1:
            ed, er = errors()
            log(f"step {it:4d} loss {losses[-1]:.6f} "
                f"| err diffuse {ed:.4f} roughness {er:.4f}")

    ed, er = errors()
    log(f"done in {time.time() - t0:.1f}s; diffuse err {err0_d:.4f}->"
        f"{ed:.4f} roughness err {err0_r:.4f}->{er:.4f}")
    final = dataclasses.replace(init_mats, diffuse=diffuse.detach(),
                                roughness=roughness.detach())
    return {"materials": final, "losses": losses, "grads": grads,
            "err0_d": err0_d, "err0_r": err0_r, "err_d": ed, "err_r": er}


def main(argv=None, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    steps, W, H, spp, scene_name = 60, 32, 32, 8, "cornell"
    for a in argv:
        if a.startswith("--steps="):
            steps = int(a[8:])
        elif a.startswith("--w="):
            W = int(a[4:])
        elif a.startswith("--h="):
            H = int(a[4:])
        elif a.startswith("--samples="):
            spp = int(a[10:])
        elif a.startswith("--scene="):
            scene_name = a[8:]

    from sycl_ray_tracing_tpu_torch.models.camera import PRESETS
    from sycl_ray_tracing_tpu_torch.parallel.distributed import (
        initialize,
        is_coordinator,
        process_info,
    )
    from sycl_ray_tracing_tpu_torch.parallel.mesh import (
        best_sample_axis,
        make_mesh,
    )
    from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig, find_data
    from sycl_ray_tracing_tpu_torch.utils.obj_loader import load_scene

    obj_path = find_data(SCENE_OBJ)
    if obj_path is None:
        print(f"error: OBJ file not found: {SCENE_OBJ}")
        return 2
    device = initialize(device=device)
    log = print if is_coordinator() else (lambda *a, **k: None)
    config = RenderConfig(width=W, height=H, samples=spp, bounces=2,
                          tile_rays=None)
    scene = load_scene(obj_path, device=device)
    camera = PRESETS[scene_name if scene_name in PRESETS
                     else "cornell"](device)

    n_dev = process_info()["global_devices"]
    mesh = make_mesh(n_dev, best_sample_axis(n_dev, spp))
    log(f"mesh: {mesh.shape}")
    out = run(scene, camera, config, steps, mesh, log=log)
    return 0 if out["err_d"] < out["err0_d"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
