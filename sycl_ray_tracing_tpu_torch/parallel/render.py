"""Sharded rendering and distributed inverse-rendering steps (counterpart
of sycl_ray_tracing_tpu/parallel/render.py).

One rank per mesh cell takes the place of shard_map:
  * pixels flattened to a ray list, zero-padded to a multiple of the
    "data" axis; each rank renders its contiguous data shard
  * spp divided over the "sample" axis; each rank renders its slice of
    samples with the key fold_in(fold_in(key, sample index), data index),
    and an all_reduce mean over the rank's row (the "sample" axis) averages
    them
  * the scene is replicated on every device
  * inverse rendering: per-rank loss and gradients averaged over both axes
"""

from __future__ import annotations

import dataclasses

import torch

from sycl_ray_tracing_tpu_torch.models import pathtracer
from sycl_ray_tracing_tpu_torch.models.camera import Camera
from sycl_ray_tracing_tpu_torch.models.scene import Materials, Scene
from sycl_ray_tracing_tpu_torch.ops.rng import fold_in
from sycl_ray_tracing_tpu_torch.parallel.mesh import Mesh, pad_to_multiple
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
from sycl_ray_tracing_tpu_torch.utils.metrics import span


def _shard_key(key, mesh: Mesh):
    return fold_in(fold_in(key, mesh.sample_index), mesh.data_index)


@torch.no_grad()
def render_sharded(scene: Scene, camera: Camera, config: RenderConfig,
                   key, mesh: Mesh) -> torch.Tensor:
    """Full-frame render sharded over the mesh -> HDR [H,W,3], the whole
    image on every rank.

    Equivalent in semantics to models.pathtracer.render for a sample count
    of config.samples; sample keys are folded per mesh cell so the
    estimate differs from one device's only by RNG stream assignment.
    """
    W, H = config.width, config.height
    if config.samples % mesh.n_sample != 0:
        raise ValueError("samples must divide over the sample axis")
    spp_shard = config.samples // mesh.n_sample

    B = W * H
    Bp = pad_to_multiple(B, mesh.n_data)
    dev = scene.device
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    zeros = torch.zeros((Bp - B,), dtype=torch.float32, device=dev)
    px = torch.cat([xs.reshape(-1), zeros])
    py = torch.cat([ys.reshape(-1), zeros])
    shard = Bp // mesh.n_data
    sl = slice(mesh.data_index * shard, (mesh.data_index + 1) * shard)
    hdr = pathtracer.render_rays(
        scene, camera, px[sl], py[sl], W, H, _shard_key(key, mesh),
        spp_shard, config.bounces, config.intersect, True, config.estimator,
    )
    hdr = mesh.all_gather(mesh.pmean(hdr, "sample"), "data")
    return hdr[:B].reshape(H, W, 3)


def _shard_render(materials, env_image, camera, scene: Scene,
                  px, py, config: RenderConfig, key, spp_shard: int):
    """Render this rank's rays/samples with the given scene parameters."""
    scene = scene.with_materials(materials)
    if env_image is not None:
        scene = scene.with_env_map(env_image)
    return pathtracer.render_rays(
        scene, camera, px, py, config.width, config.height, key,
        spp_shard, config.bounces, config.intersect, True, config.estimator,
    )


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_()


def make_train_step(scene: Scene, config: RenderConfig, mesh: Mesh,
                    optimize_env: bool = True):
    """Build a distributed inverse-rendering step.

    step(materials, env_image, target_materials, target_env, camera,
         px, py, key) -> (loss, grads)

    ``px``/``py`` hold every pixel; each rank takes its contiguous "data"
    shard.  The target is rendered INSIDE the step with the SAME per-rank
    RNG streams as the guess (common random numbers): the MC noise
    cancels in the residual, so the loss is exactly 0 at the true
    parameters and the gradient signal isn't buried under the
    sampling-noise floor.  Loss is MSE in log1p space so emitter pixels
    (~100x brighter) don't drown materials.  ``grads`` is (Materials of
    gradients,) or, with ``optimize_env``, (that, the sky's gradient);
    loss and gradients are averaged over the whole mesh, so every rank
    returns the same.  A step runs under the span ``train.step``, its
    target render under ``train.target``, the guess's render under
    ``train.guess`` and the gradient under ``train.backward``.
    """
    spp_shard = max(1, config.samples // mesh.n_sample)

    def step(materials: Materials, env_image, target_materials: Materials,
             target_env, camera: Camera, px, py, key):
        with span("train.step"):
            return _step(materials, env_image, target_materials, target_env,
                         camera, px, py, key)

    def _step(materials, env_image, target_materials, target_env, camera,
              px, py, key):
        if px.shape[0] % mesh.n_data != 0:
            raise ValueError("the pixel list must divide over the data axis")
        shard = px.shape[0] // mesh.n_data
        sl = slice(mesh.data_index * shard, (mesh.data_index + 1) * shard)
        px, py = px[sl], py[sl]
        k = _shard_key(key, mesh)

        with torch.no_grad(), span("train.target"):
            target = _shard_render(target_materials, target_env, camera,
                                   scene, px, py, config, k, spp_shard)
        mats = Materials(*(_leaf(getattr(materials, f.name))
                           for f in dataclasses.fields(Materials)))
        env = (_leaf(torch.as_tensor(env_image, device=scene.device))
               if optimize_env else env_image)
        with span("train.guess"):
            hdr = _shard_render(mats, env, camera, scene, px, py, config, k,
                                spp_shard)
        # torch.maximum splits a tie's gradient in half like jnp.maximum
        # (clamp_min would pass all of it at the many black pixels)
        zero = torch.zeros_like(hdr)
        a = torch.log1p(torch.maximum(hdr, zero))
        b = torch.log1p(torch.maximum(target, zero))
        loss = torch.mean((a - b) ** 2)
        leaves = [getattr(mats, f.name) for f in dataclasses.fields(mats)]
        if optimize_env:
            leaves.append(env)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(leaves, grads)]

        def mean(x):
            return mesh.pmean(mesh.pmean(x, "sample"), "data")

        grads = [mean(g) for g in grads]
        g_mats = Materials(*grads[:4])
        out = (g_mats, grads[4]) if optimize_env else (g_mats,)
        return mean(loss), out

    return step
