"""BASELINE config 1: Cornell-style spheres-only scene, direct lighting,
diffuse BRDF, 256x256 @ 16spp (counterpart of
examples/config1_spheres_direct.py).

    python -m sycl_ray_tracing_tpu_torch.examples.config1_spheres_direct [--small]

The floor and the light quad are the only triangles; the rest are three
spheres.  No acceleration structure is built, so intersect "auto" is
brute force (models/pathtracer._resolve_backend): this config launches
no list kernel.  One untiled render over every pixel, 16 samples in
turn, 1 bounce.  Writes example1.png into the current directory.
"""

from __future__ import annotations

import numpy as np

from sycl_ray_tracing_tpu_torch.examples._common import Example, run, small
from sycl_ray_tracing_tpu_torch.models.camera import Camera
from sycl_ray_tracing_tpu_torch.models.scene import (
    add_sphere,
    make_materials,
    make_scene,
)
from sycl_ray_tracing_tpu_torch.ops import transform as T
from sycl_ray_tracing_tpu_torch.ops.rng import prng_key
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
from sycl_ray_tracing_tpu_torch.utils.device import resolve_device

FULL = dict(size=256, spp=16)
SMALL = dict(size=64, spp=4)


def build_scene(device="cuda"):
    device = resolve_device(device)
    # floor + area light as the only triangles; everything else is spheres
    g = 3.0
    tris = np.array(
        [
            [[-g, 0, -g], [g, 0, g], [g, 0, -g]],
            [[-g, 0, -g], [-g, 0, g], [g, 0, g]],
            # light quad facing down at y=3
            [[-0.6, 3, -0.6], [0.6, 3, -0.6], [0.6, 3, 0.6]],
            [[-0.6, 3, -0.6], [0.6, 3, 0.6], [-0.6, 3, 0.6]],
        ],
        np.float32,
    )
    mats = make_materials(
        emission=[(1, 0, 1), (0, 0, 0), (30, 30, 30)],
        diffuse=[(0, 0, 0), (0.7, 0.7, 0.7), (0, 0, 0)],
        metalness=[0, 0, 0],
        roughness=[1.0, 1.0, 1.0],  # roughness 1 = diffuse-dominant
        device=device,
    )
    scene = make_scene(tris, np.array([1, 1, 2, 2], np.int32), mats,
                       device=device)
    scene = add_sphere(scene, (0.0, 0.7, 0.0), 0.7, diffuse=(0.8, 0.3, 0.3),
                       roughness=1.0)
    scene = add_sphere(scene, (1.4, 0.45, 0.6), 0.45, diffuse=(0.3, 0.8, 0.3),
                       roughness=1.0)
    scene = add_sphere(scene, (-1.3, 0.5, -0.4), 0.5, diffuse=(0.3, 0.3, 0.8),
                       roughness=1.0)
    return scene


def build(small: bool = False, device="cuda") -> Example:
    s = SMALL if small else FULL
    cfg = RenderConfig(width=s["size"], height=s["size"], samples=s["spp"],
                       bounces=1, tile_rays=None)
    cam = Camera.create(45.0, T.compose(T.rotation_x(-20.0),
                                        T.translation(0.0, 0.2, 6.0)), device)
    return Example("config1_spheres_direct", build_scene(device), cam, cfg,
                   prng_key(0), runs=2, min_mean=0.01, png="example1.png")


def main(argv=None, device="cuda") -> int:
    run(build(small(argv), device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
