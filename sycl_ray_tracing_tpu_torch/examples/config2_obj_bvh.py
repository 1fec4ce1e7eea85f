"""BASELINE config 2: low-poly OBJ mesh + accelerated traversal,
direct + 4-bounce indirect, 512x512 @ 64spp (counterpart of
examples/config2_obj_bvh.py).

    python -m sycl_ray_tracing_tpu_torch.examples.config2_obj_bvh [--small]

It renders the reference's MIS.obj (its low-poly multi-light scene, 3860
triangles), looked up like the CLI's relative paths under
$SRT_REFERENCE_ROOT (utils/config.find_data); without it, it prints an
error and exits 2.  The scene is clustered, so intersect "auto" is the
list tracer, whatever the name says.  Writes example2.png into the
current directory.
"""

from __future__ import annotations

from sycl_ray_tracing_tpu_torch.examples._common import Example, run, small
from sycl_ray_tracing_tpu_torch.models.camera import mis_camera
from sycl_ray_tracing_tpu_torch.ops.rng import prng_key
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig, find_data
from sycl_ray_tracing_tpu_torch.utils.obj_loader import load_scene

MIS_OBJ = "data/OBJs/MIS.obj"
FULL = dict(size=512, spp=64, tile=32768)
SMALL = dict(size=64, spp=4, tile=4096)


def build(obj_path: str, small: bool = False, device="cuda") -> Example:
    s = SMALL if small else FULL
    cfg = RenderConfig(width=s["size"], height=s["size"], samples=s["spp"],
                       bounces=4, tile_rays=s["tile"])
    scene = load_scene(obj_path, device=device)
    # the pair-budget hint must match the RAY TILE size, not the image
    scene = scene.build_acceleration(num_rays_hint=s["tile"])
    return Example("config2_obj_bvh", scene, mis_camera(device), cfg,
                   prng_key(0), runs=2, min_mean=0.05, png="example2.png")


def main(argv=None, device="cuda") -> int:
    path = find_data(MIS_OBJ)
    if path is None:
        print(f"error: OBJ file not found: {MIS_OBJ}")
        return 2
    run(build(path, small(argv), device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
