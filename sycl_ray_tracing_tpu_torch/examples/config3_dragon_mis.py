"""BASELINE config 3: dragon (stand-in), Cook-Torrance roughness/metallic
with BRDF importance sampling + MIS, 720p @ 128spp (counterpart of
examples/config3_dragon_mis.py).

    python -m sycl_ray_tracing_tpu_torch.examples.config3_dragon_mis [--small]

No sky: the shared estimator's env-map terms are off and the panel light
is the only emitter.  The list tracer by name, 32768-ray tiles (921,600
pixels in 29 tiles).  Writes example3.png into the current directory.
"""

from __future__ import annotations

from sycl_ray_tracing_tpu_torch.examples._common import Example, run, small
from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
from sycl_ray_tracing_tpu_torch.ops.rng import prng_key
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_scene

FULL = dict(w=1280, h=720, spp=128, tris=200_000, tile=32768)
SMALL = dict(w=128, h=72, spp=2, tris=20_000, tile=32768)


def build(small: bool = False, device="cuda") -> Example:
    s = SMALL if small else FULL
    cfg = RenderConfig(width=s["w"], height=s["h"], samples=s["spp"],
                       bounces=4, tile_rays=s["tile"], intersect="list")
    scene = dragon_scene(n_tris=s["tris"], with_sky=False, device=device)
    return Example("config3_dragon_mis", scene, pbrt_dragon_camera(device),
                   cfg, prng_key(0), runs=1, min_mean=None,
                   png="example3.png", extra={"triangles": s["tris"]})


def main(argv=None, device="cuda") -> int:
    run(build(small(argv), device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
