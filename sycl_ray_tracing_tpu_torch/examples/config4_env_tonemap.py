"""BASELINE config 4: HDR env-map lighting with env importance sampling +
tone mapping, dragon @ 1080p 256spp (counterpart of
examples/config4_env_tonemap.py).

    python -m sycl_ray_tracing_tpu_torch.examples.config4_env_tonemap [--small]

The dragon stand-in under a 512x1024 procedural sky; intersect "auto" is
the list tracer on this clustered scene.  32768-ray tiles: 2,073,600
pixels in 64 tiles, the last padded.  Writes example4.png (tone mapped)
and example4.hdr into the current directory.
"""

from __future__ import annotations

from sycl_ray_tracing_tpu_torch.examples._common import Example, run, small
from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
from sycl_ray_tracing_tpu_torch.ops.rng import prng_key
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_scene

FULL = dict(w=1920, h=1080, spp=256, tris=200_000, tile=32768)
SMALL = dict(w=160, h=90, spp=2, tris=20_000, tile=32768)
SKY_RES = (512, 1024)


def build(small: bool = False, device="cuda") -> Example:
    s = SMALL if small else FULL
    cfg = RenderConfig(width=s["w"], height=s["h"], samples=s["spp"],
                       bounces=4, tile_rays=s["tile"])
    scene = dragon_scene(n_tris=s["tris"], with_sky=True, sky_res=SKY_RES,
                         device=device)
    return Example("config4_env_tonemap", scene, pbrt_dragon_camera(device),
                   cfg, prng_key(0), runs=1, min_mean=0.01,
                   png="example4.png", hdr="example4.hdr",
                   extra={"triangles": s["tris"]})


def main(argv=None, device="cuda") -> int:
    run(build(small(argv), device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
