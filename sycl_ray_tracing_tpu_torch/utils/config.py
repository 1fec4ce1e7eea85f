"""Render configuration (counterpart of sycl_ray_tracing_tpu/utils/config.py).

The JAX package's ``RenderConfig`` with the same fields, names and
defaults, so one set of arguments describes a frame in both packages,
and its CLI parser ``parse_cli``.  Defaults match the reference:
512x512, 64 spp, 8 bounces (main.cpp:32-40).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 512
    height: int = 512
    samples: int = 64
    bounces: int = 8
    # intersection backend: "list", "cluster", "bvh" or "brute"; "auto"
    # means "list" on a scene with clusters, else "bvh" on a scene with a
    # BVH, else "brute"
    intersect: str = "auto"
    # camera preset name (models.camera.PRESETS)
    camera: str = "cornell"
    # restrict render to one pixel for debugging (reference DEBUG_PIXEL)
    debug_pixel: Optional[Tuple[int, int]] = None
    # rays processed per wavefront tile; None = whole image at once
    tile_rays: Optional[int] = 32768
    # samples per pass (accumulated in linear HDR)
    samples_per_pass: int = 1
    # "shared" (one GGX sample per bounce for both MIS terms and the
    # continuation) or "parity" (the reference's 5-query structure)
    estimator: str = "shared"
    # clamp per-sample radiance (firefly suppression; None = unbiased)
    max_radiance: Optional[float] = None
    # replay each bounce (and each sample, when a tile takes several) in
    # the backward pass instead of keeping its graph; the replay reuses
    # the list tracer's recorded answers (path-replay backward)
    remat: bool = True
    # GGX sampler: "fixed" or "reference" (the reference's missing-sqrt bug)
    ggx_sampler: str = "fixed"
    # progressive rendering: checkpoint path (resumed if it exists, saved
    # after every batch) and samples per batch; None = single-shot
    checkpoint: Optional[str] = None
    checkpoint_batch: int = 4

    def __post_init__(self):
        if self.intersect not in ("auto", "brute", "bvh", "cluster",
                                  "list"):
            raise ValueError(f"bad intersect mode {self.intersect!r}")
        if self.estimator not in ("shared", "parity"):
            raise ValueError(f"bad estimator {self.estimator!r}")
        if self.ggx_sampler not in ("fixed", "reference"):
            raise ValueError(f"bad ggx_sampler {self.ggx_sampler!r}")
        if self.samples % self.samples_per_pass != 0:
            raise ValueError("samples must be divisible by samples_per_pass")


# the directory that holds the reference's data/ (OBJs, Skyspheres):
# where find_data looks for a relative path not found from the cwd
REFERENCE_ROOT_ENV = "SRT_REFERENCE_ROOT"


def find_data(path: str) -> Optional[str]:
    """``path`` if it exists, else ``path`` under the reference data
    directory named by $SRT_REFERENCE_ROOT (the CLI's relative default
    paths, main.py:42-51) if it exists there, else None."""
    if os.path.exists(path):
        return path
    root = os.environ.get(REFERENCE_ROOT_ENV)
    if root and os.path.exists(os.path.join(root, path)):
        return os.path.join(root, path)
    return None


# flag -> (RenderConfig field, type) of the reference-style CLI
_FLAGS = {
    "--w=": ("width", int),
    "--h=": ("height", int),
    "--samples=": ("samples", int),
    "--bounces=": ("bounces", int),
    "--camera=": ("camera", str),
    "--intersect=": ("intersect", str),
    "--estimator=": ("estimator", str),
    "--spp-pass=": ("samples_per_pass", int),
    "--checkpoint=": ("checkpoint", str),
    "--checkpoint-batch=": ("checkpoint_batch", int),
}


def parse_cli(argv) -> tuple[RenderConfig, str, str]:
    """Parse reference-style CLI args (main.cpp:42-61; config.py:72-107).

    Returns (config, obj_path, sky_path).  Flags: --sky=, --w=, --h=,
    --samples=, --bounces=, --camera=, --intersect=, --estimator=,
    --spp-pass=, --checkpoint=, --checkpoint-batch=; any other argument
    is the OBJ path.
    """
    obj_path = "data/OBJs/cornell_pbr.obj"
    sky_path = "data/Skyspheres/evening_road_01_puresky_2k.hdr"
    kw = {}
    for arg in argv:
        if arg.startswith("--sky="):
            sky_path = arg[len("--sky="):]
            continue
        for flag, (name, kind) in _FLAGS.items():
            if arg.startswith(flag):
                kw[name] = kind(arg[len(flag):])
                break
        else:
            obj_path = arg
    return RenderConfig(**kw), obj_path, sky_path
