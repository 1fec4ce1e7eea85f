"""Render configuration (counterpart of sycl_ray_tracing_tpu/utils/config.py).

The JAX package's ``RenderConfig`` fields that the ported path reads,
with the same names and defaults, so one set of arguments describes a
frame in both packages.  Defaults match the reference:
512x512, 64 spp, 8 bounces (main.cpp:32-40).  The JAX fields that only
unported code reads (``camera`` for the CLI, ``checkpoint``/
``checkpoint_batch`` for progressive rendering) are left out until that
code is ported.
"""

from __future__ import annotations

import dataclasses
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
