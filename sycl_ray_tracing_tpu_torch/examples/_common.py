"""Shared helpers of the BASELINE-config examples (counterpart of
examples/_common.py): the ``--small`` switch, a timed render that waits
for the card, the one-line JSON report, and the render / check / write /
report sequence of every image example."""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from sycl_ray_tracing_tpu_torch.models import pathtracer
from sycl_ray_tracing_tpu_torch.models.camera import Camera
from sycl_ray_tracing_tpu_torch.models.scene import Scene
from sycl_ray_tracing_tpu_torch.ops.tonemap import tonemap
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
from sycl_ray_tracing_tpu_torch.utils.hdr import write_hdr
from sycl_ray_tracing_tpu_torch.utils.png import write_png


def small(argv=None) -> bool:
    return "--small" in (sys.argv[1:] if argv is None else argv)


def timed_render(render_fn, *args, n: int = 2):
    """One warm-up call (on the card it also builds the kernels at first
    use), then the fastest of ``n`` timed calls.  ``render_fn`` returns
    (image tensor, aux); each call's clock stops only after
    torch.cuda.synchronize() and the image's copy to the host, since the
    card runs behind the host.  Returns (host image, the last call's aux,
    seconds)."""

    def call():
        img, aux = render_fn(*args)
        if img.is_cuda:
            torch.cuda.synchronize()
        return img.cpu().numpy(), aux

    img, aux = call()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        img, aux = call()
        times.append(time.perf_counter() - t0)
    return img, aux, min(times)


def report(name: str, seconds: float, rays: int, extra=None) -> dict:
    out = {
        "example": name,
        "seconds": round(seconds, 3),
        "Mrays_per_s": round(rays / seconds / 1e6, 2),
    }
    if extra:
        out.update(extra)
    print(json.dumps(out))
    return out


@dataclasses.dataclass(frozen=True)
class Example:
    """One image example: what it renders, how often it is timed, the
    mean its image must exceed (None: finite only), the files it writes
    and the JSON line's extra keys."""

    name: str
    scene: Scene
    camera: Camera
    config: RenderConfig
    key: torch.Tensor
    runs: int
    min_mean: Optional[float]
    png: str
    hdr: Optional[str] = None
    extra: Optional[dict] = None

    @property
    def rays(self) -> int:
        c = self.config
        return c.width * c.height * c.samples * c.bounces


def _frame(scene, camera, config, key):
    with torch.no_grad():
        return pathtracer.render(scene, camera, config, key, with_aux=True)


def run(ex: Example) -> dict:
    """Render ``ex`` (one warm-up, then ``ex.runs`` timed frames), check
    the image, write its tone-mapped PNG (and its HDR) into the current
    directory and print the JSON line.  Returns {"image": the host image,
    "overflow": the last frame's flag, "seconds", "report"}."""
    img, aux, seconds = timed_render(_frame, ex.scene, ex.camera, ex.config,
                                     ex.key, n=ex.runs)
    mean = float(img.mean())
    if not np.isfinite(img).all() or (ex.min_mean is not None
                                      and not mean > ex.min_mean):
        raise RuntimeError(f"{ex.name}: the image is not finite or its mean "
                           f"{mean:.6g} is not above {ex.min_mean}")
    if aux["overflow"]:
        print(f"WARNING: {ex.name}: uncertified rays (overflow); the image "
              "may be missing hits", file=sys.stderr)
    write_png(ex.png, tonemap(torch.as_tensor(img)).numpy())
    if ex.hdr:
        write_hdr(ex.hdr, img)
    rep = report(ex.name, seconds, ex.rays, ex.extra)
    return dict(image=img, overflow=aux["overflow"], seconds=seconds,
                report=rep)
