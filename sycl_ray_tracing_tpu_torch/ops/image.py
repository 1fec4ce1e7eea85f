"""Image/framebuffer utilities (counterpart of
sycl_ray_tracing_tpu/ops/image.py): per-pixel and per-area luminance
(reference image.h:80-101), nearest and bilinear sampling (:104-135) and
the range remap of image_io.cpp:12-95, as functions of [H,W,3] tensors.
"""

from __future__ import annotations

import torch

from sycl_ray_tracing_tpu_torch.ops.safe_math import luminance


def luminance_of_pixel(image: torch.Tensor, x, y) -> torch.Tensor:
    """Luminance of texel (x, y) (image.h:80-84)."""
    return luminance(image[y, x])


def luminance_of_area(image: torch.Tensor, x0: int, x1: int,
                      y0: int, y1: int) -> torch.Tensor:
    """Summed luminance over the rect [x0,x1) x [y0,y1) (image.h:86-101)."""
    return torch.sum(luminance(image[y0:y1, x0:x1]))


def sample_nearest(image: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest-texel sample at uv in [0,1]^2 ([...,2]) (image.h:126-135)."""
    h, w = image.shape[0], image.shape[1]
    x = torch.clamp((uv[..., 0] * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((uv[..., 1] * h).to(torch.int64), 0, h - 1)
    return image[y, x]


def sample_bilinear(image: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample at uv in [0,1]^2 ([...,2]) (image.h:104-124)."""
    h, w = image.shape[0], image.shape[1]
    fx = uv[..., 0] * w - 0.5
    fy = uv[..., 1] * h - 0.5
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, w - 1)
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    tx = torch.clamp(fx - x0, 0.0, 1.0)[..., None]
    ty = torch.clamp(fy - y0, 0.0, 1.0)[..., None]
    return (
        (1 - tx) * (1 - ty) * image[y0, x0]
        + tx * (1 - ty) * image[y0, x1]
        + (1 - tx) * ty * image[y1, x0]
        + tx * ty * image[y1, x1]
    )


def normalize_range(image: torch.Tensor) -> torch.Tensor:
    """Linear remap to [0,1] (reference image_io.cpp 'range' utility)."""
    lo = torch.amin(image)
    hi = torch.amax(image)
    return (image - lo) / torch.clamp_min(hi - lo, 1e-12)
