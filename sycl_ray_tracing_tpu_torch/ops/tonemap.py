"""Tone mapping at export (counterpart of sycl_ray_tracing_tpu/ops/tonemap.py):
exposure 1.5, gamma 2.2, tone = 1 - exp(-hdr * exposure), out = tone^(1/gamma)
(reference render_kernel.cpp:171-180)."""

from __future__ import annotations

import torch

DEFAULT_EXPOSURE = 1.5
DEFAULT_GAMMA = 2.2


def tonemap(hdr: torch.Tensor, exposure: float = DEFAULT_EXPOSURE,
            gamma: float = DEFAULT_GAMMA) -> torch.Tensor:
    """Exposure + gamma tone map of linear HDR radiance [...,3] -> [0,1]."""
    tone = 1.0 - torch.exp(-torch.clamp_min(hdr, 0.0) * exposure)
    return torch.pow(torch.clamp_min(tone, 0.0), 1.0 / gamma)


def gamma_only(hdr: torch.Tensor, gamma: float = DEFAULT_GAMMA) -> torch.Tensor:
    """Plain gamma correction (reference image_io.cpp gamma utility)."""
    return torch.pow(torch.clamp(hdr, 0.0, 1.0), 1.0 / gamma)
