"""Post-process denoiser: edge-preserving à-trous wavelet filter
(counterpart of sycl_ray_tracing_tpu/utils/denoise.py).

Replaces the reference's OIDN integration (utils.cpp:144-196) as an
optional non-differentiable post hook.  Same API shape as the reference:
denoise an HDR framebuffer, then blend ``alpha*denoised +
(1-alpha)*noisy`` (utils.cpp:184-185; main.cpp emits blends 1.0/0.75/0.5).

Algorithm: N iterations of the à-trous (holes) B3-spline wavelet with a
luminance-guided range kernel (Dammertz et al. 2010), as torch ops on the
image's device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sycl_ray_tracing_tpu_torch.ops.safe_math import luminance

_B3 = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0


def _atrous_pass(img, step: int, sigma_color: float):
    """One à-trous iteration with spacing ``step`` (power of two)."""
    h, w = img.shape[0], img.shape[1]
    pad = 2 * step
    # edge padding of the [H,W,3] image (jnp.pad mode="edge")
    padded = F.pad(img.permute(2, 0, 1)[None], (pad, pad, pad, pad),
                   mode="replicate")[0].permute(1, 2, 0)
    lum_c = luminance(img)
    acc = torch.zeros_like(img)
    wsum = torch.zeros(img.shape[:2], dtype=img.dtype, device=img.device)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            # the float32 product, as the JAX package takes it
            wk = float(_B3[dy + 2] * _B3[dx + 2])
            y0 = pad + dy * step
            x0 = pad + dx * step
            shifted = padded[y0:y0 + h, x0:x0 + w]
            lum_s = luminance(shifted)
            # range weight: suppress contributions across radiance edges
            d = (lum_s - lum_c) ** 2
            wr = torch.exp(-d / (2.0 * sigma_color * sigma_color))
            wgt = wk * wr
            acc = acc + shifted * wgt[..., None]
            wsum = wsum + wgt
    return acc / torch.clamp_min(wsum, 1e-8)[..., None]


def denoise(hdr: torch.Tensor, iterations: int = 3,
            sigma_color: float = 0.4, blend: float = 1.0) -> torch.Tensor:
    """Denoise a linear HDR image [H,W,3] on its device.

    blend: 1.0 = fully denoised, 0.0 = original (reference blend semantics,
    utils.cpp:184-185).
    """
    out = hdr
    for i in range(iterations):
        out = _atrous_pass(out, 1 << i, sigma_color * (0.7 ** i))
    return blend * out + (1.0 - blend) * hdr
