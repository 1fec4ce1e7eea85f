"""Equirectangular environment map: lookup, luminance CDF, importance
sampling (counterpart of sycl_ray_tracing_tpu/ops/envmap.py).

The separable row/column CDF is built in numpy exactly as the JAX
package's host path builds it, so the tables are bit-identical; the
inversions are ``torch.searchsorted(right=True)`` (the JAX package's
dense compare-and-count computes the same index).

Differentiable w.r.t. the texels, as in the JAX package: radiance
lookups are gathers, so gradients scatter into ``image``; the CDF tables
and the luminance in the pdf are detached (the detached-sampling
estimator).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from sycl_ray_tracing_tpu_torch.ops.safe_math import luminance, safe_asin
from sycl_ray_tracing_tpu_torch.utils.device import resolve_device

COL_BLK = 32  # column-CDF block width for the two-level inversion


class EnvMapSampler(NamedTuple):
    """Sampling tables for an equirect env map [H,W,3] (see the JAX
    package's EnvMapSampler for the two-level column CDF)."""

    image: torch.Tensor       # [H,W,3] radiance texels
    row_cdf: torch.Tensor     # [H] inclusive prefix sum of row luminance sums
    cond_cdf: torch.Tensor    # [H,W] inclusive prefix sums within each row
    total: torch.Tensor       # [] total luminance
    cond_blk: torch.Tensor    # [H,NB] block-end cdf (NB = ceil(W/COL_BLK))
    cond_fine: torch.Tensor   # [H*NB, COL_BLK] blocked cdf, pad=+inf


def build_sampler(image, device="cuda") -> EnvMapSampler:
    """Build the separable CDF tables on the host, then move them to
    ``device``.  A torch ``image`` stays the sampler's image, graph and
    device included, so texel gradients reach it; its tables are built
    from its detached values (one host copy per build) on the image's
    device, whatever ``device`` says."""
    if isinstance(image, torch.Tensor):
        tables = _host_tables(image.detach().cpu().numpy())
        return EnvMapSampler(image=image, **{
            f: torch.tensor(v, device=image.device) for f, v in tables.items()})
    img_np = np.asarray(image, np.float32)
    return sampler_from_numpy(dict(image=img_np, **_host_tables(img_np)),
                              resolve_device(device))


def _host_tables(img_np: np.ndarray) -> dict:
    """The sampler's tables from a float32 [H,W,3] image, in numpy
    (the JAX package's host path, envmap.py:67-93)."""
    lum = (
        0.3086 * img_np[..., 0]
        + 0.6094 * img_np[..., 1]
        + 0.0820 * img_np[..., 2]
    )
    cond_cdf = np.cumsum(lum, axis=1, dtype=np.float32)
    row_cdf = np.cumsum(cond_cdf[:, -1], dtype=np.float32)
    total = np.maximum(row_cdf[-1], 1e-12)
    h, w = lum.shape
    blk = min(COL_BLK, w)
    nb = -(-w // blk)
    pad = nb * blk - w
    fine = np.pad(cond_cdf, ((0, 0), (0, pad)),
                  constant_values=np.inf).reshape(h * nb, blk)
    cblk = fine.reshape(h, nb, blk)[:, :, -1]
    cblk = np.where(np.isinf(cblk), cond_cdf[:, -1:].repeat(nb, 1), cblk)
    return dict(row_cdf=row_cdf, cond_cdf=cond_cdf, total=np.float32(total),
                cond_blk=cblk.astype(np.float32),
                cond_fine=fine.astype(np.float32))


def sampler_from_numpy(arrays: dict, device) -> EnvMapSampler:
    """EnvMapSampler from host arrays named like its fields."""
    return EnvMapSampler(**{
        f: torch.tensor(np.asarray(arrays[f], np.float32), device=device)
        for f in EnvMapSampler._fields
    })


def texel_coords_of_direction(shape, direction):
    """(x, y) integer texel coords of directions [...,3]."""
    h, w = shape
    u = 0.5 + torch.atan2(direction[..., 2], direction[..., 0]) / (2.0 * math.pi)
    v = 0.5 + safe_asin(direction[..., 1]) / math.pi
    x = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return x, y


def eval_direction(image: torch.Tensor, direction: torch.Tensor):
    """Nearest-texel lat/long lookup (reference render_kernel.cpp:520-530)."""
    x, y = texel_coords_of_direction(image.shape[:2], direction)
    return image[y, x]


def sample(sampler: EnvMapSampler, u_row, u_col):
    """Importance-sample texels proportional to luminance.

    u_row, u_col: uniforms [B].  Returns (direction [B,3], radiance [B,3],
    pdf [B], sin_theta [B])."""
    h, w = sampler.image.shape[0], sampler.image.shape[1]
    y = torch.searchsorted(sampler.row_cdf, u_row * sampler.total, right=True)
    y = torch.clamp(y, 0, h - 1)

    row_hi = sampler.row_cdf[y]
    row_lo = torch.where(y > 0, sampler.row_cdf[torch.clamp_min(y - 1, 0)],
                         0.0)
    row_sum = torch.clamp_min(row_hi - row_lo, 1e-12)
    # two-level column inversion: full blocks by their end-cdf, then the
    # count inside the boundary block (equal to the dense count, see the
    # JAX package's EnvMapSampler)
    target = (u_col * row_sum)[:, None]
    nb = sampler.cond_blk.shape[1]
    blk_w = sampler.cond_fine.shape[1]
    blk = torch.searchsorted(sampler.cond_blk[y], target, right=True)[:, 0]
    blk = torch.clamp(blk, 0, nb - 1)
    fine = torch.searchsorted(sampler.cond_fine[y * nb + blk], target,
                              right=True)[:, 0]
    x = torch.clamp(blk * blk_w + fine, 0, w - 1)

    # texel-corner direction, replicated from render_kernel.cpp:576-586
    u = x.to(torch.float32) / w
    v = y.to(torch.float32) / h
    phi = u * 2.0 * math.pi
    theta = v * math.pi
    sin_t = torch.sin(theta)
    cos_t = torch.cos(theta)
    direction = torch.stack(
        [-sin_t * torch.cos(phi), -cos_t, -sin_t * torch.sin(phi)], dim=-1
    )
    radiance = sampler.image[y, x]
    pdf = pdf_of_texel(sampler, x, y, sin_t)
    return direction, radiance, pdf, sin_t


def pdf_of_texel(sampler: EnvMapSampler, x, y, sin_theta):
    """Solid-angle pdf of picking texel (x,y):
    (lum/total) * W*H / (2 pi^2 sin(theta)) (render_kernel.cpp:594-595)."""
    h, w = sampler.image.shape[0], sampler.image.shape[1]
    lum = luminance(sampler.image.detach()[y, x])
    pdf = (lum / sampler.total) * (w * h)
    return pdf / torch.clamp_min(2.0 * math.pi * math.pi * sin_theta, 1e-8)


def importance_split(image, min_bin_area: int, min_bin_radiance: float):
    """Hierarchical radiance-bin splitting of an env map (the reference's
    unused Utils::importance_split_skysphere, utils.cpp:197-247): halve
    the image along its longer axis until a bin's summed luminance or area
    falls under the thresholds.  Host-side numpy (envmap.py:228-274);
    returns a list of (x0, x1, y0, y1) bins."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    img = np.asarray(image, np.float32)
    lum = 0.3086 * img[..., 0] + 0.6094 * img[..., 1] + 0.0820 * img[..., 2]
    integral = lum.cumsum(axis=0).cumsum(axis=1)

    def area_lum(x0, x1, y0, y1):
        a = integral[y1 - 1, x1 - 1]
        b = integral[y0 - 1, x1 - 1] if y0 > 0 else 0.0
        c = integral[y1 - 1, x0 - 1] if x0 > 0 else 0.0
        d = integral[y0 - 1, x0 - 1] if (x0 > 0 and y0 > 0) else 0.0
        return a - b - c + d

    out = []
    stack = [(0, img.shape[1], 0, img.shape[0])]
    while stack:
        x0, x1, y0, y1 = stack.pop()
        rad = area_lum(x0, x1, y0, y1)
        # the true area (the reference squares the vertical extent,
        # utils.cpp:201); the precedence of or/and is the JAX package's
        if (
            rad <= min_bin_radiance
            or (x1 - x0) * (y1 - y0) <= min_bin_area
            or (x1 - x0) < 2
            and (y1 - y0) < 2
        ):
            out.append((x0, x1, y0, y1))
            continue
        if (y1 - y0) >= (x1 - x0):
            ym = y0 + (y1 - y0) // 2
            stack.append((x0, x1, y0, ym))
            stack.append((x0, x1, ym, y1))
        else:
            xm = x0 + (x1 - x0) // 2
            stack.append((x0, xm, y0, y1))
            stack.append((xm, x1, y0, y1))
    return out


def pdf_of_direction(sampler: EnvMapSampler, direction):
    """pdf of a world direction under luminance sampling, using the true
    polar angle (y axis) as the JAX package does (render_kernel.cpp:617-623)."""
    x, y = texel_coords_of_direction(sampler.image.shape[:2], direction)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - direction[..., 1] ** 2, 1e-12))
    return pdf_of_texel(sampler, x, y, sin_theta)
