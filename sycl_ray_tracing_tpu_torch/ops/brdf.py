"""Cook–Torrance BRDF: evaluation, pdf, and GGX-NDF importance sampling
plus the Lambertian term and VNDF sampling (counterpart of
sycl_ray_tracing_tpu/ops/brdf.py; reference render_kernel.cpp:213-451).

Material parameters are SoA: diffuse [...,3], metalness [...],
roughness [...].
"""

from __future__ import annotations

import math

import torch

from sycl_ray_tracing_tpu_torch.ops.safe_math import dot, normalize, safe_sqrt
from sycl_ray_tracing_tpu_torch.ops.sampling import branchless_onb, to_world


def lambertian_brdf(diffuse):
    """diffuse/pi (reference render_kernel.cpp:213-216)."""
    return diffuse / math.pi


def fresnel_schlick(f0, voh):
    """Schlick approximation (reference render_kernel.cpp:218-221)."""
    return f0 + (1.0 - f0) * torch.pow(
        torch.clamp(1.0 - voh, 0.0, 1.0), 5.0)[..., None]


def ggx_ndf(alpha, noh):
    """GGX/Trowbridge-Reitz D with the reference's NoH<=0.999999 clamp
    (render_kernel.cpp:223-233)."""
    noh = torch.clamp_max(noh, 0.999999)
    a2 = alpha * alpha
    b = noh * noh * (a2 - 1.0) + 1.0
    return a2 / (math.pi * b * b)


def _g1_schlick_ggx(k, d):
    return d / (d * (1.0 - k) + k)


def ggx_smith_g(alpha, nov, nol):
    """Smith masking-shadowing, Schlick-GGX G1 with k = alpha/2
    (reference render_kernel.cpp:235-245)."""
    k = alpha / 2.0
    return _g1_schlick_ggx(k, nol) * _g1_schlick_ggx(k, nov)


def _cook_torrance_terms(diffuse, metalness, alpha, nov, nol, noh, voh):
    """kD * diffuse/pi + F*D*G/(4 NoV NoL) (render_kernel.cpp:284-297)."""
    f0 = 0.04 * (1.0 - metalness)[..., None] + metalness[..., None] * diffuse
    f = fresnel_schlick(f0, voh)
    d = ggx_ndf(alpha, noh)
    g = ggx_smith_g(alpha, nov, nol)
    kd = (1.0 - metalness)[..., None] * (1.0 - f)
    diffuse_part = kd * diffuse / math.pi
    denom = torch.clamp_min(4.0 * nov * nol, 1e-8)
    specular_part = f * (d * g / denom)[..., None]
    return diffuse_part + specular_part, d


def cook_torrance_eval(diffuse, metalness, roughness, to_light, view, normal):
    """BRDF value [...,3] for given directions (render_kernel.cpp:260-301).
    ``view`` points toward the camera, ``to_light`` toward the light."""
    h = normalize(view + to_light)
    nov = torch.clamp_min(dot(normal, view), 0.0)
    nol = torch.clamp_min(dot(normal, to_light), 0.0)
    noh = torch.clamp_min(dot(normal, h), 0.0)
    voh = torch.clamp_min(dot(h, view), 0.0)
    alpha = roughness * roughness
    value, _ = _cook_torrance_terms(diffuse, metalness, alpha, nov, nol, noh,
                                    voh)
    valid = (nov > 0.0) & (nol > 0.0) & (noh > 0.0)
    return torch.where(valid[..., None], value, 0.0)


def cook_torrance_pdf(roughness, view, to_light, normal):
    """NDF-sampling pdf D*NoH/(4 VoH) (render_kernel.cpp:247-258)."""
    h = normalize(view + to_light)
    alpha = roughness * roughness
    voh = torch.clamp_min(dot(view, h), 0.0)
    noh = torch.clamp_min(dot(normal, h), 0.0)
    d = ggx_ndf(alpha, noh)
    return torch.where(voh > 0.0, d * noh / torch.clamp_min(4.0 * voh, 1e-8),
                       0.0)


def ggx_vndf_sample(roughness, view, normal, u1, u2):
    """Visible-normal (VNDF) GGX sampling by the spherical-cap method
    (Dupuy & Benyoub 2023; the reference's unused alternative sampler,
    render_kernel.cpp:303-370).  Returns (microfacet normal [...,3],
    pdf [...]) with pdf = G1(view) D(h) max(0, v.h) / v.n."""
    alpha = roughness * roughness
    t, b = branchless_onb(normal)
    v_local = torch.stack([dot(view, t), dot(view, b), dot(view, normal)],
                          dim=-1)
    # warp view to the hemisphere configuration
    vs = normalize(torch.stack(
        [v_local[..., 0] * alpha, v_local[..., 1] * alpha, v_local[..., 2]],
        dim=-1))
    # sample a spherical cap in (-vs.z, 1]
    phi = 2.0 * math.pi * u1
    z = 1.0 - u2 - u2 * vs[..., 2]
    sin_t = safe_sqrt(torch.clamp(1.0 - z * z, 0.0, 1.0))
    c = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), z],
                    dim=-1)
    h_std = c + vs
    # warp back to the ellipsoid configuration
    h_local = normalize(torch.stack(
        [h_std[..., 0] * alpha, h_std[..., 1] * alpha,
         torch.clamp_min(h_std[..., 2], 1e-6)], dim=-1))
    h = (h_local[..., 0:1] * t + h_local[..., 1:2] * b
         + h_local[..., 2:3] * normal)
    nov = torch.clamp_min(dot(normal, view), 1e-6)
    noh = torch.clamp_min(dot(normal, h), 0.0)
    voh = torch.clamp_min(dot(view, h), 0.0)
    a2 = alpha * alpha
    lam = safe_sqrt(a2 + (1.0 - a2) * nov * nov) + nov
    g1 = 2.0 * nov / lam
    pdf = g1 * ggx_ndf(alpha, noh) * voh / torch.clamp_min(nov, 1e-6)
    return h, pdf


def ggx_importance_sample(diffuse, metalness, roughness, view, normal, u1,
                          u2, reference_bug: bool = False):
    """Sample a GGX microfacet normal, reflect, and evaluate in one call
    (reference cook_torrance_brdf_importance_sample,
    render_kernel.cpp:392-451).  Returns (brdf [...,3], direction [...,3],
    pdf [...]); brdf and pdf are zero for below-surface samples.

    ``reference_bug=True`` replicates the reference's sampler verbatim
    (acos of the cos^2 expression without the square root,
    render_kernel.cpp:404) for bug-for-bug image parity."""
    alpha = roughness * roughness
    phi = 2.0 * math.pi * u1
    cos2 = (1.0 - u2) / (u2 * (alpha * alpha - 1.0) + 1.0)
    if reference_bug:
        cos_theta = torch.clamp(cos2, 0.0, 1.0)
        sin_theta = safe_sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
    else:
        cos_theta = safe_sqrt(torch.clamp(cos2, 0.0, 1.0))
        sin_theta = safe_sqrt(torch.clamp_min(1.0 - cos2, 0.0))
    local_h = torch.stack(
        [torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta],
        dim=-1,
    )
    h = to_world(normal, local_h)
    above = dot(h, normal) >= 0.0
    to_light = normalize(2.0 * dot(h, view)[..., None] * h - view)

    nov = torch.clamp_min(dot(normal, view), 0.0)
    nol = torch.clamp_min(dot(normal, to_light), 0.0)
    noh = torch.clamp_min(dot(normal, h), 0.0)
    voh = torch.clamp_min(dot(h, view), 0.0)
    valid = above & (nov > 0.0) & (nol > 0.0) & (noh > 0.0)

    value, d = _cook_torrance_terms(diffuse, metalness, alpha, nov, nol, noh,
                                    voh)
    pdf = d * noh / torch.clamp_min(4.0 * voh, 1e-8)
    brdf = torch.where(valid[..., None], value, 0.0)
    pdf = torch.where(valid, pdf, 0.0)
    return brdf, to_light, pdf
