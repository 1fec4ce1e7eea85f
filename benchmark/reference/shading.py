"""The shading arithmetic of the plain reference: guarded math, the
sampling primitives, the Cook-Torrance BRDF with GGX importance sampling,
the equirectangular sky (tables, lookup, sampling, pdf) and the pinhole
camera.

Frozen copies, in their operation order, of the port's plain functions at
commit e337019 (sycl_ray_tracing_tpu_torch/ops/safe_math.py, sampling.py,
brdf.py, envmap.py, transform.py, models/camera.py), cut to what the
shared estimator uses.  Every function computes in the dtype of its
tensor arguments, so the control can run the same code in bfloat16.
"""

from __future__ import annotations

import math

import numpy as np
import torch

EPS = 1e-7          # Moller-Trumbore parallel-ray epsilon
RAY_OFFSET = 1e-4   # shadow and continuation ray origin offset
COL_BLK = 32        # column-CDF block width of the sky's two-level inversion


# --- guarded math -----------------------------------------------------

def safe_sqrt(x):
    return torch.sqrt(torch.clamp_min(x, 1e-20))


def safe_asin(x):
    return torch.arcsin(torch.clamp(x, -1.0 + 1e-7, 1.0 - 1e-7))


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(v):
    return safe_sqrt(dot(v, v))


def normalize(v):
    return v / length(v)[..., None]


def luminance(rgb):
    return 0.3086 * rgb[..., 0] + 0.6094 * rgb[..., 1] + 0.0820 * rgb[..., 2]


# --- sampling -----------------------------------------------------------

def branchless_onb(n):
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]],
        dim=-1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def to_world(n, local_dir):
    t, bt = branchless_onb(n)
    return (local_dir[..., 0:1] * t + local_dir[..., 1:2] * bt
            + local_dir[..., 2:3] * n)


def power_heuristic(pdf_a, pdf_b):
    r = torch.clamp(pdf_b / torch.clamp_min(pdf_a, 1e-20), 0.0, 1e8)
    w = 1.0 / (1.0 + r * r)
    return torch.where(pdf_a > 0.0, w, 0.0)


def sample_triangle_uniform(va, vb, vc, u1, u2):
    sqrt_r1 = torch.sqrt(torch.clamp_min(u1, 1e-20))
    u = 1.0 - sqrt_r1
    v = (1.0 - u2) * sqrt_r1
    ab = vb - va
    ac = vc - va
    p = va + ab * u[..., None] + ac * v[..., None]
    n = cross(ab, ac)
    ln = length(n)
    return p, n / ln[..., None], 0.5 * ln


def triangle_area(tris):
    ab = tris[..., 1, :] - tris[..., 0, :]
    ac = tris[..., 2, :] - tris[..., 0, :]
    return 0.5 * length(cross(ab, ac))


# --- Cook-Torrance BRDF ---------------------------------------------------

def _fresnel_schlick(f0, voh):
    return f0 + (1.0 - f0) * torch.pow(
        torch.clamp(1.0 - voh, 0.0, 1.0), 5.0)[..., None]


def _ggx_ndf(alpha, noh):
    noh = torch.clamp_max(noh, 0.999999)
    a2 = alpha * alpha
    b = noh * noh * (a2 - 1.0) + 1.0
    return a2 / (math.pi * b * b)


def _g1(k, d):
    return d / (d * (1.0 - k) + k)


def _terms(diffuse, metalness, alpha, nov, nol, noh, voh):
    f0 = 0.04 * (1.0 - metalness)[..., None] + metalness[..., None] * diffuse
    f = _fresnel_schlick(f0, voh)
    d = _ggx_ndf(alpha, noh)
    k = alpha / 2.0
    g = _g1(k, nol) * _g1(k, nov)
    kd = (1.0 - metalness)[..., None] * (1.0 - f)
    diffuse_part = kd * diffuse / math.pi
    denom = torch.clamp_min(4.0 * nov * nol, 1e-8)
    return diffuse_part + f * (d * g / denom)[..., None], d


def brdf_eval(diffuse, metalness, roughness, to_light, view, normal):
    h = normalize(view + to_light)
    nov = torch.clamp_min(dot(normal, view), 0.0)
    nol = torch.clamp_min(dot(normal, to_light), 0.0)
    noh = torch.clamp_min(dot(normal, h), 0.0)
    voh = torch.clamp_min(dot(h, view), 0.0)
    alpha = roughness * roughness
    value, _ = _terms(diffuse, metalness, alpha, nov, nol, noh, voh)
    valid = (nov > 0.0) & (nol > 0.0) & (noh > 0.0)
    return torch.where(valid[..., None], value, 0.0)


def brdf_pdf(roughness, view, to_light, normal):
    h = normalize(view + to_light)
    alpha = roughness * roughness
    voh = torch.clamp_min(dot(view, h), 0.0)
    noh = torch.clamp_min(dot(normal, h), 0.0)
    d = _ggx_ndf(alpha, noh)
    return torch.where(voh > 0.0, d * noh / torch.clamp_min(4.0 * voh, 1e-8),
                       0.0)


def ggx_sample(diffuse, metalness, roughness, view, normal, u1, u2):
    """(brdf [...,3], direction [...,3], pdf [...]) of one GGX-sampled
    reflection; zero brdf and pdf for samples below the surface."""
    alpha = roughness * roughness
    phi = 2.0 * math.pi * u1
    cos2 = (1.0 - u2) / (u2 * (alpha * alpha - 1.0) + 1.0)
    cos_theta = safe_sqrt(torch.clamp(cos2, 0.0, 1.0))
    sin_theta = safe_sqrt(torch.clamp_min(1.0 - cos2, 0.0))
    local_h = torch.stack(
        [torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta, cos_theta],
        dim=-1)
    h = to_world(normal, local_h)
    above = dot(h, normal) >= 0.0
    to_light = normalize(2.0 * dot(h, view)[..., None] * h - view)
    nov = torch.clamp_min(dot(normal, view), 0.0)
    nol = torch.clamp_min(dot(normal, to_light), 0.0)
    noh = torch.clamp_min(dot(normal, h), 0.0)
    voh = torch.clamp_min(dot(h, view), 0.0)
    valid = above & (nov > 0.0) & (nol > 0.0) & (noh > 0.0)
    value, d = _terms(diffuse, metalness, alpha, nov, nol, noh, voh)
    pdf = d * noh / torch.clamp_min(4.0 * voh, 1e-8)
    return (torch.where(valid[..., None], value, 0.0), to_light,
            torch.where(valid, pdf, 0.0))


# --- equirectangular sky --------------------------------------------------

def sky_tables(img_np: np.ndarray) -> dict:
    """The luminance CDF tables of a float32 [H,W,3] sky, in numpy."""
    lum = (0.3086 * img_np[..., 0] + 0.6094 * img_np[..., 1]
           + 0.0820 * img_np[..., 2])
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
    return dict(row_cdf=row_cdf, total=np.float32(total),
                cond_blk=cblk.astype(np.float32),
                cond_fine=fine.astype(np.float32))


class Sky:
    """A sky image on the device with its sampling tables."""

    def __init__(self, image_np: np.ndarray, device, dtype):
        img = np.asarray(image_np, np.float32)
        self.image = torch.tensor(img, device=device).to(dtype)
        for name, v in sky_tables(img).items():
            setattr(self, name,
                    torch.tensor(np.asarray(v, np.float32),
                                 device=device).to(dtype))


def _texel_of_direction(shape, direction):
    h, w = shape
    u = 0.5 + torch.atan2(direction[..., 2], direction[..., 0]) / (
        2.0 * math.pi)
    v = 0.5 + safe_asin(direction[..., 1]) / math.pi
    x = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    y = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return x, y


def sky_eval(image, direction):
    x, y = _texel_of_direction(image.shape[:2], direction)
    return image[y, x]


def _pdf_of_texel(sky: Sky, x, y, sin_theta):
    h, w = sky.image.shape[0], sky.image.shape[1]
    lum = luminance(sky.image.detach()[y, x])
    pdf = (lum / sky.total) * (w * h)
    return pdf / torch.clamp_min(2.0 * math.pi * math.pi * sin_theta, 1e-8)


def sky_sample(sky: Sky, u_row, u_col):
    """(direction, radiance, pdf) of texels drawn by luminance."""
    h, w = sky.image.shape[0], sky.image.shape[1]
    y = torch.searchsorted(sky.row_cdf, u_row * sky.total, right=True)
    y = torch.clamp(y, 0, h - 1)
    row_hi = sky.row_cdf[y]
    row_lo = torch.where(y > 0, sky.row_cdf[torch.clamp_min(y - 1, 0)], 0.0)
    row_sum = torch.clamp_min(row_hi - row_lo, 1e-12)
    target = (u_col * row_sum)[:, None]
    nb = sky.cond_blk.shape[1]
    blk_w = sky.cond_fine.shape[1]
    blk = torch.searchsorted(sky.cond_blk[y], target, right=True)[:, 0]
    blk = torch.clamp(blk, 0, nb - 1)
    fine = torch.searchsorted(sky.cond_fine[y * nb + blk], target,
                              right=True)[:, 0]
    x = torch.clamp(blk * blk_w + fine, 0, w - 1)
    u = x.to(sky.image.dtype) / w
    v = y.to(sky.image.dtype) / h
    phi = u * 2.0 * math.pi
    theta = v * math.pi
    sin_t = torch.sin(theta)
    cos_t = torch.cos(theta)
    direction = torch.stack(
        [-sin_t * torch.cos(phi), -cos_t, -sin_t * torch.sin(phi)], dim=-1)
    return direction, sky.image[y, x], _pdf_of_texel(sky, x, y, sin_t)


def sky_pdf(sky: Sky, direction):
    x, y = _texel_of_direction(sky.image.shape[:2], direction)
    sin_theta = torch.sqrt(torch.clamp_min(1.0 - direction[..., 1] ** 2,
                                           1e-12))
    return _pdf_of_texel(sky, x, y, sin_theta)


# --- pinhole camera ---------------------------------------------------------

def _scalars(*vals):
    return torch.stack([torch.as_tensor(v, dtype=torch.float32)
                        for v in vals])


def _translation(x, y, z):
    return _scalars(1.0, 0.0, 0.0, x, 0.0, 1.0, 0.0, y, 0.0, 0.0, 1.0, z,
                    0.0, 0.0, 0.0, 1.0).reshape(4, 4)


def _rotation_x(deg):
    r = torch.deg2rad(_scalars(deg)[0])
    c, s = torch.cos(r), torch.sin(r)
    return _scalars(1.0, 0.0, 0.0, 0.0, 0.0, c, -s, 0.0, 0.0, s, c, 0.0,
                    0.0, 0.0, 0.0, 1.0).reshape(4, 4)


class Camera:
    """The pinhole camera: ``rotation_x`` degrees about X after a
    translation, a -Z forward flip, ``fov`` the full field of view."""

    def __init__(self, fov: float, rotation_x: float, translation,
                 device, dtype):
        flip = torch.diag(torch.tensor([1.0, 1.0, -1.0, 1.0],
                                       dtype=torch.float32))
        pose = _rotation_x(rotation_x) @ _translation(*translation)
        self.view = (pose @ flip).to(device).to(dtype)
        self.fov_dist = torch.tensor(
            1.0 / math.tan(math.radians(fov) / 2.0), dtype=torch.float32,
            device=device).to(dtype)

    def _apply_point(self, p):
        m = self.view
        xyz = p @ m[:3, :3].T + m[:3, 3]
        w = p @ m[3, :3] + m[3, 3]
        return xyz / w[..., None]

    def rays(self, px, py, width: int, height: int):
        x_ndc = (px / width * 2.0 - 1.0) * (width / height)
        y_ndc = py / height * 2.0 - 1.0
        origin = self._apply_point(torch.zeros(px.shape + (3,),
                                               dtype=px.dtype,
                                               device=px.device))
        target = self._apply_point(torch.stack(
            [x_ndc, y_ndc, self.fov_dist.expand(px.shape)], dim=-1))
        direction = target - origin
        return origin, direction / torch.linalg.vector_norm(
            direction, dim=-1, keepdim=True)
