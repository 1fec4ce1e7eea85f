"""The parity estimator's reference (``estimator="parity"``, the port's
``trace``): the upstream renderer's own bounce (render_kernel.cpp:96-161).
Each bounce makes one closest hit, then light NEE (a shadow ray toward a
point drawn on an emissive triangle, and a GGX-sampled closest hit that
may land on one; two-sided power-heuristic MIS, :633-713), then sky NEE
(a shadow ray toward a direction drawn from the sky, and one along a
GGX sample; two-sided MIS, :569-631), then a GGX-sampled continuation.
That is five scene queries a bounce, each over every ray of the batch,
with no compaction.

A copy, in the port's operation order, of ``trace`` (nee=True),
``_sample_lights_nee``, ``_sample_env_nee`` and the parity branch of
``render_rays`` (sycl_ray_tracing_tpu_torch/models/pathtracer.py), for
triangle scenes with emissive triangles and a sky: the same key tags,
origin offsets (RAY_OFFSET, and 1e-5 on the two GGX-sampled NEE rays,
render_kernel.cpp:684, :615), masks and clamps.  Plain PyTorch on the
shared geometry (``pathtrace.Scene``: the exact Morton tree and its tie
rules) and the frozen shading arithmetic; it imports nothing of the
program.  Every function computes in the scene's dtype, so the control
can run it in bfloat16.

Where the port departs from render_kernel.cpp, this copy departs too:
  * random numbers: counter-based threefry keyed by (tile, sample,
    bounce, purpose tag) in place of the per-pixel stateful xorshift
    (xorshift.h:10-31, seeded :77-82), so the same key gives the same
    image whatever the batch;
  * the GGX sampler takes cos(theta) as the square root of the cos^2
    expression; upstream takes the expression itself (:404), which the
    port keeps only under ``ggx_sampler="reference"``;
  * the per-pixel state machine (BOUNCE / MISSED / TERMINATED) is a
    mask over the batch: a dead path's lanes still run every query and
    add nothing;
  * guards against NaN on masked lanes: pdfs clamped below (1e-12 on
    the sampled pdfs, 1e-6 on the cosines of the light pdfs), the light
    pdf 1 on a back-facing sample, a miss's t read as 1 before squaring.
No Russian roulette, as upstream.
"""

from __future__ import annotations

import torch

from benchmark.reference import rng
from benchmark.reference.geometry import BIG_T, SHADOW_EPS
from benchmark.reference.pathtrace import _hit, pixels
from benchmark.reference.shading import (
    RAY_OFFSET,
    brdf_eval,
    brdf_pdf,
    dot,
    ggx_sample,
    power_heuristic,
    sample_triangle_uniform,
    sky_eval,
    sky_pdf,
    sky_sample,
    triangle_area,
)

# purpose tags of the key stream, one stream per random decision
_JITTER, _LIGHT, _NEE_BRDF, _ENV, _ENV_BRDF, _CONT = 0, 1, 2, 3, 4, 5
# origin offset of the two GGX-sampled NEE rays (render_kernel.cpp:684,
# :615)
NEE_OFFSET = 1e-5


def _closest(scene, o, d, mask):
    """The hit record of the closest hit along each ray under ``mask``
    (t, point, normal, hit, prim, mid); rays outside it miss."""
    return _hit(scene, o, d, scene.closest(o, d, mask))


def _blocked(scene, o, d, t_max, mask):
    """A triangle at t < t_max - SHADOW_EPS; ``t_max`` None: at any t."""
    if t_max is None:
        t_max = torch.full(o.shape[:1], BIG_T, dtype=o.dtype,
                           device=o.device)
    return scene.blocked(o, d, t_max - SHADOW_EPS, mask)


def light_nee(scene, hit, view, diffuse, metal, rough, key, bounce: int,
              live):
    """Light NEE, both MIS terms: the light-sample term with its shadow
    ray, then the brdf-sample term through a GGX-sampled closest hit."""
    B = hit["t"].shape[0]
    dev, dt = hit["t"].device, scene.dtype
    n_lights = scene.lights.shape[0]
    mats = scene.materials
    normal = hit["normal"]
    radiance = torch.zeros((B, 3), dtype=dt, device=dev)
    if n_lights == 0:
        return radiance
    u = rng.uniforms(key, bounce, _LIGHT, (B, 3), dev, dt)

    pick = torch.clamp_max((u[:, 0] * n_lights).to(torch.int64),
                           n_lights - 1)
    light_tri = scene.lights[pick]
    tri = scene.tris[light_tri.long()]
    lp, ln, area = sample_triangle_uniform(tri[:, 0], tri[:, 1], tri[:, 2],
                                           u[:, 1], u[:, 2])
    pdf_area = 1.0 / torch.clamp_min(n_lights * area, 1e-12)
    origin = hit["point"] + normal * RAY_OFFSET
    to_light = lp - origin
    dist = torch.linalg.vector_norm(to_light, dim=-1)
    wi = to_light / torch.clamp_min(dist, 1e-12)[:, None]
    cos_light = torch.clamp_min(dot(ln, -wi), 0.0)
    front = cos_light > 0.0
    cos_surf = dot(normal, wi)
    shadowed = _blocked(scene, origin, wi, dist,
                        live & hit["hit"] & front & (cos_surf > 0.0))
    light_pdf = pdf_area * dist * dist / torch.clamp_min(cos_light, 1e-6)
    light_pdf = torch.where(front, light_pdf, 1.0)
    light_emission = mats.emission[scene.mat_idx[light_tri].long()]
    brdf = brdf_eval(diffuse, metal, rough, wi, view, normal)
    pdf_b = brdf_pdf(rough, view, wi, normal)
    mis_w = power_heuristic(light_pdf, pdf_b)
    contrib = (light_emission * (cos_surf * mis_w / torch.clamp_min(
        light_pdf, 1e-12))[:, None] * brdf)
    ok = hit["hit"] & front & (~shadowed) & (pdf_b != 0.0) & (cos_surf > 0.0)
    radiance = radiance + torch.where(ok[:, None], contrib, 0.0)

    ub = rng.uniforms(key, bounce, _NEE_BRDF, (B, 2), dev, dt)
    brdf_s, wi_s, pdf_s = ggx_sample(diffuse, metal, rough, view, normal,
                                     ub[:, 0], ub[:, 1])
    brdf_pos = torch.any(brdf_s > 0.0, dim=-1)
    origin_s = hit["point"] + normal * NEE_OFFSET
    h2 = _closest(scene, origin_s, wi_s,
                  live & hit["hit"] & (pdf_s > 0.0) & brdf_pos)
    n = scene.n_tris
    cos_at_light = torch.clamp_min(dot(h2["normal"], -wi_s), 0.0)
    hit_emission = mats.emission[h2["mid"].long()]
    is_emitter = torch.any(hit_emission > 0.0, dim=-1) & (h2["prim"] < n)
    area2 = triangle_area(scene.tris[torch.clamp(h2["prim"], 0, n - 1)])
    t2_safe = torch.where(h2["hit"], h2["t"], 1.0)
    light_pdf2 = (t2_safe * t2_safe) / torch.clamp_min(area2 * cos_at_light,
                                                       1e-6)
    light_pdf2 = torch.where(h2["hit"] & (cos_at_light > 0.0), light_pdf2,
                             1.0)
    mis_w2 = power_heuristic(pdf_s, light_pdf2)
    cos_surf2 = dot(normal, wi_s)
    contrib2 = brdf_s * hit_emission * (cos_surf2 * mis_w2 / torch.clamp_min(
        pdf_s, 1e-12))[:, None]
    ok2 = (hit["hit"] & h2["hit"] & is_emitter & (cos_at_light > 0.0)
           & (pdf_s > 0.0) & brdf_pos)
    return radiance + torch.where(ok2[:, None], contrib2, 0.0)


def env_sample_term(scene, hit, view, diffuse, metal, rough, key,
                    bounce: int, live):
    """Sky NEE's sky-sample term: a direction drawn from the sky's
    tables, its shadow ray, weighted against the brdf's pdf."""
    B = hit["t"].shape[0]
    dev, dt = hit["t"].device, scene.dtype
    normal = hit["normal"]
    u = rng.uniforms(key, bounce, _ENV, (B, 2), dev, dt)
    wi, env_rad, env_pdf = sky_sample(scene.sky, u[:, 0], u[:, 1])
    cos_term = dot(normal, wi)
    origin = hit["point"] + normal * RAY_OFFSET
    blocked = _blocked(scene, origin, wi, None,
                       live & hit["hit"] & (cos_term > 0.0))
    brdf = brdf_eval(diffuse, metal, rough, wi, view, normal)
    pdf_b = brdf_pdf(rough, view, wi, normal)
    mis_w = power_heuristic(env_pdf, pdf_b)
    contrib = brdf * env_rad * (cos_term * mis_w / torch.clamp_min(
        env_pdf, 1e-12))[:, None]
    ok = hit["hit"] & (cos_term > 0.0) & (~blocked) & (env_pdf > 0.0)
    return torch.where(ok[:, None], contrib, 0.0)


def env_brdf_term(scene, hit, view, diffuse, metal, rough, key,
                  bounce: int, live):
    """Sky NEE's brdf-sample term: a GGX sample, its shadow ray, the sky
    along it weighted against the sky's pdf."""
    B = hit["t"].shape[0]
    dev, dt = hit["t"].device, scene.dtype
    normal = hit["normal"]
    ub = rng.uniforms(key, bounce, _ENV_BRDF, (B, 2), dev, dt)
    brdf_s, wi_s, pdf_s = ggx_sample(diffuse, metal, rough, view, normal,
                                     ub[:, 0], ub[:, 1])
    cos_s = torch.clamp_min(dot(normal, wi_s), 0.0)
    origin_s = hit["point"] + normal * NEE_OFFSET
    blocked_s = _blocked(scene, origin_s, wi_s, None,
                         live & hit["hit"] & (pdf_s > 0.0) & (cos_s > 0.0))
    env_rad_s = sky_eval(scene.sky.image, wi_s)
    env_pdf_s = sky_pdf(scene.sky, wi_s)
    mis_w_s = power_heuristic(pdf_s, env_pdf_s)
    contrib_s = brdf_s * env_rad_s * (cos_s * mis_w_s / torch.clamp_min(
        pdf_s, 1e-12))[:, None]
    ok_s = hit["hit"] & (pdf_s > 0.0) & (cos_s > 0.0) & (~blocked_s)
    return torch.where(ok_s[:, None], contrib_s, 0.0)


def env_nee(scene, hit, view, diffuse, metal, rough, key, bounce: int,
            live):
    """Sky NEE, both MIS terms, summed as the port sums them."""
    radiance = torch.zeros((hit["t"].shape[0], 3), dtype=scene.dtype,
                           device=hit["t"].device)
    radiance = radiance + env_sample_term(scene, hit, view, diffuse, metal,
                                          rough, key, bounce, live)
    return radiance + env_brdf_term(scene, hit, view, diffuse, metal, rough,
                                    key, bounce, live)


def trace(scene, ray_o, ray_d, key, bounces: int):
    """Radiance [B,3] of one parity path per ray."""
    B = ray_o.shape[0]
    dev, dt = ray_o.device, scene.dtype
    packed = scene.materials.packed()
    throughput = torch.ones((B, 3), dtype=dt, device=dev)
    radiance = torch.zeros((B, 3), dtype=dt, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    for bounce in range(bounces):
        hit = _closest(scene, ray_o, ray_d, alive)
        live_hit = alive & hit["hit"]
        rows = packed[hit["mid"].long()]
        emission, diffuse, metal, rough = (rows[:, 0:3], rows[:, 3:6],
                                           rows[:, 6], rows[:, 7])
        normal = hit["normal"]
        view = -ray_d
        # emission only on primary hits (render_kernel.cpp:126-127)
        if bounce == 0:
            radiance = radiance + torch.where(live_hit[:, None], emission,
                                              0.0)
        light = light_nee(scene, hit, view, diffuse, metal, rough, key,
                          bounce, live_hit)
        env = env_nee(scene, hit, view, diffuse, metal, rough, key, bounce,
                      live_hit)
        direct = light + env
        radiance = radiance + torch.where(live_hit[:, None],
                                          direct * throughput, 0.0)
        # the sky on a miss, primary rays only (:146-158)
        if bounce == 0:
            sky = sky_eval(scene.sky.image, ray_d)
            radiance = radiance + torch.where(
                (alive & ~hit["hit"])[:, None], sky * throughput, 0.0)
        uc = rng.uniforms(key, bounce, _CONT, (B, 2), dev, dt)
        brdf_c, wi_c, pdf_c = ggx_sample(diffuse, metal, rough, view, normal,
                                         uc[:, 0], uc[:, 1])
        ok_c = (live_hit & (pdf_c >= 1e-8) & torch.isfinite(pdf_c)
                & torch.any(brdf_c > 0.0, dim=-1))
        cos_c = torch.clamp_min(dot(wi_c, normal), 0.0)
        new_tp = throughput * brdf_c * (cos_c / torch.clamp_min(
            pdf_c, 1e-12))[:, None]
        throughput = torch.where(ok_c[:, None], new_tp, throughput)
        new_o = hit["point"] + normal * RAY_OFFSET
        ray_o = torch.where(ok_c[:, None], new_o, ray_o)
        ray_d = torch.where(ok_c[:, None], wi_c, ray_d)
        alive = ok_c
    return radiance


def render_rays(scene, px, py, width: int, height: int, key, bounces: int):
    """HDR [B,3] of one jittered sample per pixel coordinate."""
    B = px.shape[0]
    ks = rng.fold_in(key, 0)
    uj = rng.uniforms(ks, 0, _JITTER, (B, 2), px.device, scene.dtype)
    jx = px + 0.5 + uj[:, 0] - 1.0
    jy = py + 0.5 + uj[:, 1] - 1.0
    ro, rd = scene.camera.rays(jx, jy, width, height)
    return trace(scene, ro, rd, ks, bounces)


@torch.no_grad()
def render_tile(scene, frame_key, tile: int, tile_rays: int, width: int,
                height: int, bounces: int):
    """HDR [tile_rays, 3] of tile ``tile`` of a 1-spp frame, as
    ``pathtrace.render_tile`` lays tiles out and keys them.  TF32 is off:
    every product here is float32 (or the control's dtype)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    px, py = pixels(width, height, scene.tris.device, scene.dtype)
    if tile_rays >= px.shape[0]:
        return render_rays(scene, px, py, width, height, frame_key, bounces)
    pad = -px.shape[0] % tile_rays
    zeros = torch.zeros((pad,), dtype=scene.dtype, device=px.device)
    px, py = torch.cat([px, zeros]), torch.cat([py, zeros])
    sl = slice(tile * tile_rays, (tile + 1) * tile_rays)
    return render_rays(scene, px[sl], py[sl], width, height,
                       rng.fold_in(frame_key, tile), bounces)
