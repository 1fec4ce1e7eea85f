"""The plain reference path tracer: the shared-sample estimator (one GGX
sample a bounce serves the light-MIS brdf term, the sky-MIS brdf term and
the continuation; light and sky NEE with shadow rays), the compacted
wavefront that each bounce partitions live rays to the front of, the
tiled frame with its key stream, and the trainer's loss.

A frozen copy, in its operation order, of ``trace_shared``'s fused path,
``render_rays`` and ``render`` (sycl_ray_tracing_tpu_torch/models/
pathtracer.py) and of ``make_train_step``'s loss (parallel/render.py) at
commit e337019, for triangle scenes with emissive triangles and a sky.
Everything the program derives from the inputs is worked out here again:
the light table, the triangle areas, the sky's tables, the camera, the
keys, and every scene query (geometry.Tree, no clusters).  It imports
nothing of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import rng
from benchmark.reference.geometry import (
    BIG_T,
    SHADOW_EPS,
    Tree,
    finalize_hit,
)
from benchmark.reference.shading import (
    RAY_OFFSET,
    Camera,
    Sky,
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
_JITTER, _LIGHT, _ENV, _CONT = 0, 1, 3, 5
# the smallest batch whose bounces run as a compacted wavefront
COMPACT_MIN_B = 8192


@dataclasses.dataclass
class Materials:
    emission: torch.Tensor    # [M,3]
    diffuse: torch.Tensor     # [M,3]
    metalness: torch.Tensor   # [M]
    roughness: torch.Tensor   # [M]

    def packed(self):
        return torch.cat([self.emission, self.diffuse,
                          self.metalness[:, None], self.roughness[:, None]],
                         dim=1)


class Scene:
    """The reference's scene, built from the benchmark's inputs alone:
    triangles [N,3,3], material index per triangle, the material table,
    the sky image and the camera's pose."""

    def __init__(self, inputs, device, dtype=torch.float32):
        self.dtype = dtype

        def f(x):
            return torch.tensor(np.asarray(x, np.float32),
                                device=device).to(dtype)

        tris_np = np.asarray(inputs.triangles, np.float32)
        mi = np.asarray(inputs.material_indices, np.int32)
        em = np.asarray(inputs.emission, np.float32)
        is_light = (em[mi] > 0.0).any(axis=-1) & (mi > 0)
        self.tris = f(tris_np)
        self.n_tris = tris_np.shape[0]
        self.mat_idx = torch.tensor(mi, device=device)
        self.materials = Materials(f(inputs.emission), f(inputs.diffuse),
                                   f(inputs.metalness), f(inputs.roughness))
        self.lights = torch.tensor(np.nonzero(is_light)[0], device=device)
        self.areas = triangle_area(self.tris)
        self.sky = Sky(inputs.sky, device, dtype)
        self.camera = Camera(*inputs.camera, device=device, dtype=dtype)
        self.tree = Tree(self.tris)

    def closest(self, o, d, live):
        tl = torch.full(o.shape[:1], BIG_T, dtype=o.dtype, device=o.device)
        return self.tree.query(o.detach(), d.detach(), tl, live,
                               any_hit=False)

    def blocked(self, o, d, tl, live):
        return self.tree.query(o.detach(), d.detach(), tl.detach(), live,
                               any_hit=True)


def _hit(scene: Scene, o, d, prim):
    t, point, normal, hit = finalize_hit(o, d, scene.tris, prim)
    mid = scene.mat_idx[torch.clamp(prim, 0, scene.n_tris - 1)]
    return dict(t=t, point=point, normal=normal, hit=hit, prim=prim, mid=mid)


def trace(scene: Scene, mats: Materials, ray_o, ray_d, key, bounces: int):
    """Radiance [B,3] of one shared-estimator path per ray; from
    COMPACT_MIN_B rays on, each bounce runs on the live rays partitioned
    to the front, on the smallest width bucket that holds them."""
    B = ray_o.shape[0]
    dev = ray_o.device
    dt = scene.dtype
    n_lights = scene.lights.shape[0]
    mat_packed = mats.packed()
    em_idx = scene.lights
    light_rows = torch.cat([
        scene.tris[em_idx].reshape(-1, 9),
        mats.emission[scene.mat_idx[em_idx].long()]], dim=1)
    sky = scene.sky

    hit0 = _hit(scene, ray_o, ray_d, scene.closest(
        ray_o, ray_d, torch.ones((B,), dtype=torch.bool, device=dev)))

    def bounce_core(bounce, ray_o, ray_d, hit, throughput, radiance, alive):
        W = ray_o.shape[0]
        live_hit = alive & hit["hit"]
        rows = mat_packed[hit["mid"].long()]
        emission, diffuse, metal, rough = (rows[:, 0:3], rows[:, 3:6],
                                           rows[:, 6], rows[:, 7])
        normal = hit["normal"]
        view = -ray_d
        if bounce == 0:
            radiance = radiance + torch.where(live_hit[:, None], emission,
                                              0.0)
        origin = hit["point"] + normal * RAY_OFFSET
        uc = rng.uniforms(key, bounce, _CONT, (W, 2), dev, dt)
        brdf_s, wi_s, pdf_s = ggx_sample(diffuse, metal, rough, view, normal,
                                         uc[:, 0], uc[:, 1])
        cos_s = torch.clamp_min(dot(normal, wi_s), 0.0)
        brdf_pos = torch.any(brdf_s > 0.0, dim=-1)
        cont_ok = (live_hit & (pdf_s >= 1e-8) & torch.isfinite(pdf_s)
                   & brdf_pos)
        u = rng.uniforms(key, bounce, _LIGHT, (W, 3), dev, dt)
        pick = torch.clamp_max((u[:, 0] * n_lights).to(torch.int64),
                               n_lights - 1)
        lr = light_rows[pick]
        lp, ln, area = sample_triangle_uniform(lr[:, 0:3], lr[:, 3:6],
                                               lr[:, 6:9], u[:, 1], u[:, 2])
        light_emission = lr[:, 9:12]
        pdf_area = 1.0 / torch.clamp_min(n_lights * area, 1e-12)
        to_light = lp - origin
        dist = torch.linalg.vector_norm(to_light, dim=-1)
        wi_l = to_light / torch.clamp_min(dist, 1e-12)[:, None]
        cos_light = torch.clamp_min(dot(ln, -wi_l), 0.0)
        front = cos_light > 0.0
        cos_surf = dot(normal, wi_l)
        light_mask = live_hit & front & (cos_surf > 0.0)
        u_e = rng.uniforms(key, bounce, _ENV, (W, 2), dev, dt)
        wi_e, env_rad, env_pdf = sky_sample(sky, u_e[:, 0], u_e[:, 1])
        cos_e = dot(normal, wi_e)
        env_mask = live_hit & (cos_e > 0.0)

        h2 = _hit(scene, origin, wi_s, scene.closest(origin, wi_s, cont_ok))
        shadowed = scene.blocked(origin, wi_l, dist - SHADOW_EPS, light_mask)
        blocked = scene.blocked(
            origin, wi_e, torch.full((W,), BIG_T, dtype=dt, device=dev),
            env_mask)
        area2 = scene.areas[torch.clamp(h2["prim"], 0, scene.n_tris - 1)]

        light_pdf = pdf_area * dist * dist / torch.clamp_min(cos_light, 1e-6)
        light_pdf = torch.where(front, light_pdf, 1.0)
        brdf_l = brdf_eval(diffuse, metal, rough, wi_l, view, normal)
        brdf_pdf_l = brdf_pdf(rough, view, wi_l, normal)
        mis_w = power_heuristic(light_pdf, brdf_pdf_l)
        ok = front & (~shadowed) & (brdf_pdf_l != 0.0) & (cos_surf > 0.0)
        direct = torch.zeros((W, 3), dtype=dt, device=dev)
        direct = direct + torch.where(
            ok[:, None], light_emission * (cos_surf * mis_w / torch.clamp_min(
                light_pdf, 1e-12))[:, None] * brdf_l, 0.0)
        hit_emission = mat_packed[h2["mid"].long()][:, 0:3]
        cos_at_light = torch.clamp_min(dot(h2["normal"], -wi_s), 0.0)
        is_emitter = torch.any(hit_emission > 0.0, dim=-1) & (
            h2["prim"] < scene.n_tris)
        t2_safe = torch.where(h2["hit"], h2["t"], 1.0)
        light_pdf2 = (t2_safe * t2_safe) / torch.clamp_min(
            area2 * cos_at_light, 1e-6)
        light_pdf2 = torch.where(h2["hit"] & (cos_at_light > 0.0),
                                 light_pdf2, 1.0)
        mis_w2 = power_heuristic(pdf_s, light_pdf2)
        ok2 = (h2["hit"] & is_emitter & (cos_at_light > 0.0)
               & (pdf_s > 0.0) & brdf_pos)
        direct = direct + torch.where(
            ok2[:, None], brdf_s * hit_emission * (cos_s * mis_w2 / (
                torch.clamp_min(pdf_s, 1e-12)))[:, None], 0.0)
        brdf_e = brdf_eval(diffuse, metal, rough, wi_e, view, normal)
        brdf_pdf_e = brdf_pdf(rough, view, wi_e, normal)
        mis_we = power_heuristic(env_pdf, brdf_pdf_e)
        ok_e = (cos_e > 0.0) & (~blocked) & (env_pdf > 0.0)
        direct = direct + torch.where(
            ok_e[:, None], brdf_e * env_rad * (cos_e * mis_we / (
                torch.clamp_min(env_pdf, 1e-12)))[:, None], 0.0)
        env_rad_s = sky_eval(sky.image, wi_s)
        env_pdf_s = sky_pdf(sky, wi_s)
        mis_ws = power_heuristic(pdf_s, env_pdf_s)
        ok_s = (~h2["hit"]) & cont_ok & (cos_s > 0.0)
        direct = direct + torch.where(
            ok_s[:, None], brdf_s * env_rad_s * (cos_s * mis_ws / (
                torch.clamp_min(pdf_s, 1e-12)))[:, None], 0.0)
        radiance = radiance + torch.where(live_hit[:, None],
                                          direct * throughput, 0.0)
        new_tp = throughput * brdf_s * (
            cos_s / torch.clamp_min(pdf_s, 1e-12))[:, None]
        throughput = torch.where(cont_ok[:, None], new_tp, throughput)
        ray_o = torch.where(cont_ok[:, None], origin, ray_o)
        ray_d = torch.where(cont_ok[:, None], wi_s, ray_d)
        return ray_o, ray_d, h2, throughput, radiance, cont_ok

    sky0 = sky_eval(sky.image, ray_d)
    radiance = torch.where((~hit0["hit"])[:, None], sky0, 0.0)
    throughput = torch.ones((B, 3), dtype=dt, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    if B < COMPACT_MIN_B:
        h = hit0
        for bounce in range(bounces):
            ray_o, ray_d, h, throughput, radiance, alive = bounce_core(
                bounce, ray_o, ray_d, h, throughput, radiance, alive)
        return radiance
    r256 = lambda x: -(-x // 256) * 256                    # noqa: E731
    widths = sorted({r256(max(256, B // d)) for d in (8, 4, 2)} | {B})
    state = dict(ray_o=ray_o, ray_d=ray_d, tp=throughput, rad=radiance,
                 alive=alive, ordmap=torch.arange(B, device=dev),
                 **{f"hit_{k}": v for k, v in hit0.items()})
    for bounce in range(bounces):
        perm = torch.argsort((~state["alive"]).to(torch.int32), stable=True)
        state = {k: v.index_select(0, perm) for k, v in state.items()}
        n_alive = int(state["alive"].sum())
        w = next(x for x in widths if x >= n_alive)
        h = {k[4:]: v[:w] for k, v in state.items() if k.startswith("hit_")}
        ro, rd, h2, tp, rad, alv = bounce_core(
            bounce, state["ray_o"][:w], state["ray_d"][:w], h,
            state["tp"][:w], state["rad"][:w], state["alive"][:w])
        new = dict(ray_o=ro, ray_d=rd, tp=tp, rad=rad, alive=alv,
                   **{f"hit_{k}": v for k, v in h2.items()})
        for k, v in new.items():
            state[k] = v if w == B else torch.cat([v, state[k][w:]])
    return state["rad"].index_select(0, torch.argsort(state["ordmap"]))


def render_rays(scene: Scene, mats: Materials, px, py, width: int,
                height: int, key, bounces: int):
    """HDR [B,3] of one jittered sample per pixel coordinate."""
    B = px.shape[0]
    ks = rng.fold_in(key, 0)
    uj = rng.uniforms(ks, 0, _JITTER, (B, 2), px.device, scene.dtype)
    jx = px + 0.5 + uj[:, 0] - 1.0
    jy = py + 0.5 + uj[:, 1] - 1.0
    ro, rd = scene.camera.rays(jx, jy, width, height)
    return trace(scene, mats, ro, rd, ks, bounces)


def pixels(width: int, height: int, device, dtype):
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return xs.reshape(-1).to(dtype), ys.reshape(-1).to(dtype)


@torch.no_grad()
def render_tile(scene: Scene, frame_key, tile: int, tile_rays: int,
                width: int, height: int, bounces: int):
    """HDR [tile_rays, 3] of tile ``tile`` of a 1-spp frame (rows of the
    flattened image, bottom row first; the last tile zero-padded), under
    the tile's key fold_in(frame_key, tile); a frame of one tile takes
    the frame's key."""
    px, py = pixels(width, height, scene.tris.device, scene.dtype)
    if tile_rays >= px.shape[0]:
        return render_rays(scene, scene.materials, px, py, width, height,
                           frame_key, bounces)
    pad = -px.shape[0] % tile_rays
    zeros = torch.zeros((pad,), dtype=scene.dtype, device=px.device)
    px, py = torch.cat([px, zeros]), torch.cat([py, zeros])
    sl = slice(tile * tile_rays, (tile + 1) * tile_rays)
    return render_rays(scene, scene.materials, px[sl], py[sl], width, height,
                       rng.fold_in(frame_key, tile), bounces)


def train_loss(scene: Scene, diffuse, roughness, key, width: int,
               height: int, bounces: int, tie_high=(False, False)):
    """The trainer's loss on one rank: the target under the scene's true
    materials, the guess under (diffuse, roughness), one sample a pixel
    with the same key stream, MSE in log1p space.  ``tie_high`` picks
    each render's tie rule (geometry.Tree); returns (loss, the ties the
    target's and the guess's scene queries met)."""
    px, py = pixels(width, height, scene.tris.device, scene.dtype)
    k = rng.fold_in(rng.fold_in(key, 0), 0)
    ties = []
    with torch.no_grad():
        scene.tree.tie_high, scene.tree.ties = tie_high[0], 0
        target = render_rays(scene, scene.materials, px, py, width, height,
                             k, bounces)
        ties.append(scene.tree.ties)
    guess = dataclasses.replace(scene.materials, diffuse=diffuse,
                                roughness=roughness)
    scene.tree.tie_high, scene.tree.ties = tie_high[1], 0
    hdr = render_rays(scene, guess, px, py, width, height, k, bounces)
    ties.append(scene.tree.ties)
    scene.tree.tie_high = False
    zero = torch.zeros_like(hdr)
    a = torch.log1p(torch.maximum(hdr, zero))
    b = torch.log1p(torch.maximum(target, zero))
    return torch.mean((a - b) ** 2), ties
