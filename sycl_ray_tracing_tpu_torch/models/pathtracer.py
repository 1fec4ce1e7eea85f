"""The path-tracing integrator (counterpart of
sycl_ray_tracing_tpu/models/pathtracer.py).

Ported here: ``trace_shared`` on its FUSED list path (pathtracer.py:
528-1059) — one GGX sample per bounce shared by the light-MIS brdf term,
the env-MIS brdf term and the continuation ray, with each bounce's
continuation closest-hit and its light and env shadow rays traced in ONE
``multi_query`` launch — plus ``render_rays`` and ``render``.  At
B >= COMPACT_MIN_B rays the bounce loop runs as a compacted wavefront:
each bounce stable-partitions live rays to a prefix and runs on the
smallest width bucket covering them, exactly as the JAX package does, so
lanes (and with them the lane-keyed RNG draws) match.

RNG keys are explicit (ops/rng.py) and bit-exact with jax.random, so the
port draws the same samples as the JAX package.

Differentiable w.r.t. materials, env-map texels, triangle vertices and
camera pose, as the JAX package is: traversal records no graph (the list
tracer runs under ``torch.no_grad()``), and gradients flow through
``finalize_hit``'s re-intersection of each winner and the shading.  With
``remat`` (the default) each bounce, and each sample when a tile takes
several, runs under ``torch.utils.checkpoint`` and is replayed in the
backward pass from its explicit keys; the replay takes the list tracer's
answers recorded on the first run (``_QueryTape``) instead of tracing
again, like the JAX package's remat policy that saves the traversal
outputs (pathtracer.py:54-64).  Forward-only callers wrap their calls in
``torch.no_grad()``, which also skips the checkpoints.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from sycl_ray_tracing_tpu_torch.models.camera import Camera
from sycl_ray_tracing_tpu_torch.models.scene import (
    MAX_SLOT_MATERIALS,
    SLOT_TRI_BITS,
    Scene,
)
from sycl_ray_tracing_tpu_torch.ops import envmap as env_ops
from sycl_ray_tracing_tpu_torch.ops.brdf import (
    cook_torrance_eval,
    cook_torrance_pdf,
    ggx_importance_sample,
)
from sycl_ray_tracing_tpu_torch.ops.cluster import SHADOW_EPS, T_CLUSTER
from sycl_ray_tracing_tpu_torch.ops.intersect import Hit, finalize_hit
from sycl_ray_tracing_tpu_torch.ops.kernels.listtrace import multi_query
from sycl_ray_tracing_tpu_torch.ops.rng import fold_in, uniforms
from sycl_ray_tracing_tpu_torch.ops.safe_math import RAY_OFFSET, dot
from sycl_ray_tracing_tpu_torch.ops.sampling import (
    power_heuristic,
    sample_triangle_uniform,
)
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig

# block-shared list kernel for the (coherent) primary rays
PRIMARY_SHARE = True

# Minimum batch for the compacted bounce loop; tests lower it (on both
# packages) to force the compacted path on small batches.
COMPACT_MIN_B = 8192

# purpose tags for key folding — one stream per random decision
_JITTER = 0
_LIGHT = 1       # light pick + area sample (3 uniforms)
_ENV = 3         # env CDF row/col (2)
_CONT = 5        # GGX sample shared by the continuation and both MIS terms

_HIT_FIELDS = ("t", "point", "normal", "uv", "prim", "hit")


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet: ROADMAP Queue 1, {item}")


def _check_backend(scene: Scene, backend: str):
    """The list tracer is the ported backend, and "auto" picks it on a
    scene with clusters: its kernel is native on the card, the JAX
    package's rule for where the list kernel is native
    (pathtracer.py:114-139).  Every other backend, and "auto" without
    clusters, is not ported."""
    if backend != "list" and not (backend == "auto"
                                  and scene.clusters is not None):
        raise _not_ported(f"intersect={backend!r} (only 'list' is, and "
                          "'auto' on a scene with clusters)", "item 4")


class _QueryTape:
    """One sample's list-tracer answers, recorded by bounce (-1 for the
    primaries) on the first run and handed back when the checkpointed
    bounce or sample is replayed in the backward pass, so the replay
    never traces again.  The replay gets the same rays, so the same
    answer; a query with other ray counts than the recorded one raises.
    It also keeps each compacted bounce's width, so the replay adds no
    host sync."""

    def __init__(self):
        self._queries = {}
        self._widths = {}

    def query(self, bounce: int, clusters, queries, **kw):
        counts = tuple(q[0].shape[0] for q in queries)
        if bounce not in self._queries:
            self._queries[bounce] = (counts, multi_query(clusters, queries,
                                                         **kw))
        recorded, out = self._queries[bounce]
        if recorded != counts:
            raise RuntimeError(
                f"replayed query of bounce {bounce} has ray counts {counts}, "
                f"the recorded one {recorded}")
        return out

    def width(self, bounce: int, choose) -> int:
        if bounce not in self._widths:
            self._widths[bounce] = choose()
        return self._widths[bounce]


def _maybe_checkpoint(on: bool, fn, *args):
    """``fn(*args)``, under a non-reentrant checkpoint when ``on`` (the
    port's keys are explicit, so torch's RNG state is not stashed)."""
    if not on:
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def trace_shared(scene: Scene, ray_o, ray_d, key, bounces: int,
                 with_aux: bool = False, ggx_bug: bool = False,
                 remat: bool = True, impl=None, tape: _QueryTape = None):
    """Shared-sample wavefront integrator on the fused list path.

    Returns radiance [B,3] (and {"overflow": bool tensor} with
    ``with_aux``).  ``remat`` checkpoints each bounce (see the module
    docstring); ``tape`` is the sample's record of list-tracer answers,
    passed by a caller that checkpoints the whole sample.
    ``impl="plain"`` runs the list tracer's plain torch kernel versions
    instead of the CUDA kernels (comparisons only)."""
    if scene.clusters is None:
        raise ValueError("trace_shared needs scene.build_acceleration()")
    if scene.materials.count > MAX_SLOT_MATERIALS:
        raise _not_ported(
            f"more than {MAX_SLOT_MATERIALS} materials (the unfused "
            "per-primitive shading path)", "item 4")
    B = ray_o.shape[0]
    dev = ray_o.device
    tape = _QueryTape() if tape is None else tape
    ckpt = remat and torch.is_grad_enabled()
    num_lights = scene.num_lights
    has_env = scene.env_map is not None
    n_tris = scene.num_triangles
    mat_packed = scene.materials.packed()                 # [M,8]
    cs = scene.clusters
    slot_packed = scene.slot_packed
    if slot_packed is None:
        idx = cs.cl_tri_idx
        vs = idx >= 0
        matid = scene.material_indices[torch.clamp(idx, 0, n_tris - 1).long()]
        slot_packed = torch.where(vs, idx, 0) | (
            torch.where(vs, matid, 0) << SLOT_TRI_BITS)
    areas_tab = scene.tri_areas

    def slot_lookup(packed):
        """packed winner (cluster*T + lane) -> (prim, material id, area)
        through the [K2,T] slot table and the 1-D area table."""
        win = torch.clamp_min(packed, 0).long()
        sp = slot_packed[win // T_CLUSTER, win % T_CLUSTER]
        prim = torch.where(packed >= 0, sp & ((1 << SLOT_TRI_BITS) - 1), -1)
        if num_lights > 0:
            area = areas_tab[torch.clamp(prim, 0, n_tris - 1).long()]
        else:
            area = torch.zeros(packed.shape, dtype=torch.float32, device=dev)
        return prim, sp >> SLOT_TRI_BITS, area

    if num_lights > 0:
        # light rows: 9 vertex floats + 3 emission floats
        em_idx = scene.emissive_indices.long()
        light_rows = torch.cat([
            scene.triangles[em_idx].reshape(-1, 9),
            scene.materials.emission[scene.material_indices[em_idx].long()],
        ], dim=1)                                        # [K,12]

    res0, ovf0 = tape.query(-1, cs, [(ray_o, ray_d, None, None, False)],
                            share=PRIMARY_SHARE, impl=impl)
    prim0, mid0, _ = slot_lookup(res0[0][1])
    hit0 = finalize_hit(ray_o, ray_d, scene.triangles, prim0)

    def bounce_core(bounce, ray_o, ray_d, hit, mid, throughput, radiance,
                    alive):
        """One bounce over a wavefront of any width (pathtracer.py:
        683-918).  Returns the updated state and the bounce's overflow."""
        W = ray_o.shape[0]
        live_hit = alive & hit.hit
        rows = mat_packed[mid.long()]
        emission, diffuse, metal, rough = (
            rows[:, 0:3], rows[:, 3:6], rows[:, 6], rows[:, 7])
        view = -ray_d
        # emission only on primary hits (reference :126-127)
        if bounce == 0:
            radiance = radiance + torch.where(live_hit[:, None], emission, 0.0)
        origin = hit.point + hit.normal * RAY_OFFSET

        # ONE GGX sample for all brdf-sampled estimators this bounce
        uc = uniforms(key, bounce, _CONT, (W, 2), dev)
        brdf_s, wi_s, pdf_s = ggx_importance_sample(
            diffuse, metal, rough, view, hit.normal, uc[:, 0], uc[:, 1],
            reference_bug=ggx_bug,
        )
        cos_s = torch.clamp_min(dot(hit.normal, wi_s), 0.0)
        brdf_pos = torch.any(brdf_s > 0.0, dim=-1)
        cont_ok = (live_hit & (pdf_s >= 1e-8) & torch.isfinite(pdf_s)
                   & brdf_pos)
        queries = [(origin, wi_s, None, cont_ok, False)]
        if num_lights > 0:
            u = uniforms(key, bounce, _LIGHT, (W, 3), dev)
            pick = torch.clamp_max((u[:, 0] * num_lights).to(torch.int64),
                                   num_lights - 1)
            lr = light_rows[pick]                        # [W,12]
            lp, ln, area = sample_triangle_uniform(
                lr[:, 0:3], lr[:, 3:6], lr[:, 6:9], u[:, 1], u[:, 2])
            light_emission = lr[:, 9:12]
            pdf_area = 1.0 / torch.clamp_min(num_lights * area, 1e-12)
            to_light = lp - origin
            dist = torch.linalg.vector_norm(to_light, dim=-1)
            wi_l = to_light / torch.clamp_min(dist, 1e-12)[:, None]
            cos_light = torch.clamp_min(dot(ln, -wi_l), 0.0)
            front = cos_light > 0.0
            cos_surf = dot(hit.normal, wi_l)
            light_mask = live_hit & front & (cos_surf > 0.0)
            queries.append((origin, wi_l, dist - SHADOW_EPS, light_mask, True))
        if has_env:
            sampler = scene.env_map
            u_e = uniforms(key, bounce, _ENV, (W, 2), dev)
            wi_e, env_rad, env_pdf, _ = env_ops.sample(
                sampler, u_e[:, 0], u_e[:, 1])
            cos_e = dot(hit.normal, wi_e)
            env_mask = live_hit & (cos_e > 0.0)
            queries.append((origin, wi_e, None, env_mask, True))

        # the bounce's continuation closest-hit and its shadow rays share
        # one sort + candidate build + kernel launch
        res, ovf = tape.query(bounce, cs, queries, impl=impl)
        prim_c, mid2, area2 = slot_lookup(res[0][1])
        h2 = finalize_hit(origin, wi_s, scene.triangles, prim_c)

        direct = torch.zeros((W, 3), dtype=torch.float32, device=dev)
        if num_lights > 0:
            # light NEE, light-sample term
            shadowed = res[1][1] >= 0
            light_pdf = pdf_area * dist * dist / torch.clamp_min(cos_light, 1e-6)
            light_pdf = torch.where(front, light_pdf, 1.0)
            brdf_l = cook_torrance_eval(diffuse, metal, rough, wi_l, view,
                                        hit.normal)
            brdf_pdf_l = cook_torrance_pdf(rough, view, wi_l, hit.normal)
            mis_w = power_heuristic(light_pdf, brdf_pdf_l)
            ok = front & (~shadowed) & (brdf_pdf_l != 0.0) & (cos_surf > 0.0)
            direct = direct + torch.where(
                ok[:, None],
                light_emission * (cos_surf * mis_w / torch.clamp_min(
                    light_pdf, 1e-12))[:, None] * brdf_l,
                0.0,
            )
            # light NEE, brdf-sample term through the shared sample's hit
            hit_emission = mat_packed[mid2.long()][:, 0:3]
            cos_at_light = torch.clamp_min(dot(h2.normal, -wi_s), 0.0)
            is_emitter = torch.any(hit_emission > 0.0, dim=-1) & (
                h2.prim < n_tris)
            t2_safe = torch.where(h2.hit, h2.t, 1.0)
            light_pdf2 = (t2_safe * t2_safe) / torch.clamp_min(
                area2 * cos_at_light, 1e-6)
            light_pdf2 = torch.where(h2.hit & (cos_at_light > 0.0),
                                     light_pdf2, 1.0)
            mis_w2 = power_heuristic(pdf_s, light_pdf2)
            ok2 = (h2.hit & is_emitter & (cos_at_light > 0.0)
                   & (pdf_s > 0.0) & brdf_pos)
            direct = direct + torch.where(
                ok2[:, None],
                brdf_s * hit_emission * (cos_s * mis_w2 / torch.clamp_min(
                    pdf_s, 1e-12))[:, None],
                0.0,
            )
        if has_env:
            # env NEE, env-sample term
            blocked = res[-1][1] >= 0
            brdf_e = cook_torrance_eval(diffuse, metal, rough, wi_e, view,
                                        hit.normal)
            brdf_pdf_e = cook_torrance_pdf(rough, view, wi_e, hit.normal)
            mis_we = power_heuristic(env_pdf, brdf_pdf_e)
            ok_e = (cos_e > 0.0) & (~blocked) & (env_pdf > 0.0)
            direct = direct + torch.where(
                ok_e[:, None],
                brdf_e * env_rad * (cos_e * mis_we / torch.clamp_min(
                    env_pdf, 1e-12))[:, None],
                0.0,
            )
            # env NEE, brdf-sample term through the shared sample's miss
            env_rad_s = env_ops.eval_direction(sampler.image, wi_s)
            env_pdf_s = env_ops.pdf_of_direction(sampler, wi_s)
            mis_ws = power_heuristic(pdf_s, env_pdf_s)
            ok_s = (~h2.hit) & cont_ok & (cos_s > 0.0)
            direct = direct + torch.where(
                ok_s[:, None],
                brdf_s * env_rad_s * (cos_s * mis_ws / torch.clamp_min(
                    pdf_s, 1e-12))[:, None],
                0.0,
            )
        radiance = radiance + torch.where(live_hit[:, None],
                                          direct * throughput, 0.0)

        # continuation on the SAME sample; h2 is the next bounce's hit
        new_tp = throughput * brdf_s * (
            cos_s / torch.clamp_min(pdf_s, 1e-12))[:, None]
        throughput = torch.where(cont_ok[:, None], new_tp, throughput)
        ray_o = torch.where(cont_ok[:, None], origin, ray_o)
        ray_d = torch.where(cont_ok[:, None], wi_s, ray_d)
        return ray_o, ray_d, h2, mid2, throughput, radiance, cont_ok, ovf

    # hoisted primary-miss env radiance (reference :146-158)
    radiance = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    if has_env:
        sky0 = env_ops.eval_direction(scene.env_map.image, ray_d)
        radiance = torch.where((~hit0.hit)[:, None], sky0, 0.0)
    throughput = torch.ones((B, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    overflow = ovf0
    hit, mid = hit0, mid0

    if B < COMPACT_MIN_B:
        for bounce in range(bounces):
            ray_o, ray_d, hit, mid, throughput, radiance, alive, ovf = \
                _maybe_checkpoint(ckpt, bounce_core, bounce, ray_o, ray_d,
                                  hit, mid, throughput, radiance, alive)
            overflow = overflow | ovf
    else:
        # compacted wavefront (pathtracer.py:976-1059): each bounce
        # stable-partitions live rays first and runs on the smallest width
        # bucket covering them; a carried original-index column undoes
        # the accumulated permutations at the end
        r256 = lambda x: -(-x // 256) * 256                # noqa: E731
        widths = sorted({r256(max(256, B // d)) for d in (8, 4, 2)} | {B})
        state = dict(ray_o=ray_o, ray_d=ray_d, mid=mid, tp=throughput,
                     rad=radiance, alive=alive,
                     ordmap=torch.arange(B, device=dev),
                     **{f"hit_{f}": getattr(hit, f) for f in _HIT_FIELDS})
        for bounce in range(bounces):
            perm = torch.argsort((~state["alive"]).to(torch.int32),
                                 stable=True)
            state = {k: v.index_select(0, perm) for k, v in state.items()}
            w = tape.width(bounce, lambda: next(
                x for x in widths if x >= int(state["alive"].sum())))
            h = Hit(**{f: state[f"hit_{f}"][:w] for f in _HIT_FIELDS})
            out = _maybe_checkpoint(
                ckpt, bounce_core, bounce, state["ray_o"][:w],
                state["ray_d"][:w], h, state["mid"][:w], state["tp"][:w],
                state["rad"][:w], state["alive"][:w])
            ro, rd, h2, mid2, tp, rad, alv, ovf = out
            new = dict(ray_o=ro, ray_d=rd, mid=mid2, tp=tp, rad=rad,
                       alive=alv,
                       **{f"hit_{f}": getattr(h2, f) for f in _HIT_FIELDS})
            # only the live prefix changes; the dead suffix's radiance is
            # final.  New tensors, not writes in place: the bounce's ops
            # saved the old ones for the backward pass
            for k, v in new.items():
                state[k] = v if w == B else torch.cat([v, state[k][w:]])
            overflow = overflow | ovf
        # gather by the inverse permutation (pathtracer.py:1056)
        radiance = state["rad"].index_select(
            0, torch.argsort(state["ordmap"]))
    if with_aux:
        return radiance, {"overflow": overflow}
    return radiance


def render_rays(scene: Scene, camera: Camera, px, py, width: int,
                height: int, key, samples: int, bounces: int,
                backend: str = "auto", nee: bool = True,
                estimator: str = "shared", samples_per_pass: int = 1,
                max_radiance=None, with_aux: bool = False,
                ggx_bug: bool = False, remat: bool = True, impl=None):
    """Average ``samples`` jittered paths per pixel; returns HDR [B,3]
    (pathtracer.py:1062-1128).  Jitter is uniform in [c-0.5, c+0.5)
    around pixel centers (render_kernel.cpp:88-89).  With ``remat`` and
    more than one pass, each pass is checkpointed too
    (pathtracer.py:1108-1121)."""
    _check_backend(scene, backend)
    if estimator != "shared" or not nee:
        raise _not_ported(f"estimator={estimator!r}, nee={nee}", "item 4")
    B = px.shape[0]
    P = max(1, samples_per_pass)
    if samples % P != 0:
        raise ValueError("samples must divide by samples_per_pass")
    px_rep, py_rep = (px, py) if P == 1 else (px.repeat(P), py.repeat(P))

    def sample_pass(s, px_rep, py_rep, tape):
        ks = fold_in(key, s)
        uj = uniforms(ks, 0, _JITTER, (B * P, 2), px.device)
        jx = px_rep + 0.5 + uj[:, 0] - 1.0
        jy = py_rep + 0.5 + uj[:, 1] - 1.0
        ro, rd = camera.generate_rays(jx, jy, width, height)
        rad, aux = trace_shared(scene, ro, rd, ks, bounces, with_aux=True,
                                ggx_bug=ggx_bug, remat=remat, impl=impl,
                                tape=tape)
        if max_radiance is not None:
            # per-sample firefly clamp (biased, like all production clamps)
            rad = torch.clamp_max(rad, max_radiance)
        if P > 1:
            rad = rad.reshape(P, B, 3).sum(dim=0)
        return rad, aux["overflow"]

    ckpt = remat and samples // P > 1 and torch.is_grad_enabled()
    accum = torch.zeros((B, 3), dtype=torch.float32, device=px.device)
    overflow = torch.zeros((), dtype=torch.bool, device=px.device)
    for s in range(samples // P):
        rad, ovf = _maybe_checkpoint(ckpt, sample_pass, s, px_rep, py_rep,
                                     _QueryTape())
        accum = accum + rad
        overflow = overflow | ovf
    if with_aux:
        return accum / samples, {"overflow": overflow}
    return accum / samples


def render(scene: Scene, camera: Camera, config: RenderConfig, key,
           with_aux: bool = False, impl=None):
    """Full-frame render -> linear HDR image [H,W,3] (pathtracer.py:
    1131-1202).  Row 0 is the BOTTOM of the image.  ``with_aux=True`` also
    returns {"overflow": bool}: True when some ray's answer is not
    certified exact.  Tiles of ``config.tile_rays`` rays use the per-tile
    key fold_in(key, tile_index)."""
    W, H = config.width, config.height
    dev = scene.device
    kw = dict(samples=config.samples, bounces=config.bounces,
              backend=config.intersect, estimator=config.estimator,
              samples_per_pass=config.samples_per_pass,
              max_radiance=config.max_radiance, with_aux=True,
              ggx_bug=(config.ggx_sampler == "reference"),
              remat=config.remat, impl=impl)
    if config.debug_pixel is not None:
        x0, y0 = config.debug_pixel
        px = torch.tensor([float(x0)], dtype=torch.float32, device=dev)
        py = torch.tensor([float(y0)], dtype=torch.float32, device=dev)
        hdr, aux = render_rays(scene, camera, px, py, W, H, key, **kw)
        img = hdr.reshape(1, 1, 3)
    else:
        ys, xs = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=dev),
            torch.arange(W, dtype=torch.float32, device=dev),
            indexing="ij",
        )
        px = xs.reshape(-1)
        py = ys.reshape(-1)
        B = W * H
        tile = config.tile_rays
        if tile is None or tile >= B:
            hdr, aux = render_rays(scene, camera, px, py, W, H, key, **kw)
        else:
            n_tiles = -(-B // tile)
            pad = n_tiles * tile - B
            zeros = torch.zeros((pad,), dtype=torch.float32, device=dev)
            px = torch.cat([px, zeros])
            py = torch.cat([py, zeros])
            parts, overflow = [], torch.zeros((), dtype=torch.bool, device=dev)
            for tidx in range(n_tiles):
                sl = slice(tidx * tile, (tidx + 1) * tile)
                h, a = render_rays(scene, camera, px[sl], py[sl], W, H,
                                   fold_in(key, tidx), **kw)
                parts.append(h)
                overflow = overflow | a["overflow"]
            hdr, aux = torch.cat(parts)[:B], {"overflow": overflow}
        img = hdr.reshape(H, W, 3)
    aux = {"overflow": bool(aux["overflow"])}
    if with_aux:
        return img, aux
    return img
