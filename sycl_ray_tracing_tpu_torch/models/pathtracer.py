"""The path-tracing integrator (counterpart of
sycl_ray_tracing_tpu/models/pathtracer.py).

Two estimators, both with the JAX package's RNG streams:
  * ``trace`` (estimator="parity"), the reference's structure
    (render_kernel.cpp:96-161): per bounce one closest hit, then light
    NEE (a shadow ray and a GGX-sampled closest hit) and env NEE (two
    shadow rays), each with two-sided MIS — 5 scene queries a bounce;
    ``nee=False`` is the naive cosine-sampling estimator the tests use to
    validate the MIS weights;
  * ``trace_shared`` (estimator="shared"): one GGX sample per bounce
    shared by the light-MIS brdf term, the env-MIS brdf term and the
    continuation ray.  On the list backend with at most 2048 materials it
    runs FUSED (pathtracer.py:528-1059): the bounce's continuation
    closest hit and its light and env shadow rays go through ONE
    ``multi_query`` launch and shading reads the cluster-slot table; at
    B >= COMPACT_MIN_B rays its bounce loop runs as a compacted wavefront
    (each bounce stable-partitions live rays to a prefix and runs on the
    smallest width bucket covering them).  Every other backend, and more
    than 2048 materials, takes the unfused per-primitive shading with
    separate ``intersect_scene`` / ``occluded`` queries.

Scene queries dispatch on ``backend`` (``_resolve_backend``): the list
tracer (its CUDA kernels on the card), the cluster pair tracer, the
threaded BVH or brute force, plus brute-force analytic spheres merged
into every query.  "auto" is the list tracer on a scene with clusters
(its kernels are native on the card), else the BVH if the scene has one,
else brute force.

Differentiable w.r.t. materials, env-map texels, triangle vertices,
sphere parameters and camera pose: traversal records no graph, and
gradients flow through ``finalize_hit``'s re-intersection of each winner,
the sphere quadric and the shading.  With ``remat`` (the default) each
bounce, and each sample when a tile takes several, runs under
``torch.utils.checkpoint`` and is replayed in the backward pass from its
explicit keys; the replay takes the traversal answers recorded on the
first run (``_QueryTape``) instead of tracing again, like the JAX
package's remat policy that saves the traversal outputs
(pathtracer.py:54-64).  Forward-only callers wrap their calls in
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
from sycl_ray_tracing_tpu_torch.ops import bvh as bvh_ops
from sycl_ray_tracing_tpu_torch.ops import cluster as cluster_ops
from sycl_ray_tracing_tpu_torch.ops import envmap as env_ops
from sycl_ray_tracing_tpu_torch.ops.brdf import (
    cook_torrance_eval,
    cook_torrance_pdf,
    ggx_importance_sample,
)
from sycl_ray_tracing_tpu_torch.ops.cluster import SHADOW_EPS, T_CLUSTER
from sycl_ray_tracing_tpu_torch.ops.intersect import (
    BIG_T,
    Hit,
    any_hit_triangles,
    closest_triangle,
    finalize_hit,
    intersect_spheres,
    merge_hits,
)
from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace
from sycl_ray_tracing_tpu_torch.ops.kernels.listtrace import multi_query
from sycl_ray_tracing_tpu_torch.ops.kernels.rows import gather_rows
from sycl_ray_tracing_tpu_torch.ops.rng import fold_in, uniforms
from sycl_ray_tracing_tpu_torch.ops.safe_math import RAY_OFFSET, dot
from sycl_ray_tracing_tpu_torch.ops.sampling import (
    cosine_hemisphere,
    power_heuristic,
    sample_triangle_uniform,
    triangle_area,
)
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
from sycl_ray_tracing_tpu_torch.utils.metrics import host_read, span

# block-shared list kernel for the (coherent) primary rays
PRIMARY_SHARE = True

# Minimum batch for the compacted bounce loop; tests lower it (on both
# packages) to force the compacted path on small batches.
COMPACT_MIN_B = 8192

# purpose tags for key folding — one stream per random decision
_JITTER = 0
_LIGHT = 1       # light pick + area sample (3 uniforms)
_NEE_BRDF = 2    # GGX sample for the light-MIS brdf term (parity)
_ENV = 3         # env CDF row/col (2)
_ENV_BRDF = 4    # GGX sample for the env-MIS brdf term (parity)
_CONT = 5        # GGX sample for the continuation (shared: all three)

_HIT_FIELDS = ("t", "point", "normal", "uv", "prim", "hit")
BACKENDS = ("auto", "brute", "bvh", "cluster", "list")


class _QueryTape:
    """One sample's traversal answers, recorded on the first run and
    handed back when the checkpointed bounce or sample is replayed in the
    backward pass, so the replay never traces again.  The fused path keys
    its ``multi_query`` answers by bounce (-1 for the primaries); the
    unfused and parity paths key each query by (bounce, query number).
    The replay gets the same rays, so the same answer; a query with other
    ray counts than the recorded one raises.  It also keeps each
    compacted bounce's width, so the replay adds no host sync."""

    def __init__(self):
        self._answers = {}
        self._widths = {}

    def _replay(self, key, counts, run):
        if key not in self._answers:
            self._answers[key] = (counts, run())
        recorded, out = self._answers[key]
        if recorded != counts:
            raise RuntimeError(
                f"replayed query {key} has ray counts {counts}, the "
                f"recorded one {recorded}")
        return out

    def query(self, bounce: int, clusters, queries, **kw):
        counts = tuple(q[0].shape[0] for q in queries)
        return self._replay(bounce, counts,
                            lambda: multi_query(clusters, queries, **kw))

    def traverse(self, key, rays: int, run):
        return self._replay(key, (rays,), run)

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


def _resolve_backend(scene: Scene, backend: str) -> str:
    """"auto" is the list tracer on a scene with clusters (its kernels
    are native on the card: JAX's rule for where the list kernel is
    native), else the BVH if the scene has one, else brute force.
    "list" degrades to the cluster pair tracer above MAX_CLUSTERS
    clusters (brute force without clusters), as the JAX package degrades
    above its VMEM limit (pathtracer.py:114-139)."""
    if backend not in BACKENDS:
        raise ValueError(f"bad intersect mode {backend!r}")
    if backend == "auto":
        if scene.clusters is not None:
            backend = "list"
        elif scene.bvh is not None:
            backend = "bvh"
        else:
            backend = "brute"
    if backend == "list" and (
            scene.clusters is None
            or scene.clusters.num_clusters > listtrace.MAX_CLUSTERS):
        backend = "cluster" if scene.clusters is not None else "brute"
    if backend == "cluster" and scene.clusters is None:
        raise ValueError("intersect='cluster' needs "
                         "scene.build_acceleration()")
    if backend == "bvh" and scene.bvh is None:
        raise ValueError("intersect='bvh' needs scene.with_bvh(build_bvh())")
    return backend


@torch.no_grad()
def _closest_prim(scene: Scene, backend: str, ray_o, ray_d, mask, share,
                  impl):
    """The traversal of a closest-hit query: (prim [B], -1 on miss;
    overflow bool tensor or None).  ``mask`` prunes dead lanes on the
    list backend (they come back misses); the others ignore it, as in the
    JAX package."""
    if backend == "list":
        _t, prim, ovf = listtrace.closest_hit(scene.clusters, ray_o, ray_d,
                                              mask=mask, share=share,
                                              impl=impl)
        return prim, ovf
    if backend == "cluster":
        _t, prim, ovf = cluster_ops.closest_hit(scene.clusters, ray_o, ray_d)
        return prim, ovf
    if backend == "bvh":
        return bvh_ops.closest_prim(scene.bvh, ray_o, ray_d)[1], None
    return closest_triangle(ray_o, ray_d, scene.triangles), None


@torch.no_grad()
def _blocked(scene: Scene, backend: str, ray_o, ray_d, t_max, mask, impl):
    """The traversal of a shadow query: (blocked [B] bool, overflow or
    None), a triangle at t < t_max - SHADOW_EPS."""
    if backend == "list":
        return listtrace.any_hit(scene.clusters, ray_o, ray_d, t_max,
                                 mask=mask, impl=impl)
    if backend == "cluster":
        return cluster_ops.any_hit(scene.clusters, ray_o, ray_d, t_max)
    if backend == "bvh":
        return bvh_ops.any_hit(scene.bvh, ray_o, ray_d, t_max), None
    return any_hit_triangles(ray_o, ray_d, scene.triangles,
                             t_max - SHADOW_EPS), None


def _traversal(tape, key, rays: int, run):
    return run() if tape is None else tape.traverse(key, rays, run)


def _sphere_hits(scene: Scene, ray_o, ray_d) -> Hit:
    """Brute-force sphere hits; a sphere's primitive index is N + its id."""
    prim = scene.num_triangles + torch.arange(
        scene.num_spheres, dtype=torch.int32, device=ray_o.device)
    return intersect_spheres(ray_o, ray_d, scene.sphere_centers,
                             scene.sphere_radii, prim)


def intersect_scene(scene: Scene, ray_o, ray_d, backend: str = "auto",
                    of: list | None = None, mask=None, list_share=None,
                    impl=None, tape: _QueryTape | None = None,
                    key=None) -> Hit:
    """Closest-hit dispatch (reference INTERSECT_SCENE,
    render_kernel.cpp:504-511; pathtracer.py:142-181) plus brute-force
    spheres (:485-502); a sphere hit's primitive index is N + sphere id.
    ``of``: list the overflow flag of the list and cluster backends is
    appended to.  ``mask``: False lanes are dead paths whose answer is
    unused (the list backend prunes them).  ``tape``/``key``: record or
    replay the traversal's answer (see _QueryTape)."""
    backend = _resolve_backend(scene, backend)
    prim, ovf = _traversal(tape, key, ray_o.shape[0], lambda: _closest_prim(
        scene, backend, ray_o.detach(), ray_d.detach(), mask, list_share,
        impl))
    if of is not None and ovf is not None:
        of.append(ovf)
    hit = finalize_hit(ray_o, ray_d, scene.triangles, prim)
    if scene.num_spheres > 0:
        hit = merge_hits(hit, _sphere_hits(scene, ray_o, ray_d))
    return hit


@torch.no_grad()
def _merge_sphere_occlusion(scene: Scene, ray_o, ray_d, t_max, blocked):
    """OR in sphere occlusion with the triangles' 1e-4 shadow slack
    (pathtracer.py:184-195)."""
    if scene.num_spheres == 0:
        return blocked
    s_hit = _sphere_hits(scene, ray_o, ray_d)
    return blocked | (s_hit.hit & (s_hit.t + SHADOW_EPS < t_max))


def occluded(scene: Scene, ray_o, ray_d, t_max=None, backend: str = "auto",
             of: list | None = None, mask=None, impl=None,
             tape: _QueryTape | None = None, key=None):
    """Shadow-ray test with the reference's t_max - 1e-4 slack
    (evaluate_shadow_ray, render_kernel.cpp:744-759; pathtracer.py:
    198-237).  ``t_max=None`` means blocked at any distance (env rays)."""
    if t_max is None:
        t_max = torch.full(ray_o.shape[:1], BIG_T, dtype=ray_o.dtype,
                           device=ray_o.device)
    backend = _resolve_backend(scene, backend)
    blocked, ovf = _traversal(tape, key, ray_o.shape[0], lambda: _blocked(
        scene, backend, ray_o.detach(), ray_d.detach(), t_max.detach(), mask,
        impl))
    if of is not None and ovf is not None:
        of.append(ovf)
    return _merge_sphere_occlusion(scene, ray_o, ray_d, t_max, blocked)


def _material_of_prim(scene: Scene, prim):
    """Material row of a primitive index ([0,N) triangles, [N,N+S)
    spheres) (pathtracer.py:240-249)."""
    n = scene.num_triangles
    tri_mat = scene.material_indices[torch.clamp(prim, 0, n - 1).long()]
    if scene.num_spheres > 0:
        sph_mat = scene.sphere_material[
            torch.clamp(prim - n, 0, scene.num_spheres - 1).long()]
        return torch.where(prim < n, tri_mat, sph_mat)
    return tri_mat


def _any_overflow(of: list, device):
    out = torch.zeros((), dtype=torch.bool, device=device)
    for f in of:
        out = out | f
    return out


def _sample_lights_nee(scene: Scene, hit: Hit, view, diffuse, metal, rough,
                       key, bounce: int, closest, occl, live,
                       ggx_bug: bool = False):
    """Direct lighting from emissive triangles, both MIS terms (reference
    sample_light_sources, render_kernel.cpp:633-713; pathtracer.py:
    252-349).  ``closest(q, o, d, mask)`` / ``occl(q, o, d, t_max, mask)``
    run the bounce's query number q; ``live`` masks the consumed lanes."""
    B = hit.t.shape[0]
    dev = hit.t.device
    num_lights = scene.num_lights
    radiance = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    if num_lights == 0:
        return radiance
    u = uniforms(key, bounce, _LIGHT, (B, 3), dev)

    # --- light-sample term ---
    pick = torch.clamp_max((u[:, 0] * num_lights).to(torch.int64),
                           num_lights - 1)
    light_tri_idx = scene.emissive_indices[pick]
    tri = scene.triangles[light_tri_idx.long()]                  # [B,3,3]
    lp, ln, area = sample_triangle_uniform(tri[:, 0], tri[:, 1], tri[:, 2],
                                           u[:, 1], u[:, 2])
    pdf_area = 1.0 / torch.clamp_min(num_lights * area, 1e-12)
    origin = hit.point + hit.normal * RAY_OFFSET
    to_light = lp - origin
    dist = torch.linalg.vector_norm(to_light, dim=-1)
    wi = to_light / torch.clamp_min(dist, 1e-12)[:, None]
    cos_light = torch.clamp_min(dot(ln, -wi), 0.0)
    front = cos_light > 0.0
    cos_surf = dot(hit.normal, wi)
    shadowed = occl(1, origin, wi, dist,
                    live & hit.hit & front & (cos_surf > 0.0))
    # sanitize masked lanes before the arithmetic (a cos_light ~ 0 lane
    # would make light_pdf explode and NaN-poison the backward pass)
    light_pdf = pdf_area * dist * dist / torch.clamp_min(cos_light, 1e-6)
    light_pdf = torch.where(front, light_pdf, 1.0)
    light_emission = gather_rows(scene.materials.emission,
                                 _material_of_prim(scene, light_tri_idx))
    brdf = cook_torrance_eval(diffuse, metal, rough, wi, view, hit.normal)
    brdf_pdf = cook_torrance_pdf(rough, view, wi, hit.normal)
    mis_w = power_heuristic(light_pdf, brdf_pdf)
    contrib = (light_emission * (cos_surf * mis_w / torch.clamp_min(
        light_pdf, 1e-12))[:, None] * brdf)
    ok = hit.hit & front & (~shadowed) & (brdf_pdf != 0.0) & (cos_surf > 0.0)
    radiance = radiance + torch.where(ok[:, None], contrib, 0.0)

    # --- brdf-sample term: did a GGX-sampled ray hit an emitter? ---
    ub = uniforms(key, bounce, _NEE_BRDF, (B, 2), dev)
    brdf_s, wi_s, pdf_s = ggx_importance_sample(
        diffuse, metal, rough, view, hit.normal, ub[:, 0], ub[:, 1],
        reference_bug=ggx_bug)
    brdf_pos = torch.any(brdf_s > 0.0, dim=-1)
    origin_s = hit.point + hit.normal * 1e-5   # the reference's 1e-5 (:684)
    h2 = closest(2, origin_s, wi_s, live & hit.hit & (pdf_s > 0.0) & brdf_pos)
    n_tris = scene.num_triangles
    cos_at_light = torch.clamp_min(dot(h2.normal, -wi_s), 0.0)
    hit_emission = gather_rows(scene.materials.emission,
                               _material_of_prim(scene, h2.prim))
    is_emitter = torch.any(hit_emission > 0.0, dim=-1) & (h2.prim < n_tris)
    light_area2 = triangle_area(
        scene.triangles[torch.clamp(h2.prim, 0, n_tris - 1).long()])
    # h2.t is BIG_T on a miss: squared it overflows to inf
    t2_safe = torch.where(h2.hit, h2.t, 1.0)
    light_pdf2 = (t2_safe * t2_safe) / torch.clamp_min(
        light_area2 * cos_at_light, 1e-6)
    light_pdf2 = torch.where(h2.hit & (cos_at_light > 0.0), light_pdf2, 1.0)
    mis_w2 = power_heuristic(pdf_s, light_pdf2)
    cos_surf2 = dot(hit.normal, wi_s)
    contrib2 = brdf_s * hit_emission * (cos_surf2 * mis_w2 / torch.clamp_min(
        pdf_s, 1e-12))[:, None]
    ok2 = (hit.hit & h2.hit & is_emitter & (cos_at_light > 0.0)
           & (pdf_s > 0.0) & brdf_pos)
    return radiance + torch.where(ok2[:, None], contrib2, 0.0)


def _sample_env_nee(scene: Scene, hit: Hit, view, diffuse, metal, rough,
                    key, bounce: int, occl, live, ggx_bug: bool = False):
    """Direct lighting from the environment map, both MIS terms (reference
    sample_environment_map, render_kernel.cpp:569-631; pathtracer.py:
    352-400)."""
    B = hit.t.shape[0]
    dev = hit.t.device
    radiance = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    if scene.env_map is None:
        return radiance
    sampler = scene.env_map

    # --- env-sample term ---
    u = uniforms(key, bounce, _ENV, (B, 2), dev)
    wi, env_rad, env_pdf, _ = env_ops.sample(sampler, u[:, 0], u[:, 1])
    cos_term = dot(hit.normal, wi)
    origin = hit.point + hit.normal * RAY_OFFSET
    blocked = occl(3, origin, wi, None, live & hit.hit & (cos_term > 0.0))
    brdf = cook_torrance_eval(diffuse, metal, rough, wi, view, hit.normal)
    brdf_pdf = cook_torrance_pdf(rough, view, wi, hit.normal)
    mis_w = power_heuristic(env_pdf, brdf_pdf)
    contrib = brdf * env_rad * (cos_term * mis_w / torch.clamp_min(
        env_pdf, 1e-12))[:, None]
    ok = hit.hit & (cos_term > 0.0) & (~blocked) & (env_pdf > 0.0)
    radiance = radiance + torch.where(ok[:, None], contrib, 0.0)

    # --- brdf-sample term ---
    ub = uniforms(key, bounce, _ENV_BRDF, (B, 2), dev)
    brdf_s, wi_s, pdf_s = ggx_importance_sample(
        diffuse, metal, rough, view, hit.normal, ub[:, 0], ub[:, 1],
        reference_bug=ggx_bug)
    cos_s = torch.clamp_min(dot(hit.normal, wi_s), 0.0)
    origin_s = hit.point + hit.normal * 1e-5   # the reference's offset (:615)
    blocked_s = occl(4, origin_s, wi_s, None,
                     live & hit.hit & (pdf_s > 0.0) & (cos_s > 0.0))
    env_rad_s = env_ops.eval_direction(sampler.image, wi_s)
    env_pdf_s = env_ops.pdf_of_direction(sampler, wi_s)
    mis_w_s = power_heuristic(pdf_s, env_pdf_s)
    contrib_s = brdf_s * env_rad_s * (cos_s * mis_w_s / torch.clamp_min(
        pdf_s, 1e-12))[:, None]
    ok_s = hit.hit & (pdf_s > 0.0) & (cos_s > 0.0) & (~blocked_s)
    return radiance + torch.where(ok_s[:, None], contrib_s, 0.0)


def trace(scene: Scene, ray_o, ray_d, key, bounces: int,
          backend: str = "auto", nee: bool = True, with_aux: bool = False,
          ggx_bug: bool = False, remat: bool = True, impl=None,
          tape: _QueryTape | None = None):
    """Trace one path per ray with the reference's 5-query structure
    (render_kernel.cpp:96-161; pathtracer.py:403-525); returns radiance
    [B,3] (and {"overflow": bool tensor} with ``with_aux``).

    ``nee=False`` is the naive estimator: emission gathered at every
    bounce, env at every miss, cosine-hemisphere continuation, no NEE.
    ``remat`` checkpoints each bounce; its replay takes the bounce's five
    traversal answers from ``tape`` (keyed (bounce, query)).
    ``impl="plain"`` runs the list tracer's plain torch kernel versions
    (comparisons only).  Spans: ``trace.bounce`` (bounce, width) around
    each bounce, ``nee.light`` / ``nee.env`` (bounce) around its light
    and sky NEE."""
    B = ray_o.shape[0]
    dev = ray_o.device
    backend = _resolve_backend(scene, backend)
    tape = _QueryTape() if tape is None else tape
    ckpt = remat and torch.is_grad_enabled()
    has_env = scene.env_map is not None

    def bounce_body(bounce, ray_o, ray_d, throughput, radiance, alive):
        with span("trace.bounce", bounce=bounce, width=B):
            return _bounce_body(bounce, ray_o, ray_d, throughput, radiance,
                                alive)

    def _bounce_body(bounce, ray_o, ray_d, throughput, radiance, alive):
        of = []

        def closest(q, o, d, mask):
            return intersect_scene(scene, o, d, backend, of, mask=mask,
                                   impl=impl, tape=tape, key=(bounce, q))

        def occl(q, o, d, t_max, mask):
            return occluded(scene, o, d, t_max, backend, of, mask=mask,
                            impl=impl, tape=tape, key=(bounce, q))

        hit = closest(0, ray_o, ray_d, alive)
        live_hit = alive & hit.hit
        emission, diffuse, metal, rough = scene.materials.lookup(
            _material_of_prim(scene, hit.prim))
        view = -ray_d
        if nee:
            # emission only on primary hits (reference :126-127)
            if bounce == 0:
                radiance = radiance + torch.where(live_hit[:, None],
                                                  emission, 0.0)
            with span("nee.light", bounce=bounce):
                light = _sample_lights_nee(
                    scene, hit, view, diffuse, metal, rough, key, bounce,
                    closest, occl, live_hit, ggx_bug)
            with span("nee.env", bounce=bounce):
                env = _sample_env_nee(
                    scene, hit, view, diffuse, metal, rough, key, bounce,
                    occl, live_hit, ggx_bug)
            direct = light + env
            radiance = radiance + torch.where(live_hit[:, None],
                                              direct * throughput, 0.0)
            # env on miss, primary rays only (reference :146-158)
            if has_env and bounce == 0:
                sky = env_ops.eval_direction(scene.env_map.image, ray_d)
                radiance = radiance + torch.where(
                    (alive & ~hit.hit)[:, None], sky * throughput, 0.0)
        else:
            # naive estimator: emission wherever the path lands, one-sided
            # past the primaries; env at every miss
            gather = live_hit
            if bounce > 0:
                gather = gather & (dot(hit.normal, -ray_d) > 0.0)
            radiance = radiance + torch.where(gather[:, None],
                                              emission * throughput, 0.0)
            if has_env:
                sky = env_ops.eval_direction(scene.env_map.image, ray_d)
                radiance = radiance + torch.where(
                    (alive & ~hit.hit)[:, None], sky * throughput, 0.0)

        # continuation: GGX importance sample (reference :121-141); the
        # naive estimator samples the cosine hemisphere
        uc = uniforms(key, bounce, _CONT, (B, 2), dev)
        if nee:
            brdf_c, wi_c, pdf_c = ggx_importance_sample(
                diffuse, metal, rough, view, hit.normal, uc[:, 0], uc[:, 1],
                reference_bug=ggx_bug)
        else:
            wi_c, pdf_c = cosine_hemisphere(hit.normal, uc[:, 0], uc[:, 1])
            brdf_c = cook_torrance_eval(diffuse, metal, rough, wi_c, view,
                                        hit.normal)
        ok_c = (live_hit & (pdf_c >= 1e-8) & torch.isfinite(pdf_c)
                & torch.any(brdf_c > 0.0, dim=-1))
        cos_c = torch.clamp_min(dot(wi_c, hit.normal), 0.0)
        new_tp = throughput * brdf_c * (cos_c / torch.clamp_min(
            pdf_c, 1e-12))[:, None]
        throughput = torch.where(ok_c[:, None], new_tp, throughput)
        new_o = hit.point + hit.normal * RAY_OFFSET
        ray_o = torch.where(ok_c[:, None], new_o, ray_o)
        ray_d = torch.where(ok_c[:, None], wi_c, ray_d)
        return (ray_o, ray_d, throughput, radiance, ok_c,
                _any_overflow(of, dev))

    throughput = torch.ones((B, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for bounce in range(bounces):
        ray_o, ray_d, throughput, radiance, alive, ovf = _maybe_checkpoint(
            ckpt, bounce_body, bounce, ray_o, ray_d, throughput, radiance,
            alive)
        overflow = overflow | ovf
    if with_aux:
        return radiance, {"overflow": overflow}
    return radiance


def trace_shared(scene: Scene, ray_o, ray_d, key, bounces: int,
                 backend: str = "auto", with_aux: bool = False,
                 ggx_bug: bool = False, remat: bool = True, impl=None,
                 tape: _QueryTape | None = None):
    """Shared-sample wavefront integrator (pathtracer.py:528-1059):
    per bounce 1 closest hit + 2 shadow rays, fused into one list-tracer
    launch on the list backend with at most 2048 materials.

    Returns radiance [B,3] (and {"overflow": bool tensor} with
    ``with_aux``).  ``remat`` checkpoints each bounce (see the module
    docstring); ``tape`` is the sample's record of traversal answers,
    passed by a caller that checkpoints the whole sample.
    ``impl="plain"`` runs the list tracer's plain torch kernel versions
    instead of the CUDA kernels (comparisons only)."""
    B = ray_o.shape[0]
    dev = ray_o.device
    backend = _resolve_backend(scene, backend)
    tape = _QueryTape() if tape is None else tape
    ckpt = remat and torch.is_grad_enabled()
    num_lights = scene.num_lights
    has_env = scene.env_map is not None
    n_tris = scene.num_triangles
    n_sph = scene.num_spheres
    mat_packed = scene.materials.packed()                 # [M,8]
    fuse = (backend == "list"
            and scene.materials.count <= MAX_SLOT_MATERIALS)
    if fuse:
        cs = scene.clusters
        slot_packed = scene.slot_packed
        if slot_packed is None:
            idx = cs.cl_tri_idx
            vs = idx >= 0
            matid = scene.material_indices[
                torch.clamp(idx, 0, n_tris - 1).long()]
            slot_packed = torch.where(vs, idx, 0) | (
                torch.where(vs, matid, 0) << SLOT_TRI_BITS)
        areas_tab = scene.tri_areas

        def slot_lookup(packed):
            """packed winner (cluster*T + lane) -> (prim, material id,
            area) through the [K2,T] slot table and the area table."""
            win = torch.clamp_min(packed, 0).long()
            sp = slot_packed[win // T_CLUSTER, win % T_CLUSTER]
            prim = torch.where(packed >= 0,
                               sp & ((1 << SLOT_TRI_BITS) - 1), -1)
            if num_lights > 0:
                area = areas_tab[torch.clamp(prim, 0, n_tris - 1).long()]
            else:
                area = torch.zeros(packed.shape, dtype=torch.float32,
                                   device=dev)
            return prim, sp >> SLOT_TRI_BITS, area

        def sphere_merge_mid(tri_hit, tri_mid, s_hit):
            smid = scene.sphere_material[
                torch.clamp(s_hit.prim - n_tris, 0, n_sph - 1).long()]
            return torch.where(tri_hit.t <= s_hit.t, tri_mid, smid)
    else:
        # per-primitive material rows (triangles, then spheres)
        prim_rows = mat_packed[scene.material_indices.long()]   # [N,8]
        if n_sph > 0:
            prim_rows = torch.cat(
                [prim_rows, mat_packed[scene.sphere_material.long()]])

        def lookup_prim(prim):
            rows = prim_rows[torch.clamp(prim, 0,
                                         prim_rows.shape[0] - 1).long()]
            return rows[:, 0:3], rows[:, 3:6], rows[:, 6], rows[:, 7]

    if num_lights > 0:
        # light rows: 9 vertex floats + 3 emission floats
        em_idx = scene.emissive_indices.long()
        light_rows = torch.cat([
            scene.triangles[em_idx].reshape(-1, 9),
            scene.materials.emission[scene.material_indices[em_idx].long()],
        ], dim=1)                                        # [K,12]
        if not fuse:
            # emitter rows for the MIS brdf term: emission3 + area1
            emitter_rows = torch.cat([
                scene.materials.emission[scene.material_indices.long()],
                scene.tri_areas[:, None]], dim=1)        # [N,4]

    with span("trace.primary", width=B):
        mid0 = torch.zeros((B,), dtype=torch.int32, device=dev)
        if fuse:
            res0, ovf0 = tape.query(-1, cs,
                                    [(ray_o, ray_d, None, None, False)],
                                    share=PRIMARY_SHARE, impl=impl)
            prim0, mid0, _ = slot_lookup(res0[0][1])
            hit0 = finalize_hit(ray_o, ray_d, scene.triangles, prim0)
            if n_sph > 0:
                s0 = _sphere_hits(scene, ray_o, ray_d)
                mid0 = sphere_merge_mid(hit0, mid0, s0)
                hit0 = merge_hits(hit0, s0)
        else:
            of0 = []
            hit0 = intersect_scene(scene, ray_o, ray_d, backend, of0,
                                   list_share=PRIMARY_SHARE, impl=impl,
                                   tape=tape, key=(-1, 0))
            ovf0 = _any_overflow(of0, dev)
        # hoisted primary-miss env radiance (reference :146-158)
        radiance = torch.zeros((B, 3), dtype=torch.float32, device=dev)
        if has_env:
            sky0 = env_ops.eval_direction(scene.env_map.image, ray_d)
            radiance = torch.where((~hit0.hit)[:, None], sky0, 0.0)

    def bounce_core(bounce, ray_o, ray_d, hit, mid, throughput, radiance,
                    alive):
        """One bounce over a wavefront of any width (pathtracer.py:
        683-918).  Returns the updated state and the bounce's overflow."""
        with span("trace.bounce", bounce=bounce, width=ray_o.shape[0]):
            return _bounce_core(bounce, ray_o, ray_d, hit, mid, throughput,
                                radiance, alive)

    def _bounce_core(bounce, ray_o, ray_d, hit, mid, throughput, radiance,
                     alive):
        W = ray_o.shape[0]
        live_hit = alive & hit.hit
        if fuse:
            rows = gather_rows(mat_packed, mid)
            emission, diffuse, metal, rough = (
                rows[:, 0:3], rows[:, 3:6], rows[:, 6], rows[:, 7])
        else:
            emission, diffuse, metal, rough = lookup_prim(hit.prim)
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
        if num_lights > 0:
            u = uniforms(key, bounce, _LIGHT, (W, 3), dev)
            pick = torch.clamp_max((u[:, 0] * num_lights).to(torch.int64),
                                   num_lights - 1)
            lr = gather_rows(light_rows, pick)           # [W,12]
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
        if has_env:
            sampler = scene.env_map
            u_e = uniforms(key, bounce, _ENV, (W, 2), dev)
            wi_e, env_rad, env_pdf, _ = env_ops.sample(
                sampler, u_e[:, 0], u_e[:, 1])
            cos_e = dot(hit.normal, wi_e)
            env_mask = live_hit & (cos_e > 0.0)

        if fuse:
            # the bounce's continuation closest-hit and its shadow rays
            # share one sort + candidate build + kernel launch
            queries = [(origin, wi_s, None, cont_ok, False)]
            if num_lights > 0:
                queries.append((origin, wi_l, dist - SHADOW_EPS, light_mask,
                                True))
            if has_env:
                queries.append((origin, wi_e, None, env_mask, True))
            res, ovf = tape.query(bounce, cs, queries, impl=impl)
            prim_c, mid2, area2 = slot_lookup(res[0][1])
            h2 = finalize_hit(origin, wi_s, scene.triangles, prim_c)
            shadowed = res[1][1] >= 0 if num_lights > 0 else None
            blocked = res[-1][1] >= 0 if has_env else None
            if n_sph > 0:
                # merge brute-force sphere hits and occlusion, like the
                # unfused dispatch (pathtracer.py:780-804)
                s_hit = _sphere_hits(scene, origin, wi_s)
                mid2 = sphere_merge_mid(h2, mid2, s_hit)
                h2 = merge_hits(h2, s_hit)
                if num_lights > 0:
                    shadowed = _merge_sphere_occlusion(scene, origin, wi_l,
                                                       dist, shadowed)
                if has_env:
                    blocked = _merge_sphere_occlusion(
                        scene, origin, wi_e, torch.full(
                            (W,), BIG_T, dtype=origin.dtype, device=dev),
                        blocked)
        else:
            of = []
            mid2 = mid
            h2 = intersect_scene(scene, origin, wi_s, backend, of,
                                 mask=cont_ok, impl=impl, tape=tape,
                                 key=(bounce, 0))
            if num_lights > 0:
                shadowed = occluded(scene, origin, wi_l, dist, backend, of,
                                    mask=light_mask, impl=impl, tape=tape,
                                    key=(bounce, 1))
            if has_env:
                blocked = occluded(scene, origin, wi_e, None, backend, of,
                                   mask=env_mask, impl=impl, tape=tape,
                                   key=(bounce, 2))
            ovf = _any_overflow(of, dev)

        direct = torch.zeros((W, 3), dtype=torch.float32, device=dev)
        if num_lights > 0:
            # light NEE, light-sample term
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
            if fuse:
                hit_emission = gather_rows(mat_packed, mid2)[:, 0:3]
            else:
                er = emitter_rows[torch.clamp(h2.prim, 0, n_tris - 1).long()]
                hit_emission, area2 = er[:, 0:3], er[:, 3]
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

    throughput = torch.ones((B, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    overflow = ovf0
    hit, mid = hit0, mid0

    if not (fuse and B >= COMPACT_MIN_B):
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
            with span("bounce.compact", bounce=bounce):
                perm = torch.argsort((~state["alive"]).to(torch.int32),
                                     stable=True)
                state = {k: v.index_select(0, perm)
                         for k, v in state.items()}
                w = tape.width(bounce, lambda: next(
                    x for x in widths
                    if x >= host_read("alive", state["alive"].sum())))
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
                estimator: str = "parity", samples_per_pass: int = 1,
                max_radiance=None, with_aux: bool = False,
                ggx_bug: bool = False, remat: bool = True, impl=None):
    """Average ``samples`` jittered paths per pixel; returns HDR [B,3]
    (pathtracer.py:1062-1128).  Jitter is uniform in [c-0.5, c+0.5)
    around pixel centers (render_kernel.cpp:88-89).  ``estimator="shared"``
    with ``nee`` traces with ``trace_shared``, anything else with
    ``trace`` (pathtracer.py:1094-1100).  With ``remat`` and more than one
    pass, each pass is checkpointed too (pathtracer.py:1108-1121)."""
    if estimator not in ("shared", "parity"):
        raise ValueError(f"bad estimator {estimator!r}")
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
        if estimator == "shared" and nee:
            rad, aux = trace_shared(scene, ro, rd, ks, bounces, backend,
                                    with_aux=True, ggx_bug=ggx_bug,
                                    remat=remat, impl=impl, tape=tape)
        else:
            rad, aux = trace(scene, ro, rd, ks, bounces, backend, nee,
                             with_aux=True, ggx_bug=ggx_bug, remat=remat,
                             impl=impl, tape=tape)
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


def _render_image(scene: Scene, camera: Camera, config: RenderConfig, key,
                  impl, on_tile):
    """``render``'s image and its overflow flag as a tensor."""
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
                with span("render.tile", tile=tidx):
                    h, a = render_rays(scene, camera, px[sl], py[sl], W,
                                       H, fold_in(key, tidx), **kw)
                parts.append(h)
                overflow = overflow | a["overflow"]
                if on_tile is not None:
                    on_tile(tidx, n_tiles, h)
            hdr, aux = torch.cat(parts)[:B], {"overflow": overflow}
        img = hdr.reshape(H, W, 3)
    return img, aux


def render(scene: Scene, camera: Camera, config: RenderConfig, key,
           with_aux: bool = False, impl=None, on_tile=None):
    """Full-frame render -> linear HDR image [H,W,3] (pathtracer.py:
    1131-1202).  Row 0 is the BOTTOM of the image.  ``with_aux=True`` also
    returns {"overflow": bool}: True when some ray's answer is not
    certified exact.  Tiles of ``config.tile_rays`` rays use the per-tile
    key fold_in(key, tile_index); ``on_tile(tile_index, n_tiles, hdr)`` is
    called after each tile's render (the CLI's progress lines)."""
    with span("render"):
        img, aux = _render_image(scene, camera, config, key, impl, on_tile)
        aux = {"overflow": host_read("overflow", aux["overflow"])}
    if with_aux:
        return img, aux
    return img
