"""The port's parity estimator (``trace``, the reference's 5 queries a
bounce, fused into one list-tracer call on the list backend) and every
intersection backend, frame by frame against the JAX package's render at
the same key, and the parity estimator's gradient against ``jax.grad``;
a tiled parity frame, its tiles traced together, against the benchmark's
parity reference rendering each tile alone.

The scene is the 2k dragon with a 16x32 sky and its emissive panel, plus
two analytic spheres (tests/test_integrator.py:243-290), carried across
with scene_from_numpy: the same cluster tables with pair budgets for a
64-ray frame, and a SAH BVH built by the port's own native builder whose
tables both packages take.  The JAX side renders with an exact oracle
(brute force, or the cluster pair tracer where its overflow flag is
under test), so no test here runs the Pallas interpret mode.

Tolerances (tests/test_torch_pathtracer.py): at bounces=1 per pixel
within rtol 1e-4 / atol 1e-6; at 3 bounces at least 99% of pixels within
1e-3 and the frame means within 1%.  Gradients at bounces=1: per element
within rtol 1e-4 (atol 1e-9), the forward frames' own tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sycl_ray_tracing_tpu.models import pathtracer as JP
from sycl_ray_tracing_tpu.models.camera import pbrt_dragon_camera as jax_cam
from sycl_ray_tracing_tpu.models.scene import add_sphere as jax_add_sphere
from sycl_ray_tracing_tpu.ops import bvh as JB
from sycl_ray_tracing_tpu.utils.config import RenderConfig as JaxConfig
from sycl_ray_tracing_tpu.utils.procedural import dragon_scene as jax_dragon
from sycl_ray_tracing_tpu_torch.models import pathtracer as PP
from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
from sycl_ray_tracing_tpu_torch.models.scene import Materials, scene_from_numpy
from sycl_ray_tracing_tpu_torch.ops import bvh as PB
from sycl_ray_tracing_tpu_torch.ops import cluster as PC
from sycl_ray_tracing_tpu_torch.ops import rng
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
from test_torch_cluster import jax_scene_arrays
from test_torch_pathtracer import (  # noqa: F401
    _frame_against_tiles,
    bench_scene,
)
from torch_card import card, main_tile, tile_both  # noqa: F401

W = H = 8
SEED = 3
BACKENDS = ["list", "cluster", "bvh", "brute"]


def _jax_scene():
    js = jax_dragon(n_tris=2_000, with_sky=True, sky_res=(16, 32),
                    build_accel=False)
    js = jax_add_sphere(js, (1.5, 0.0, 0.0), 0.5, diffuse=(0.8, 0.3, 0.2))
    js = jax_add_sphere(js, (-1.2, 0.5, 0.8), 0.35, metalness=0.5,
                        roughness=0.3)
    js = js.build_acceleration(num_rays_hint=W * H)
    arrays = PB.build_bvh_arrays(np.asarray(js.triangles), 4, "sah")
    return js.with_bvh(JB.ThreadedBVH(
        **{f: jnp.asarray(arrays[f]) for f in PB.BVH_FIELDS}, leaf_size=4))


@pytest.fixture(scope="module")
def scenes():
    js = _jax_scene()
    return js, scene_from_numpy(jax_scene_arrays(js), "cpu")


def _jax_frame(js, **kw):
    cfg = JaxConfig(width=W, height=H, samples=1, tile_rays=None, **kw)
    img, aux = JP.render(js, jax_cam(), cfg, jax.random.PRNGKey(SEED),
                         with_aux=True)
    return np.asarray(img), bool(aux["overflow"])


def _port_frame(ps, **kw):
    cfg = RenderConfig(width=W, height=H, samples=1, tile_rays=None, **kw)
    with torch.no_grad():
        img, aux = PP.render(ps, pbrt_dragon_camera("cpu"), cfg,
                             rng.prng_key(SEED), with_aux=True)
    return img.numpy(), aux["overflow"]


def _per_pixel(pi, ji):
    assert np.isfinite(pi).all() and ji.mean() > 1e-3
    np.testing.assert_allclose(pi, ji, rtol=1e-4, atol=1e-6)


def _statistical(pi, ji):
    assert np.isfinite(pi).all() and ji.mean() > 1e-3
    close = np.isclose(pi, ji, rtol=1e-3, atol=1e-3).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(pi.mean() - ji.mean()) <= 0.01 * abs(ji.mean())


@pytest.fixture(scope="module")
def jax_parity_b1(scenes):
    """JAX's parity frame at bounces=1 (brute force) and, from the same
    compiled program, d mean / d materials.diffuse."""
    js = scenes[0]
    cfg = JaxConfig(width=W, height=H, samples=1, bounces=1,
                    intersect="brute", estimator="parity", tile_rays=None)

    def loss(diffuse):
        scene = js.with_materials(dataclasses.replace(js.materials,
                                                      diffuse=diffuse))
        img, aux = JP.render(scene, jax_cam(), cfg, jax.random.PRNGKey(SEED),
                             with_aux=True)
        return jnp.mean(img), (img, aux["overflow"])

    (v, (img, ovf)), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        js.materials.diffuse)
    return np.asarray(img), bool(ovf), float(v), np.asarray(g)


@pytest.fixture(scope="module")
def jax_shared_b1(scenes):
    return _jax_frame(scenes[0], bounces=1, intersect="brute",
                      estimator="shared")


def test_render_rays_defaults_match_jax():
    """render_rays' defaults are the JAX package's (estimator "parity",
    backend "auto", NEE on, ...), so a call with defaults renders the
    same estimator in both packages."""
    import inspect

    def defaults(fn):
        return {k: p.default for k, p in inspect.signature(fn).parameters
                .items() if p.default is not inspect.Parameter.empty}

    port, ref = defaults(PP.render_rays), defaults(JP.render_rays)
    assert port.pop("impl") is None
    assert port == ref and ref["estimator"] == "parity"


def test_scene_has_spheres_in_view(scenes):
    """Both spheres are carried across, and primary rays hit them."""
    js, ps = scenes
    assert ps.num_spheres == 2 and ps.bvh is not None
    assert ps.clusters.p2_budget == js.clusters.p2_budget == 64 * 18
    cam = pbrt_dragon_camera("cpu")
    ys, xs = torch.meshgrid(torch.arange(32.0), torch.arange(32.0),
                            indexing="ij")
    o, d = cam.generate_rays(xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5,
                             32, 32)
    hit = PP.intersect_scene(ps, o, d, "brute")
    assert int((hit.prim >= ps.num_triangles).sum()) > 5


@pytest.mark.parametrize("backend", BACKENDS)
def test_parity_bounce1_per_pixel(scenes, jax_parity_b1, backend):
    """estimator="parity", nee=True: every port backend against JAX's
    brute-force frame, per pixel, overflow False."""
    ji, jovf, _v, _g = jax_parity_b1
    pi, povf = _port_frame(scenes[1], bounces=1, intersect=backend,
                           estimator="parity")
    assert povf is jovf is False
    _per_pixel(pi, ji)


@pytest.mark.parametrize("backend", ["cluster", "bvh", "brute", "list"])
def test_shared_bounce1_per_pixel(scenes, jax_shared_b1, backend):
    """estimator="shared": the unfused path (cluster, bvh, brute) and the
    fused list path with its sphere merges, against JAX's brute frame."""
    ji, _ = jax_shared_b1
    pi, povf = _port_frame(scenes[1], bounces=1, intersect=backend,
                           estimator="shared")
    assert povf is False
    _per_pixel(pi, ji)


def test_parity_three_bounces_list(scenes):
    ji, _ = _jax_frame(scenes[0], bounces=3, intersect="brute",
                       estimator="parity")
    pi, povf = _port_frame(scenes[1], bounces=3, intersect="list",
                           estimator="parity")
    assert povf is False
    _statistical(pi, ji)


def test_naive_estimator_brute(scenes):
    """nee=False (render_rays; render always asks for NEE): the cosine-
    sampled continuation and emission at every bounce, 3 bounces."""
    js, ps = scenes
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32),
                         np.arange(W, dtype=np.float32), indexing="ij")
    ji = np.asarray(JP.render_rays(
        js, jax_cam(), jnp.asarray(xs.reshape(-1)),
        jnp.asarray(ys.reshape(-1)), W, H, jax.random.PRNGKey(SEED), 1, 3,
        "brute", False, "parity"))
    with torch.no_grad():
        pi = PP.render_rays(
            ps, pbrt_dragon_camera("cpu"), torch.as_tensor(xs.reshape(-1)),
            torch.as_tensor(ys.reshape(-1)), W, H, rng.prng_key(SEED), 1, 3,
            "brute", False, "parity").numpy()
    _statistical(pi, ji)


def _pad_materials(m, count):
    """The same materials followed by copies of row 0 up to ``count``."""
    def pad(x):
        return torch.cat([x, x[:1].repeat(count - x.shape[0],
                                           *([1] * (x.dim() - 1)))])

    return dataclasses.replace(m, **{f.name: pad(getattr(m, f.name))
                                     for f in dataclasses.fields(m)})


def test_more_than_2048_materials_list(scenes, jax_shared_b1):
    """2049 materials take the unfused per-primitive shading on the list
    backend (the slot table's 11 material bits are full).  No primitive
    reads the padding rows, so JAX's brute-force frame of the unpadded
    scene (already unfused) is the same frame."""
    _js, ps = scenes
    ps = ps.with_materials(_pad_materials(ps.materials, 2049))
    assert isinstance(ps.materials, Materials) and ps.materials.count == 2049
    ji, _ = jax_shared_b1
    pi, povf = _port_frame(ps, bounces=1, intersect="list",
                           estimator="shared")
    assert povf is False
    _per_pixel(pi, ji)


def _without_spheres(scene, zeros, int32):
    return dataclasses.replace(scene, sphere_centers=zeros((0, 3)),
                               sphere_radii=zeros((0,)),
                               sphere_material=zeros((0,), dtype=int32))


def test_cluster_budget_overflow_frame(scenes):
    """with_budgets(4, 4) (tests/test_integrator.py:218-240): the pair
    tracer drops pairs, the frame reports it, and the dropped hits are
    JAX's, per pixel.  The spheres are taken out of this frame: with the
    triangles' pairs dropped nearly every primary ray lands on a sphere,
    and a shadow ray leaving a sphere 1e-4 above its surface is a root
    near 0 whose sign float32 rounding decides (the JAX package's own
    jitted and eager runs of this frame differ at one pixel there)."""
    js, ps = scenes
    js = _without_spheres(js.with_clusters(js.clusters.with_budgets(4, 4)),
                          jnp.zeros, jnp.int32)
    ps = _without_spheres(ps.with_clusters(ps.clusters.with_budgets(4, 4)),
                          torch.zeros, torch.int32)
    assert ps.num_spheres == js.num_spheres == 0
    ji, jovf = _jax_frame(js, bounces=1, intersect="cluster",
                          estimator="parity")
    pi, povf = _port_frame(ps, bounces=1, intersect="cluster",
                           estimator="parity")
    assert jovf is povf is True
    _per_pixel(pi, ji)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
@pytest.mark.parametrize("backend", ["brute", "list"])
def test_parity_gradient_matches_jax(scenes, jax_parity_b1, monkeypatch,
                                     backend, remat):
    """d mean / d materials.diffuse of the parity frame at bounces=1, per
    element against jax.grad; with remat the backward replays the bounce
    from the recorded traversal answers and traces nothing.  Brute force
    traces each query alone (the primaries' closest hit, then 1 closest
    hit and 3 shadow rays, the last bounce's NEE); the list tracer traces
    the primaries and the bounce's four NEE rays in one multi_query call
    each."""
    ps = scenes[1]
    traced = []
    for name in ("_closest_prim", "_blocked", "multi_query"):
        orig = getattr(PP, name)

        def spy(*a, _orig=orig, **kw):
            traced.append(1)
            return _orig(*a, **kw)

        monkeypatch.setattr(PP, name, spy)
    diffuse = ps.materials.diffuse.clone().requires_grad_()
    scene = ps.with_materials(dataclasses.replace(ps.materials,
                                                  diffuse=diffuse))
    cfg = RenderConfig(width=W, height=H, samples=1, bounces=1,
                       intersect=backend, estimator="parity", tile_rays=None,
                       remat=remat)
    img = PP.render(scene, pbrt_dragon_camera("cpu"), cfg,
                    rng.prng_key(SEED))
    assert len(traced) == {"brute": 5, "list": 2}[backend]
    traced.clear()
    img.mean().backward()
    assert traced == []
    _ji, _jovf, jv, jg = jax_parity_b1
    np.testing.assert_allclose(float(img.detach().mean()), jv, rtol=1e-5)
    g = diffuse.grad.numpy()
    assert np.isfinite(g).all() and np.abs(g).sum() > 0
    np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-9)


# (frame size and backend, BATCH_RAYS, cluster budget rays, batches):
# 16x12 in 2 tiles of 128 rays, the last padded, one batch; 3 tiles of
# 80 rays (the last padded) in two batches of 2 and 1 tiles; on the
# cluster pair tracer, batches as wide as its pair budgets' rays: one
# tile each (as the CLI sizes them), or two
BATCHED = {
    "one_batch": (dict(width=16, height=12, tile_rays=128), None, None, 1),
    "two_batches": (dict(width=16, height=12, tile_rays=80), 160, None, 2),
    "cluster": (dict(width=16, height=12, tile_rays=80,
                     intersect="cluster"), None, 80, 3),
    "cluster_two_tiles": (dict(width=16, height=12, tile_rays=80,
                               intersect="cluster"), None, 160, 2),
}


@pytest.mark.parametrize("case", list(BATCHED))
def test_batched_parity_frame_equals_the_reference_tiles(bench_scene,
                                                         monkeypatch, case):
    """The parity estimator's tiled frame at 3 bounces, its tiles traced
    together, per pixel against the benchmark's parity reference
    rendering each tile alone (test_torch_pathtracer's comparison)."""
    size, batch, budget_rays, batches = BATCHED[case]
    if batch is not None:
        monkeypatch.setattr(PP, "BATCH_RAYS", batch)
    if budget_rays is not None:
        frames = bench_scene[1]
        cs = frames.scene.clusters.with_budgets(*PC.default_budgets(
            budget_rays, frames.scene.clusters.num_superclusters))
        assert cs.budget_rays == budget_rays
        monkeypatch.setattr(frames, "scene", frames.scene.with_clusters(cs))
    off, made, mean = _frame_against_tiles(bench_scene, "parity",
                                           4_200_000_029, bounces=3, **size)
    assert made == batches and mean > 1e-3
    assert off == 0.0


@pytest.mark.card
def test_parity_tile_equals_plain_on_the_card(card):
    """One 32768-ray tile of the 200k dragon's 512x512 frame at 8
    bounces through the parity estimator's fused list-tracer call a
    bounce: both list kernels launch, and the radiance is the plain
    twins' bit for bit, certified and finite."""
    ((rad, aux), (rad_p, _aux_p)), launches = tile_both(
        *main_tile(card), backend="list", estimator="parity")
    assert min(launches.values()) >= 1, launches
    assert torch.equal(rad, rad_p)
    assert not aux["overflow"] and torch.isfinite(rad).all()
