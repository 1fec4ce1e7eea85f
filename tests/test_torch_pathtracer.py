"""The port's render (fused list path of trace_shared) against the JAX
package's render on the very same scene (scene_from_numpy) and keys.

Tolerances: at bounces=1 every pixel within rtol 1e-4 / atol 1e-6 (the
same samples; only float32 op order differs).  At 3 bounces, compacted,
at least 99% of pixels within 1e-3 and frame means within 1%: a last-ulp
difference can flip one secondary hit and with it a whole path.

A tiled frame renders its tiles together, up to BATCH_RAYS rays a batch:
held per pixel against the benchmark's plain reference rendering each
tile alone (benchmark/reference, ``render_tile``) at the preview
traffic's tolerance (1e-6 + 1e-4 * |reference|), a tie in t read both
ways as the benchmark's check reads it; in grad mode, radiance and
gradients against the same frame rendered a tile a batch."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from benchmark import check as bench_check
from benchmark import inputs as bench_inputs
from benchmark import loops, manifest
from benchmark.reference import pathtrace
from benchmark.reference import rng as ref_rng
from sycl_ray_tracing_tpu.models import pathtracer as JP
from sycl_ray_tracing_tpu.models.camera import pbrt_dragon_camera as jax_cam
from sycl_ray_tracing_tpu.models.scene import add_sphere as jax_add_sphere
from sycl_ray_tracing_tpu.ops.pallas import listtrace as JL
from sycl_ray_tracing_tpu.utils.config import RenderConfig as JaxConfig
from sycl_ray_tracing_tpu.utils.procedural import dragon_scene as jax_dragon
from sycl_ray_tracing_tpu_torch.models import pathtracer as PP
from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
from sycl_ray_tracing_tpu_torch.models.scene import scene_from_numpy
from sycl_ray_tracing_tpu_torch.ops import rng
from sycl_ray_tracing_tpu_torch.ops.bvh import build_bvh
from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as PL
from sycl_ray_tracing_tpu_torch.utils import metrics
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
from test_torch_cluster import jax_scene_arrays
from torch_card import card, main_tile, tile_both  # noqa: F401

CPU = torch.device("cpu")
CONFIGS = {"shared": "dragon870k_sky", "parity": "dragon870k_parity"}


@pytest.fixture(scope="module")
def scenes():
    js = jax_dragon(n_tris=2_000, with_sky=True, sky_res=(16, 32))
    return js, scene_from_numpy(jax_scene_arrays(js), "cpu")


PLAIN, COMPACTED = 1 << 30, 1   # COMPACT_MIN_B values forcing each loop


def _render_both(scenes, seed, monkeypatch, jax_min_b, port_min_bs, **kw):
    """One JAX frame, and one port frame per COMPACT_MIN_B in
    ``port_min_bs``, of the same scene with the same seed."""
    js, ps = scenes
    kw = dict(width=16, height=16, samples=1, intersect="list",
              estimator="shared", **kw)
    monkeypatch.setattr(JP, "COMPACT_MIN_B", jax_min_b)
    ji, jaux = JP.render(js, jax_cam(), JaxConfig(**kw),
                         jax.random.PRNGKey(seed), with_aux=True)
    outs = []
    for min_b in port_min_bs:
        monkeypatch.setattr(PP, "COMPACT_MIN_B", min_b)
        with torch.no_grad():
            pi, paux = PP.render(ps, pbrt_dragon_camera("cpu"),
                                 RenderConfig(**kw), rng.prng_key(seed),
                                 with_aux=True)
        assert paux["overflow"] == bool(jaux["overflow"]) is False
        outs.append(pi.numpy())
    return np.asarray(ji), outs


def test_render_bounce1_plain_and_compacted_untiled(scenes, monkeypatch):
    """One JAX frame (plain loop) against the port's plain AND compacted
    loops: at bounces=1 the compaction partition is the identity."""
    ji, outs = _render_both(scenes, 5, monkeypatch, PLAIN,
                            [PLAIN, COMPACTED], bounces=1, tile_rays=None)
    assert np.isfinite(ji).all() and ji.mean() > 1e-4
    for pi in outs:
        assert pi.shape == (16, 16, 3)
        np.testing.assert_allclose(pi, ji, rtol=1e-4, atol=1e-6)


def test_render_bounce1_compacted_tiled(scenes, monkeypatch):
    """Two 128-ray tiles with the per-tile key fold, compacted loops."""
    ji, (pi,) = _render_both(scenes, 9, monkeypatch, COMPACTED, [COMPACTED],
                             bounces=1, tile_rays=128)
    np.testing.assert_allclose(pi, ji, rtol=1e-4, atol=1e-6)


def test_render_three_bounces_compacted(scenes, monkeypatch):
    ji, (pi,) = _render_both(scenes, 3, monkeypatch, COMPACTED, [COMPACTED],
                             bounces=3, tile_rays=None)
    assert np.isfinite(pi).all()
    close = np.isclose(pi, ji, rtol=1e-3, atol=1e-3).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    assert abs(pi.mean() - ji.mean()) <= 0.01 * abs(ji.mean())


def test_render_bounce1_through_the_supercluster_build(monkeypatch):
    """A 20k-triangle frame (192 clusters in 3 superclusters) with
    HIER_MAXS 1 and DEFAULT_MAXC_SHARE 4 on both packages, so every main
    pass takes the supercluster build with block lists of 4 slots and
    1 supercluster a block (maxs 1: SC-overflow rows poisoned) and the
    escalation the dense per-ray build: per pixel, and equal overflow."""
    js = jax_dragon(n_tris=20_000, with_sky=True, sky_res=(16, 32))
    ps = scene_from_numpy(jax_scene_arrays(js), "cpu")
    assert ps.clusters.num_clusters > 2 * 1 * 64
    for mod in (JL, PL):
        monkeypatch.setattr(mod, "HIER_MAXS", 1)
        monkeypatch.setattr(mod, "DEFAULT_MAXC_SHARE", 4)
    builds = []
    hier = PL.candidate_clusters_hier

    def spy(*args, **kw):
        out = hier(*args, **kw)
        builds.append(int((out[1][:, -1] < 0).sum()))
        return out

    monkeypatch.setattr(PL, "candidate_clusters_hier", spy)
    kw = dict(width=16, height=16, samples=1, bounces=1, intersect="list",
              estimator="shared", tile_rays=None)
    ji, jaux = JP.render(js, jax_cam(), JaxConfig(**kw),
                         jax.random.PRNGKey(4), with_aux=True)
    with torch.no_grad():
        pi, paux = PP.render(ps, pbrt_dragon_camera("cpu"),
                             RenderConfig(**kw), rng.prng_key(4),
                             with_aux=True)
    assert builds and sum(builds) > 0
    assert paux["overflow"] == bool(jaux["overflow"])
    ji = np.asarray(ji)
    assert np.isfinite(ji).all() and ji.mean() > 1e-4
    np.testing.assert_allclose(pi.numpy(), ji, rtol=1e-4, atol=1e-6)


def test_render_debug_pixel_and_clamp(scenes):
    """The debug-pixel path and the per-sample radiance clamp."""
    _js, ps = scenes
    cfg = RenderConfig(width=16, height=16, samples=2, bounces=2,
                       intersect="list", debug_pixel=(8, 8),
                       max_radiance=0.5)
    with torch.no_grad():
        img = PP.render(ps, pbrt_dragon_camera("cpu"), cfg, rng.prng_key(1))
    assert img.shape == (1, 1, 3)
    assert torch.isfinite(img).all() and (img <= 0.5).all()


_KW_4X4 = dict(width=4, height=4, samples=1, bounces=1, tile_rays=None)


@pytest.fixture(scope="module")
def jax_4x4(scenes):
    """JAX's brute-force bounces=1 4x4 frames of ``scenes`` at key 6, by
    estimator, rendered once each."""
    frames = {}

    def get(estimator):
        if estimator not in frames:
            frames[estimator] = np.asarray(JP.render(
                scenes[0], jax_cam(), JaxConfig(
                    intersect="brute", estimator=estimator, **_KW_4X4),
                jax.random.PRNGKey(6)))
        return frames[estimator]
    return get


def _port_4x4(ps, **kw):
    with torch.no_grad():
        pi, aux = PP.render(ps, pbrt_dragon_camera("cpu"),
                            RenderConfig(**_KW_4X4, **kw), rng.prng_key(6),
                            with_aux=True)
    assert aux["overflow"] is False
    return pi.numpy()


@pytest.mark.parametrize("what", ["intersect", "estimator", "materials"])
def test_unported_paths_raise(scenes, jax_4x4, what):
    """intersect="bvh" (a SAH BVH), estimator="parity" and 2049 materials
    (the unfused shading; no primitive reads the padding rows) render
    JAX's brute-force frame at the same key, per pixel."""
    _js, ps = scenes
    kw = dict(intersect="list", estimator="shared")
    if what == "intersect":
        ps = ps.with_bvh(build_bvh(ps.triangles.numpy(), device="cpu"))
        kw["intersect"] = "bvh"
    elif what == "estimator":
        kw["estimator"] = "parity"
    else:
        m = ps.materials
        ps = ps.with_materials(dataclasses.replace(m, **{
            f: torch.cat([x, x[:1].repeat(2049 - m.count,
                                          *([1] * (x.dim() - 1)))])
            for f, x in vars(m).items()}))
        assert ps.materials.count == 2049
    ji = jax_4x4(kw["estimator"])
    assert np.isfinite(ji).all() and ji.mean() > 1e-4
    np.testing.assert_allclose(_port_4x4(ps, **kw), ji, rtol=1e-4,
                               atol=1e-6)


def test_spheres_raise(scenes):
    """scene_from_numpy carries a JAX scene's spheres, and the fused list
    path's sphere merges render the JAX package's brute-force frame."""
    js, _ps = scenes
    js = jax_add_sphere(js, (0.0, 0.2, 0.5), 0.6, diffuse=(0.2, 0.9, 0.3))
    arrays = jax_scene_arrays(js)
    ps = scene_from_numpy(arrays, "cpu")
    assert ps.num_spheres == 1
    np.testing.assert_array_equal(ps.sphere_centers.numpy(),
                                  arrays["sphere_centers"])
    ji = np.asarray(JP.render(js, jax_cam(), JaxConfig(
        intersect="brute", estimator="shared", **_KW_4X4),
        jax.random.PRNGKey(6)))
    assert np.isfinite(ji).all() and ji.mean() > 1e-4
    np.testing.assert_allclose(
        _port_4x4(ps, intersect="list", estimator="shared"), ji, rtol=1e-4,
        atol=1e-6)


@pytest.mark.card
def test_tile_equals_plain_on_the_card(card):
    """One 32768-ray tile of the 200k dragon's 512x512 frame at 8
    bounces, shared estimator: both list kernels launch, and the radiance
    is the plain twins' bit for bit, certified and finite."""
    ((rad, aux), (rad_p, _aux_p)), launches = tile_both(
        *main_tile(card), estimator="shared")
    assert min(launches.values()) >= 1, launches
    assert torch.equal(rad, rad_p)
    assert not aux["overflow"] and torch.isfinite(rad).all()


def _bench_config(estimator: str, **size) -> dict:
    """The benchmark's configuration of ``estimator`` on a 3000-triangle
    stand-in with a 16x32 sky, at ``size`` (width, height, tile_rays,
    bounces; intersect)."""
    cfg = bench_inputs.load_config(CONFIGS[estimator])
    cfg["mesh"]["standin_triangles"] = 3_000
    cfg["sky"]["height"], cfg["sky"]["width"] = 16, 32
    cfg.update(size)
    return cfg


@pytest.fixture(scope="module")
def bench_scene():
    """(inputs, the port's Frames) of the benchmark's scene at the tests'
    size, built once."""
    cfg = _bench_config("shared")
    inputs = bench_inputs.scene_arrays(cfg)
    return inputs, loops.Frames(inputs, cfg, CPU)


def _frame_against_tiles(bench_scene, estimator, seed, **size):
    """Frame 0 under key(seed) of the port at ``size``: the share of its
    pixels off the estimator's reference rendering each tile alone (the
    benchmark's check: each tile against the tie rule it is nearer), the
    batches the frame took and its mean."""
    inputs, frames = bench_scene
    cfg = _bench_config(estimator, **size)
    frames.rcfg = dataclasses.replace(
        frames.rcfg, width=cfg["width"], height=cfg["height"],
        tile_rays=cfg["tile_rays"], bounces=cfg["bounces"],
        intersect=cfg["intersect"], estimator=estimator)
    metrics.reset_counts()
    img, overflow = frames.frame(ref_rng.key_of_seed(seed), 0)
    assert not overflow and torch.isfinite(img).all()
    tiles = -(-cfg["width"] * cfg["height"] // cfg["tile_rays"])
    pairs = [(0, t) for t in range(tiles)]
    ref = bench_check.reference_tiles(inputs, cfg, ref_rng.key_of_seed(seed),
                                      pairs, CPU)
    prog = {(0, t): bench_check.tile_rows(img, t, cfg["tile_rays"])
            for _f, t in pairs}
    off = bench_check.pixels_off(prog, ref, cfg, {"pixel_atol": 1e-6,
                                                  "pixel_rtol": 1e-4})
    return off, metrics.COUNTS["render.batches"], float(img.mean())


# (frame size, COMPACT_MIN_B on both sides, BATCH_RAYS, batches): 16x12
# in 2 tiles of 128 rays, the last padded, one batch, on the compacted
# wavefront and on the plain loop; 3 tiles of 80 rays (the last padded)
# in two batches of 2 and 1 tiles
FRAMES = {
    "compacted": (dict(width=16, height=12, tile_rays=128), 1, None, 1),
    "plain": (dict(width=16, height=12, tile_rays=128), None, None, 1),
    "two_batches": (dict(width=16, height=12, tile_rays=80), 1, 160, 2),
}


@pytest.mark.parametrize("case", list(FRAMES))
def test_batched_frame_equals_the_reference_tiles(bench_scene, monkeypatch,
                                                  case):
    size, min_b, batch, batches = FRAMES[case]
    if min_b is not None:
        for mod in (PP, pathtrace):
            monkeypatch.setattr(mod, "COMPACT_MIN_B", min_b)
    if batch is not None:
        monkeypatch.setattr(PP, "BATCH_RAYS", batch)
    off, made, mean = _frame_against_tiles(bench_scene, "shared",
                                           2 ** 31 + 29, bounces=3, **size)
    assert made == batches and mean > 1e-3
    assert off == 0.0


@pytest.mark.parametrize("estimator", ["shared", "parity"])
def test_batched_grad_frame_equals_its_tiles(bench_scene, monkeypatch,
                                             estimator):
    """A tiled render with the diffuse albedo requiring grad (remat on,
    compacted where shared): three tiles of 80 rays in one batch give
    the radiance and the gradient of three batches of one tile."""
    frames = bench_scene[1]
    monkeypatch.setattr(PP, "COMPACT_MIN_B", 1)
    cfg = RenderConfig(width=16, height=12, samples=1, bounces=2,
                       intersect="list", estimator=estimator, tile_rays=80)
    out = {}
    for batch in (PP.BATCH_RAYS, 80):
        monkeypatch.setattr(PP, "BATCH_RAYS", batch)
        diffuse = frames.scene.materials.diffuse.clone().requires_grad_()
        scene = frames.scene.with_materials(dataclasses.replace(
            frames.scene.materials, diffuse=diffuse))
        metrics.reset_counts()
        img, aux = PP.render(scene, frames.camera, cfg, rng.prng_key(13),
                             with_aux=True)
        assert not aux["overflow"]
        (img * torch.linspace(0.5, 1.5, img.numel()).reshape(
            img.shape)).sum().backward()
        out[batch] = (img.detach(), diffuse.grad,
                      metrics.COUNTS["render.batches"])
    (img, grad, made), (img_t, grad_t, made_t) = out.values()
    assert (made, made_t) == (1, 3)
    assert float(img.mean()) > 1e-3 and grad.abs().sum() > 0
    torch.testing.assert_close(img, img_t, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(grad, grad_t, rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def frames870k(card):
    """The benchmark's 870k stand-in and sky on the card: (inputs, the
    port's Frames of the preview cell's configuration)."""
    cfg = bench_inputs.load_config(CONFIGS["shared"])
    inputs = bench_inputs.scene_arrays(cfg)
    return inputs, loops.Frames(inputs, cfg, card)


@pytest.mark.card
@pytest.mark.parametrize("estimator", ["shared", "parity"])
def test_870k_frame_equals_the_reference_tiles_on_the_card(frames870k, card,
                                                           estimator):
    """The preview cells' 512x512 8-bounce frame on the 870k stand-in, its
    8 tiles in one batch, in each estimator: certified, finite, and at
    most 0.1% of its pixels off the estimator's reference rendering each
    tile alone on the card (the benchmark's check, every tile)."""
    inputs, frames = frames870k
    cfg = bench_inputs.load_config(CONFIGS[estimator])
    traffic = manifest.traffic("preview")
    frames.rcfg = dataclasses.replace(frames.rcfg, estimator=estimator)
    seed = 2 ** 31 + 290
    metrics.reset_counts()
    img, overflow = frames.frame(ref_rng.key_of_seed(seed), 0)
    assert metrics.COUNTS["render.batches"] == 1
    assert not overflow and torch.isfinite(img).all()
    off = loops.frame_checks(inputs, cfg, traffic, seed, [img], card)
    # room for pixels on a tie in t only: one tile of the 8 drawn under
    # a wrong key or at wrong places moves ~12.5% of the pixels
    assert off <= 1e-3, off
