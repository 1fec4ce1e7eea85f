"""The port's render (fused list path of trace_shared) against the JAX
package's render on the very same scene (scene_from_numpy) and keys.

Tolerances: at bounces=1 every pixel within rtol 1e-4 / atol 1e-6 (the
same samples; only float32 op order differs).  At 3 bounces, compacted,
at least 99% of pixels within 1e-3 and frame means within 1%: a last-ulp
difference can flip one secondary hit and with it a whole path."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sycl_ray_tracing_tpu.models import pathtracer as JP
from sycl_ray_tracing_tpu.models.camera import pbrt_dragon_camera as jax_cam
from sycl_ray_tracing_tpu.utils.config import RenderConfig as JaxConfig
from sycl_ray_tracing_tpu.utils.procedural import dragon_scene as jax_dragon
from sycl_ray_tracing_tpu_torch.models import pathtracer as PP
from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
from sycl_ray_tracing_tpu_torch.models.scene import scene_from_numpy
from sycl_ray_tracing_tpu_torch.ops import rng
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
from tests.test_torch_cluster import jax_scene_arrays


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


@pytest.mark.parametrize("what", ["intersect", "estimator", "materials"])
def test_unported_paths_raise(scenes, what):
    _js, ps = scenes
    cfg = RenderConfig(width=4, height=4, samples=1, bounces=1,
                       intersect="list", tile_rays=None)
    if what == "intersect":
        cfg = dataclasses.replace(cfg, intersect="bvh")
    elif what == "estimator":
        cfg = dataclasses.replace(cfg, estimator="parity")
    else:
        m = ps.materials
        many = 2049
        ps = dataclasses.replace(ps, materials=dataclasses.replace(
            m, emission=m.emission[:1].repeat(many, 1),
            diffuse=m.diffuse[:1].repeat(many, 1),
            metalness=m.metalness[:1].repeat(many),
            roughness=m.roughness[:1].repeat(many)))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        with torch.no_grad():
            PP.render(ps, pbrt_dragon_camera("cpu"), cfg, rng.prng_key(0))


def test_spheres_raise(scenes):
    js, _ps = scenes
    arrays = jax_scene_arrays(js)
    arrays["sphere_radii"] = np.ones(1, np.float32)
    with pytest.raises(NotImplementedError, match="spheres"):
        scene_from_numpy(arrays, "cpu")
