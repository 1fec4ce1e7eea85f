"""The port's intersection backends against the JAX package's on the same
inputs (made from a numpy seed): Möller–Trumbore, brute-force occlusion,
the sphere quadric and hit merging (ops/intersect.py), the cluster pair
tracer with its budgets and fanout (ops/cluster.py) and the threaded BVH
(ops/bvh.py).

Tolerances: prim, hit, blocked and overflow identical; t within 1e-5
(the golden tolerance, tests/test_golden_rays.py:20: float32 op order
may differ between XLA and torch).  A SAH BVH is built by the port's own
native builder and its tables are given to both packages, as
tests/test_torch_cluster.py does for the SAH cluster order; Morton
tables are compared entry for entry.

On a card (marked ``card``): the unfused shading of more than 2048
materials against the fused one, at least 99% of rays within 1e-3 and
the means within 1% (tests/test_torch_pathtracer.py's 3-bounce frames);
every backend's frame against brute force's per pixel within rtol 2e-4
/ atol 1e-5 (tests/test_integrator.py:293-294).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sycl_ray_tracing_tpu.ops import bvh as JB
from sycl_ray_tracing_tpu.ops import cluster as JC
from sycl_ray_tracing_tpu.ops import intersect as JI
from sycl_ray_tracing_tpu.utils.procedural import dragon_standin
from sycl_ray_tracing_tpu_torch.models import pathtracer as PP
from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
from sycl_ray_tracing_tpu_torch.models.scene import add_sphere
from sycl_ray_tracing_tpu_torch.ops import bvh as PB
from sycl_ray_tracing_tpu_torch.ops import cluster as PC
from sycl_ray_tracing_tpu_torch.ops import intersect as PI
from sycl_ray_tracing_tpu_torch.ops.rng import prng_key
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_scene
from torch_card import BOUNCES, H, TILE, W, card, tile_both  # noqa: F401

T_TOL = 1e-5


def _rays(n, seed, lo=-3.0, hi=3.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module")
def tris():
    return dragon_standin(2_000)


@pytest.fixture(scope="module")
def rays():
    return _rays(256, 3)


def _same_t(pt, jt, where):
    np.testing.assert_allclose(pt.numpy()[where], np.asarray(jt)[where],
                               rtol=T_TOL, atol=T_TOL)


def test_moller_trumbore_broadcast(tris, rays):
    """[R,1,3] rays against [1,N,3,3] triangles: t where valid, u, v."""
    o, d = rays
    sub = tris[:300]
    jt, ju, jv, jok = jax.jit(JI.moller_trumbore)(
        jnp.asarray(o)[:, None], jnp.asarray(d)[:, None],
        jnp.asarray(sub)[None])
    pt, pu, pv, pok = PI.moller_trumbore(_t(o)[:, None], _t(d)[:, None],
                                         _t(sub)[None])
    assert pt.shape == (256, 300)
    np.testing.assert_array_equal(pok.numpy(), np.asarray(jok))
    assert pok.any()
    _same_t(pt, jt, np.asarray(jok))
    for p, j in ((pu, ju), (pv, jv)):
        np.testing.assert_allclose(p.numpy()[np.asarray(jok)],
                                   np.asarray(j)[np.asarray(jok)],
                                   rtol=1e-4, atol=1e-5)


def test_brute_closest_and_any_hit(tris, rays):
    o, d = rays
    jh = jax.jit(JI.intersect_triangles)(jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(tris))
    ph = PI.intersect_triangles(_t(o), _t(d), _t(tris))
    hit = np.asarray(jh.hit)
    assert 0 < hit.sum() < hit.size
    np.testing.assert_array_equal(ph.hit.numpy(), hit)
    np.testing.assert_array_equal(ph.prim.numpy()[hit],
                                  np.asarray(jh.prim)[hit])
    _same_t(ph.t, jh.t, hit)
    t_lim = np.where(hit, np.asarray(jh.t) * 0.999, 10.0).astype(np.float32)
    for lim in (t_lim, np.full_like(t_lim, JI.BIG_T)):
        jb = jax.jit(JI.any_hit_triangles)(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris),
            jnp.asarray(lim))
        pb = PI.any_hit_triangles(_t(o), _t(d), _t(tris), _t(lim))
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    assert pb.any()


def test_spheres_merge_and_miss(rays):
    o, d = rays
    rng = np.random.default_rng(5)
    centers = rng.uniform(-2.0, 2.0, (4, 3)).astype(np.float32)
    radii = rng.uniform(0.3, 1.2, 4).astype(np.float32)
    prim = np.arange(100, 104, dtype=np.int32)
    js = jax.jit(JI.intersect_spheres)(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(centers),
        jnp.asarray(radii), jnp.asarray(prim))
    ps = PI.intersect_spheres(_t(o), _t(d), _t(centers), _t(radii),
                              _t(prim))
    hit = np.asarray(js.hit)
    assert 0 < hit.sum() < hit.size
    np.testing.assert_array_equal(ps.hit.numpy(), hit)
    np.testing.assert_array_equal(ps.prim.numpy(), np.asarray(js.prim))
    _same_t(ps.t, js.t, hit)
    np.testing.assert_allclose(ps.normal.numpy()[hit],
                               np.asarray(js.normal)[hit], atol=1e-4)
    # merged with the triangles' hits: the nearer of the two, per ray
    tris = dragon_standin(500)
    jm = jax.jit(lambda o, d, t, s: JI.merge_hits(
        JI.intersect_triangles(o, d, t), s))(jnp.asarray(o), jnp.asarray(d),
                                             jnp.asarray(tris), js)
    pm = PI.merge_hits(PI.intersect_triangles(_t(o), _t(d), _t(tris)), ps)
    np.testing.assert_array_equal(pm.prim.numpy(), np.asarray(jm.prim))
    np.testing.assert_array_equal(pm.hit.numpy(), np.asarray(jm.hit))
    _same_t(pm.t, jm.t, np.asarray(jm.hit))
    # the all-miss record is merge_hits' identity
    miss = PI.miss_hit(256)
    jmiss = JI.miss_hit(256)
    for f in PI.Hit._fields:
        np.testing.assert_array_equal(getattr(miss, f).numpy(),
                                      np.asarray(getattr(jmiss, f)))
    back = PI.merge_hits(miss, ps)
    np.testing.assert_array_equal(back.prim.numpy()[hit], prim[
        np.asarray(js.prim)[hit] - 100])


def test_sphere_gradient_matches_jax(rays):
    """d(sum of hit t) / d(center, radius) through the quadric."""
    o, d = rays
    centers = np.array([[0.5, 0.0, 0.2], [-1.0, 0.8, 0.0]], np.float32)
    radii = np.array([1.0, 0.6], np.float32)
    prim = np.array([7, 8], np.int32)

    def jloss(c, r):
        h = JI.intersect_spheres(jnp.asarray(o), jnp.asarray(d), c, r,
                                 jnp.asarray(prim))
        return jnp.sum(jnp.where(h.hit, h.t, 0.0))

    jgc, jgr = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(centers),
                                               jnp.asarray(radii))
    c, r = _t(centers).requires_grad_(), _t(radii).requires_grad_()
    h = PI.intersect_spheres(_t(o), _t(d), c, r, _t(prim))
    torch.where(h.hit, h.t, 0.0).sum().backward()
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(jgc), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(jgr), rtol=1e-4,
                               atol=1e-4)


@pytest.fixture(scope="module")
def clusters(tris):
    perm = PC.sah_order(tris)
    return (JC.build_clusters(tris, order=perm),
            PC.build_clusters(tris, order=perm, device="cpu"))


@pytest.mark.parametrize("budgets,fanout", [
    ((2048, 8192), 0),   # roomy: exact
    ((4, 4), 0),         # the render test's overflowing budgets
    ((2048, 8192), 2),   # the fanout branch (pairs past 2 children drop)
    ((128, 200), 0),     # phase 2 overflows (268 pairs), phase 1 not (80)
], ids=["roomy", "tiny", "fanout2", "p2-short"])
def test_pair_tracer_matches_jax(clusters, rays, budgets, fanout):
    """closest_hit and any_hit of the XLA pair tracer: (t, prim, blocked,
    overflow) against the JAX package's, and with roomy budgets against
    the brute-force oracle."""
    o, d = rays
    jcs, pcs = clusters
    jcs = jcs.with_budgets(*budgets).with_fanout(fanout)
    pcs = pcs.with_budgets(*budgets).with_fanout(fanout)
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    jt, jp, jov = jax.jit(JC.closest_hit)(jcs, jo, jd)
    pt, pp, pov = PC.closest_hit(pcs, _t(o), _t(d))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    assert bool(pov) == bool(jov)
    _same_t(pt, jt, np.asarray(jp) >= 0)
    t_max = np.where(np.asarray(jp) >= 0, np.asarray(jt) * 1.001,
                     JI.BIG_T).astype(np.float32)
    jb, jbo = jax.jit(JC.any_hit)(jcs, jo, jd, jnp.asarray(t_max))
    pb, pbo = PC.any_hit(pcs, _t(o), _t(d), _t(t_max))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    assert bool(pbo) == bool(jbo)
    if budgets in ((4, 4), (128, 200)) or fanout:
        assert bool(pov)
    if budgets == (2048, 8192) and not fanout:
        assert not bool(pov)
        ref = PI.intersect_triangles(_t(o), _t(d),
                                     _t(dragon_standin(2_000)))
        np.testing.assert_array_equal(pp.numpy() >= 0, ref.hit.numpy())
        assert (pp.numpy() >= 0).sum() > 20


def test_pair_compaction_matches_jax():
    """_compact_mask's rows, columns, validity, overflow and payload rows
    equal the JAX package's, at a budget below and above the count."""
    rng = np.random.default_rng(2)
    mask = rng.uniform(size=(37, 64)) < 0.1
    payload = rng.integers(0, 1000, (37, 3)).astype(np.int32)
    for budget in (64, 512):
        j = jax.jit(JC._compact_mask, static_argnums=1)(
            jnp.asarray(mask), budget, jnp.asarray(payload))
        p = PC._compact_mask(_t(mask), budget, _t(payload))
        for a, b in zip(p, j):
            np.testing.assert_array_equal(np.asarray(a.numpy()),
                                          np.asarray(b))


def test_intersect_clusters_hit_record(clusters, tris, rays):
    """The differentiable hit record of the cluster backend equals the
    brute-force one, and the overflow flag reaches ``of``."""
    o, d = rays
    _jcs, pcs = clusters
    of = []
    h = PC.intersect_clusters(pcs.with_budgets(2048, 8192), _t(tris), _t(o),
                              _t(d), of)
    ref = PI.intersect_triangles(_t(o), _t(d), _t(tris))
    assert len(of) == 1 and not bool(of[0])
    torch.testing.assert_close(h.t, ref.t)
    assert torch.equal(h.prim, ref.prim) and torch.equal(h.hit, ref.hit)


def test_intersect_list_hit_record(rays):
    """intersect_list (the list backend's hit record, listtrace.py:
    900-912) against the JAX package's brute-force oracle on random
    triangles (tests/test_pallas_listtrace.py:250-265)."""
    from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as PL

    tris = np.random.default_rng(5).uniform(-1, 1, (200, 3, 3)).astype(
        np.float32)
    o, d = _rays(128, 6, -1.5, 1.5)
    of = []
    h = PL.intersect_list(PC.build_clusters(tris, device="cpu"), _t(tris),
                          _t(o), _t(d), of)
    ref = jax.jit(JI.intersect_triangles)(jnp.asarray(o), jnp.asarray(d),
                                          jnp.asarray(tris))
    hit = np.asarray(ref.hit)
    assert len(of) == 1 and not bool(of[0]) and hit.sum() > 10
    np.testing.assert_array_equal(h.hit.numpy(), hit)
    np.testing.assert_array_equal(h.prim.numpy()[hit],
                                  np.asarray(ref.prim)[hit])
    np.testing.assert_allclose(h.point.numpy()[hit],
                               np.asarray(ref.point)[hit], rtol=1e-4,
                               atol=1e-5)


def test_default_budgets_match_jax():
    for n, k1 in ((256, 1), (32768, 25), (32768, 106)):
        assert PC.default_budgets(n, k1) == JC.default_budgets(n, k1)


@pytest.mark.parametrize("leaf_size", [4, 3])
def test_morton_bvh_tables_identical(tris, leaf_size):
    jb = JB.build_bvh(tris, leaf_size=leaf_size, method="morton")
    arrays = PB.build_bvh_arrays(tris, leaf_size, "morton")
    for f in PB.BVH_FIELDS:
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jb, f)),
                                      err_msg=f)


def _jax_bvh(arrays, leaf_size=4):
    return JB.ThreadedBVH(**{f: jnp.asarray(arrays[f])
                             for f in PB.BVH_FIELDS}, leaf_size=leaf_size)


@pytest.mark.parametrize("method", ["morton", "sah"])
def test_bvh_walks_match_jax(tris, rays, method):
    """closest_prim and any_hit of the lockstep walk against the JAX
    package's on the same tables, and against the brute-force oracle."""
    o, d = rays
    arrays = PB.build_bvh_arrays(tris, 4, method)
    jb = _jax_bvh(arrays)
    pb = PB.bvh_from_numpy(arrays, "cpu")
    jt, jp = JB.closest_prim(jb, jnp.asarray(o), jnp.asarray(d))
    PB.reset_walk_steps()
    pt, pp = PB.closest_prim(pb, _t(o), _t(d))
    assert PB.WALK_STEPS["closest"] > 0
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    _same_t(pt, jt, np.asarray(jp) >= 0)
    ref = PI.intersect_triangles(_t(o), _t(d), _t(tris))
    np.testing.assert_array_equal(pp.numpy() >= 0, ref.hit.numpy())
    t_max = np.where(np.asarray(jp) >= 0, np.asarray(jt) * 1.001,
                     JI.BIG_T).astype(np.float32)
    t_max[::2] = np.asarray(jt)[::2] * 0.5     # unblocked below the hit
    jblk = JB.any_hit(jb, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max))
    pblk = PB.any_hit(pb, _t(o), _t(d), _t(t_max))
    np.testing.assert_array_equal(pblk.numpy(), np.asarray(jblk))
    assert pblk.any() and not pblk.all()
    h = PB.intersect_bvh(pb, _t(tris), _t(o), _t(d))
    assert torch.equal(h.prim, ref.prim) and torch.equal(h.hit, ref.hit)


def test_bvh_check_interval_changes_nothing(tris, rays, monkeypatch):
    """The walk tests for active rays every CHECK_EVERY steps; steps past
    the last active ray change no answer."""
    o, d = rays
    pb = PB.build_bvh(tris, method="morton", device="cpu")
    outs = []
    for every in (1, 7, 64):
        monkeypatch.setattr(PB, "CHECK_EVERY", every)
        outs.append((PB.closest_prim(pb, _t(o), _t(d)),
                     PB.any_hit(pb, _t(o), _t(d),
                                torch.full((256,), 5.0))))
    for (ct, blk) in outs[1:]:
        assert torch.equal(ct[0], outs[0][0][0])
        assert torch.equal(ct[1], outs[0][0][1])
        assert torch.equal(blk, outs[0][1])


# ---- on a card ----

# two spheres in the dragon camera's view (tests/test_integrator.py:243-290)
SPHERES = (((1.5, 0.0, 0.0), 0.5, dict(diffuse=(0.8, 0.3, 0.2))),
           ((-1.2, 0.5, 0.8), 0.35, dict(metalness=0.5, roughness=0.3)))


@pytest.fixture(scope="module")
def sphere_scene(card):
    """The 4k dragon with its sky and the two spheres on the card, with
    clusters for 32768-ray tiles and a SAH BVH; the camera; the key."""
    s = dragon_scene(4_000, with_sky=True, build_accel=False, device=card)
    for center, radius, mat in SPHERES:
        s = add_sphere(s, center, radius, **mat)
    s = s.build_acceleration(num_rays_hint=TILE)
    s = s.with_bvh(PB.build_bvh(s.triangles.cpu().numpy(), device=card))
    return s, pbrt_dragon_camera(card), prng_key(0)


def _tile(row, device):
    """Pixel coordinates of the 512x512 frame's tile from ``row`` on."""
    pix = torch.arange(row * W, row * W + TILE, device=device)
    return (pix % W).float(), (pix // W).float()


@pytest.mark.card
def test_sphere_tile_equals_plain_on_the_card(sphere_scene):
    """The tile from row 288, where primary rays end on the spheres, at 8
    bounces through the fused list path: the kernels' radiance is the
    plain twins' bit for bit, certified."""
    scene, cam, key = sphere_scene
    px, py = _tile(H * 9 // 16, scene.device)
    o, d = cam.generate_rays(px + 0.5, py + 0.5, W, H)
    assert (PP.intersect_scene(scene, o, d, "list").prim
            >= scene.num_triangles).any()
    ((rad, aux), (rad_p, _aux_p)), _launches = tile_both(
        scene, cam, px, py, key, backend="list", estimator="shared")
    assert torch.equal(rad, rad_p)
    assert not aux["overflow"] and torch.isfinite(rad).all()


@pytest.mark.card
def test_unfused_materials_agree_with_fused_on_the_card(sphere_scene,
                                                         monkeypatch):
    """The materials padded to 2049 rows take the unfused shading: on the
    first tile, uncompacted so both loops give each ray the same lanes,
    against the fused path on the unpadded scene."""
    scene, cam, key = sphere_scene
    m = scene.materials
    padded = scene.with_materials(dataclasses.replace(m, **{
        f: torch.cat([x, x[:1].repeat(2049 - m.count,
                                      *([1] * (x.dim() - 1)))])
        for f, x in vars(m).items()}))
    monkeypatch.setattr(PP, "COMPACT_MIN_B", 1 << 30)
    px, py = _tile(0, scene.device)
    with torch.no_grad():
        rads = [PP.render_rays(s, cam, px, py, W, H, key, 1, BOUNCES,
                               backend="list", estimator="shared")
                for s in (scene, padded)]
    close = torch.isclose(rads[1], rads[0], rtol=1e-3, atol=1e-3).all(-1)
    assert close.float().mean() >= 0.99
    m0, m1 = float(rads[0].mean()), float(rads[1].mean())
    assert abs(m1 - m0) <= 0.01 * abs(m0)


@pytest.mark.card
@pytest.mark.parametrize("estimator", ["shared", "parity"])
def test_backends_equal_brute_force_on_the_card(sphere_scene, estimator):
    """The 64x64 frame at 2 spp and 3 bounces through the list tracer,
    the cluster pair tracer and the BVH: certified, brute force's."""
    scene, cam, key = sphere_scene
    imgs = {}
    with torch.no_grad():
        for be in ("brute", "list", "cluster", "bvh"):
            cfg = RenderConfig(64, 64, samples=2, bounces=3, intersect=be,
                               estimator=estimator, tile_rays=TILE)
            imgs[be], aux = PP.render(scene, cam, cfg, key, with_aux=True)
            assert not aux["overflow"] and torch.isfinite(imgs[be]).all()
    for be in ("list", "cluster", "bvh"):
        torch.testing.assert_close(imgs[be], imgs["brute"], rtol=2e-4,
                                   atol=1e-5, msg=be)
