"""The port's gradients against the JAX package's (``jax.grad``) on the
very same scene (scene_from_numpy: the 2k dragon with a 16x32 sky) and
keys, with the list tracer on both sides (the JAX package's Pallas kernel
in interpret mode, as its own CPU tests run it).

Each JAX gradient is computed once, in a module fixture, by one jitted
value-and-grad over every parameter a test reads.

Tolerances:
  * bounces=1 (diffuse [M,3], the sky's texels and the vertices, per
    element): rtol 1e-4, the forward frames' own tolerance
    (tests/test_torch_pathtracer.py): the same samples, only float32 op
    order differs.  A vertex entry sums terms that cancel, so it may also
    be off by 1e-5 of the largest entry.
  * 2 bounces, compacted: diffuse within 2e-3 + 5% of JAX's and of the
    port's central finite difference (tests/test_integrator.py:352-384);
    roughness, emission, metalness, the sky's scale and the camera's dz
    as directional derivatives within tests/test_gradients.py:51-132's
    tolerances; the vertices' scale like roughness.
  * remat against no remat: the values equal, gradients within rtol 1e-5.

On a card (marked ``card``), on the main path's tile at 8 bounces: the
backward launches no list kernel; the kernels' gradient with remat
within GRAD_RTOL of the largest entry of the one without remat and of the
plain twins' (float32 sums in another order); AD against a central
difference within 2e-3 + 5%.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sycl_ray_tracing_tpu.models import pathtracer as JP
from sycl_ray_tracing_tpu.models.camera import Camera as JaxCamera
from sycl_ray_tracing_tpu.ops import transform as JT
from sycl_ray_tracing_tpu.utils.config import RenderConfig as JaxConfig
from sycl_ray_tracing_tpu.utils.procedural import dragon_scene as jax_dragon
from sycl_ray_tracing_tpu_torch.models import pathtracer as PP
from sycl_ray_tracing_tpu_torch.models.camera import Camera
from sycl_ray_tracing_tpu_torch.models.scene import scene_from_numpy
from sycl_ray_tracing_tpu_torch.ops import envmap as penv
from sycl_ray_tracing_tpu_torch.ops import rng
from sycl_ray_tracing_tpu_torch.ops import transform as T
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as PL
from test_torch_cluster import jax_scene_arrays
from torch_card import BOUNCES, H, W, card, main_tile  # noqa: F401

PLAIN, COMPACTED = 1 << 30, 1   # COMPACT_MIN_B values forcing each loop
SEED = 7
ONE = dict(width=8, height=8, samples=1, bounces=1)    # per-element case
TWO = dict(width=8, height=8, samples=2, bounces=2)    # compacted case
SCALES = ("roughness", "emission", "metalness", "sky")
# (rtol, atol) of tests/test_gradients.py:51-132 for each scalar; "scale"
# is the vertices' scale (1 + s), sum(grad * triangles)
SCALAR_TOL = dict(roughness=(2e-2, 5e-4), emission=(1e-2, 1e-6),
                  metalness=(5e-2, 5e-4), sky=(2e-2, 1e-6),
                  dz=(0.1, 2e-3), scale=(2e-2, 5e-4))
GRAD_RTOL = 1e-4    # on the card: two routes' gradients, of max |g|


@contextlib.contextmanager
def _compact_min_b(module, value):
    old = module.COMPACT_MIN_B
    module.COMPACT_MIN_B = value
    try:
        yield
    finally:
        module.COMPACT_MIN_B = old


def _jax_grads(js, frame, min_b):
    """value and grads of the mean frame w.r.t. diffuse [M,3], the sky
    image, the vertices, the scalar shifts in SCALES and dz (plus the
    vertices' "scale"); JAX at COMPACT_MIN_B."""
    mats, env = js.materials, js.env_map
    cfg = JaxConfig(intersect="list", estimator="shared", tile_rays=None,
                    **frame)

    def loss(p):
        m = dataclasses.replace(
            mats, diffuse=p["diffuse"],
            roughness=mats.roughness * (1.0 + p["roughness"]),
            emission=mats.emission * (1.0 + p["emission"]),
            metalness=mats.metalness * (1.0 + p["metalness"]))
        scene = dataclasses.replace(
            js, materials=m, triangles=p["tris"],
            env_map=env._replace(image=p["image"] * (1.0 + p["sky"])))
        view = JT.compose(
            JT.compose(JT.rotation_x(-45.0),
                       JT.translation(0.0, -1.0, 10.5 + p["dz"])),
            jnp.diag(jnp.array([1.0, 1.0, -1.0, 1.0])))
        cam = JaxCamera(view_matrix=view, fov_dist=jnp.float32(
            1.0 / np.tan(np.radians(22.5))))
        return jnp.mean(JP.render(scene, cam, cfg, jax.random.PRNGKey(SEED)))

    p = dict(diffuse=mats.diffuse, image=env.image, tris=js.triangles,
             dz=jnp.float32(0.0), **{k: jnp.float32(0.0) for k in SCALES})
    with _compact_min_b(JP, min_b):
        v, g = jax.jit(jax.value_and_grad(loss))(p)
    g = {k: np.asarray(x) for k, x in g.items()}
    g["scale"] = np.sum(g["tris"] * np.asarray(js.triangles))
    return float(v), g


def _port_camera(dz=0.0):
    return Camera.create(45.0, T.compose(
        T.rotation_x(-45.0), T.translation(0.0, -1.0, 10.5 + dz)), "cpu")


def _port_frame(ps, frame, remat=True, estimator="shared"):
    """The port's counterpart of _jax_grads' loss: (frame, parameters)."""
    p = dict(diffuse=ps.materials.diffuse.clone(),
             image=ps.env_map.image.clone(), tris=ps.triangles.clone(),
             dz=torch.tensor(0.0), **{k: torch.tensor(0.0) for k in SCALES})
    for x in p.values():
        x.requires_grad_()
    mats = ps.materials
    m = dataclasses.replace(
        mats, diffuse=p["diffuse"],
        roughness=mats.roughness * (1.0 + p["roughness"]),
        emission=mats.emission * (1.0 + p["emission"]),
        metalness=mats.metalness * (1.0 + p["metalness"]))
    scene = dataclasses.replace(
        ps.with_materials(m).with_env_map(p["image"] * (1.0 + p["sky"])),
        triangles=p["tris"])
    cfg = RenderConfig(intersect="list", estimator=estimator, tile_rays=None,
                       remat=remat, **frame)
    return PP.render(scene, _port_camera(p["dz"]), cfg,
                     rng.prng_key(SEED)), p


def _port_grads(ps, frame, min_b):
    """(value, {name: grad}) of the port's frame at COMPACT_MIN_B."""
    with _compact_min_b(PP, min_b):
        img, p = _port_frame(ps, frame)
        img.mean().backward()
    g = {k: x.grad.numpy() for k, x in p.items()}
    g["scale"] = np.sum(g["tris"] * ps.triangles.numpy())
    return float(img.detach().mean()), g


@pytest.fixture(scope="module")
def scenes():
    js = jax_dragon(n_tris=2_000, with_sky=True, sky_res=(16, 32))
    return js, scene_from_numpy(jax_scene_arrays(js), "cpu")


@pytest.fixture(scope="module")
def jax_one(scenes):
    return _jax_grads(scenes[0], ONE, PLAIN)


@pytest.fixture(scope="module")
def two(scenes):
    """(JAX's, the port's) value and grads at 2 bounces, compacted."""
    return (_jax_grads(scenes[0], TWO, COMPACTED),
            _port_grads(scenes[1], TWO, COMPACTED))


@pytest.mark.parametrize("min_b", [PLAIN, COMPACTED],
                         ids=["plain", "compacted"])
def test_diffuse_bounce1_per_element(scenes, jax_one, min_b):
    """At bounces=1 the compaction partition is the identity, so both
    loops hold JAX's plain loop per element."""
    jv, jg = jax_one
    pv, pg = _port_grads(scenes[1], ONE, min_b)
    assert np.isfinite(pg["diffuse"]).all() and np.abs(pg["diffuse"]).sum()
    np.testing.assert_allclose(pv, jv, rtol=1e-5)
    np.testing.assert_allclose(pg["diffuse"], jg["diffuse"], rtol=1e-4,
                               atol=1e-9)


def test_sky_texel_gradient_matches_jax(scenes, jax_one):
    """Scene.with_env_map keeps a torch image in the graph and the pdf's
    luminance is detached, as in the JAX package: per texel."""
    _jv, jg = jax_one
    _pv, pg = _port_grads(scenes[1], ONE, PLAIN)
    assert np.abs(jg["image"]).sum() > 0
    np.testing.assert_allclose(pg["image"], jg["image"], rtol=1e-4,
                               atol=1e-9)


def test_vertex_gradient_per_element(scenes, jax_one):
    """The vertices' gradient, through finalize_hit's re-intersection of
    each winner and the light rows' area samples: per element."""
    _jv, jg = jax_one
    _pv, pg = _port_grads(scenes[1], ONE, PLAIN)
    top = np.abs(jg["tris"]).max()
    assert top > 0
    np.testing.assert_allclose(pg["tris"], jg["tris"], rtol=1e-4,
                               atol=1e-5 * top)


def test_diffuse_two_bounces_compacted(scenes, two):
    """Against JAX's AD, and against the port's own central finite
    difference of one entry (the ground's red)."""
    ps = scenes[1]
    (_jv, jg), (_pv, pg) = two
    g = pg["diffuse"]
    assert np.isfinite(g).all()
    assert (np.abs(g - jg["diffuse"])
            <= 2e-3 + 0.05 * np.abs(jg["diffuse"])).all()
    cfg = RenderConfig(intersect="list", estimator="shared", tile_rays=None,
                       **TWO)
    eps = 1e-2

    def mean_at(delta):
        d = ps.materials.diffuse.clone()
        d[2, 0] += delta
        scene = ps.with_materials(dataclasses.replace(ps.materials,
                                                      diffuse=d))
        with torch.no_grad(), _compact_min_b(PP, COMPACTED):
            return float(PP.render(scene, _port_camera(), cfg,
                                   rng.prng_key(SEED)).mean())

    fd = (mean_at(eps) - mean_at(-eps)) / (2 * eps)
    assert g[2, 0] > 0 and abs(g[2, 0] - fd) <= 2e-3 + 0.05 * abs(fd), (
        g[2, 0], fd)


@pytest.mark.parametrize("name", sorted(SCALAR_TOL))
def test_scalar_gradients_match_jax(two, name):
    """Roughness, emission, metalness, the sky's and the vertices' scale
    (1 + s) and the camera's dz: 2 bounces, 2 samples, compacted (so the
    port checkpoints each sample and each bounce), against JAX's AD."""
    (jv, jg), (pv, pg) = two
    rtol, atol = SCALAR_TOL[name]
    assert np.isfinite(pg[name]) and jg[name] != 0.0
    np.testing.assert_allclose(pv, jv, rtol=1e-2)
    np.testing.assert_allclose(pg[name], jg[name], rtol=rtol, atol=atol)


@pytest.mark.parametrize("min_b,estimator", [(PLAIN, "shared"),
                                             (COMPACTED, "shared"),
                                             (PLAIN, "parity")],
                         ids=["plain", "compacted", "parity"])
def test_remat_matches_no_remat_and_never_traces_again(scenes, monkeypatch,
                                                       min_b, estimator):
    """remat=True against remat=False: equal values, gradients within
    rtol 1e-5; with remat the backward pass replays every checkpointed
    bounce and sample from the recorded list-tracer answers and calls
    multi_query zero times.  The parity estimator's replay takes every
    bounce's fused call, and the primaries', from the tape."""
    calls, replays = [], []
    query, orig = PP._QueryTape.query, PP.multi_query

    def spy_query(self, bounce, *a, **kw):
        replays.append(bounce)
        return query(self, bounce, *a, **kw)

    def spy_multi(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    monkeypatch.setattr(PP, "multi_query", spy_multi)
    monkeypatch.setattr(PP._QueryTape, "query", spy_query)
    out = {}
    for remat in (False, True):
        with _compact_min_b(PP, min_b):
            img, p = _port_frame(scenes[1], TWO, remat=remat,
                                 estimator=estimator)
            assert calls and replays
            calls.clear()
            replays.clear()
            img.mean().backward()
        out[remat] = (img.detach(), {k: x.grad for k, x in p.items()},
                      len(calls), sorted(set(replays)))
    assert torch.equal(out[True][0], out[False][0])
    for k, g in out[False][1].items():
        torch.testing.assert_close(out[True][1][k], g, rtol=1e-5, atol=0)
    assert out[False][2:] == (0, [])
    assert out[True][2] == 0 and out[True][3]
    if estimator == "parity":
        assert out[True][3] == list(range(-1, TWO["bounces"]))


def test_default_config_renders(scenes):
    """RenderConfig()'s intersect="auto" is the list tracer on a scene
    with clusters; without clusters (and without a BVH) it is brute
    force."""
    ps = scenes[1]
    kw = dict(width=4, height=4, samples=1, bounces=1, tile_rays=None)
    with torch.no_grad():
        auto = PP.render(ps, _port_camera(), RenderConfig(**kw),
                         rng.prng_key(1))
        listed = PP.render(ps, _port_camera(),
                           RenderConfig(intersect="list", **kw),
                           rng.prng_key(1))
    assert RenderConfig().intersect == "auto"
    assert torch.isfinite(auto).all() and torch.equal(auto, listed)
    bare = dataclasses.replace(ps, clusters=None)
    with torch.no_grad():
        auto = PP.render(bare, _port_camera(), RenderConfig(**kw),
                         rng.prng_key(1))
        brute = PP.render(bare, _port_camera(),
                          RenderConfig(intersect="brute", **kw),
                          rng.prng_key(1))
    assert torch.isfinite(auto).all() and torch.equal(auto, brute)
    torch.testing.assert_close(auto, listed, rtol=1e-4, atol=1e-6)


def test_transforms_carry_a_tensor_argument_graph():
    """translation and rotation_x build their matrices with torch.stack,
    so a tensor argument keeps its graph (and its values are unchanged)."""
    z = torch.tensor(3.5, requires_grad=True)
    deg = torch.tensor(-45.0, requires_grad=True)
    m = T.compose(T.rotation_x(deg), T.translation(0.0, 1.0, z))
    assert m.requires_grad
    torch.testing.assert_close(m.detach(), T.compose(
        T.rotation_x(-45.0), T.translation(0.0, 1.0, 3.5)), rtol=0, atol=0)
    m[2, 3].backward()
    c = np.cos(np.radians(-45.0))
    torch.testing.assert_close(z.grad, torch.tensor(c, dtype=torch.float32))
    assert deg.grad is not None and deg.grad != 0.0
    cam = Camera.create(45.0, T.translation(0.0, 1.0, z), "cpu")
    o, d = cam.generate_rays(torch.tensor([1.0]), torch.tensor([2.0]), 4, 4)
    assert o.requires_grad and d.requires_grad


def test_scene_helpers_match_jax(scenes):
    """Materials.lookup gathers what the JAX package's does, and
    Scene.with_env_map's sampler of a torch sky keeps the sky in the graph
    while its tables equal build_sampler's bit for bit (the forward tests
    hold those against the JAX package's)."""
    js, ps = scenes
    idx = np.array([[0, 3], [2, 1]], np.int32)
    for j, p in zip(js.materials.lookup(jnp.asarray(idx)),
                    ps.materials.lookup(torch.as_tensor(idx))):
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    sky = ps.env_map.image.clone().requires_grad_()
    env = ps.with_env_map(sky * 2.0).env_map
    want = penv.build_sampler(sky.detach().numpy() * 2.0, "cpu")
    assert env.image.grad_fn is not None
    for f in penv.EnvMapSampler._fields[1:]:
        assert torch.equal(getattr(env, f), getattr(want, f)), f


# ---- on a card ----

@pytest.fixture(scope="module")
def tile_grads(card):
    """d mean / d materials.diffuse of the main path's tile on the card
    by three routes, {route: (radiance, grad, forward and backward
    launches)}; "no grad", the launches of the same tile's forward under
    no_grad; and "fd", the central difference in diffuse[2, 0]."""
    scene, cam, px, py, key = main_tile(card)
    mats = scene.materials

    def tile(diffuse, **kw):
        s = scene.with_materials(dataclasses.replace(mats, diffuse=diffuse))
        return PP.render_rays(s, cam, px, py, W, H, key, 1, BOUNCES,
                              estimator="shared", **kw)

    def grads(**kw):
        d = mats.diffuse.detach().clone().requires_grad_()
        PL.reset_launch_counts()
        rad = tile(d, **kw)
        fwd = dict(PL.LAUNCHES)
        rad.mean().backward()
        bwd = {k: n - fwd[k] for k, n in PL.LAUNCHES.items()}
        return rad.detach(), d.grad, fwd, bwd

    def mean_at(delta):
        d = mats.diffuse.clone()
        d[2, 0] += delta
        with torch.no_grad():
            return float(tile(d).double().mean())

    out = {"kernels": grads(), "no remat": grads(remat=False),
           "plain": grads(impl="plain")}
    PL.reset_launch_counts()
    with torch.no_grad():
        tile(mats.diffuse)
    out["no grad"] = dict(PL.LAUNCHES)
    out["fd"] = (mean_at(1e-2) - mean_at(-1e-2)) / 2e-2
    return out


@pytest.mark.card
def test_backward_launches_no_list_kernel_on_the_card(tile_grads):
    """The forward launches both list kernels, as often as the same
    tile's forward under no_grad (no pass falls back to the plain twins);
    the backward, remat's replay included, launches none: it reuses the
    recorded answers."""
    _rad, g, fwd, bwd = tile_grads["kernels"]
    assert min(fwd.values()) >= 1, fwd
    for route in ("kernels", "no remat"):
        assert tile_grads[route][2] == tile_grads["no grad"], route
    assert not any(bwd.values()), bwd
    assert not any(tile_grads["no remat"][3].values())
    assert torch.isfinite(g).all() and float(g.sum()) != 0.0


@pytest.mark.card
@pytest.mark.parametrize("route", ["no remat", "plain"])
def test_gradients_agree_on_the_card(tile_grads, route):
    """Against the kernels with remat: the same radiance bit for bit,
    gradients within GRAD_RTOL of the largest entry."""
    rad, g = tile_grads[route][:2]
    rad_k, g_k = tile_grads["kernels"][:2]
    assert torch.equal(rad, rad_k)
    assert float((g - g_k).abs().max()) <= GRAD_RTOL * float(
        g.abs().max())


@pytest.mark.card
def test_gradient_equals_central_difference_on_the_card(tile_grads):
    """d mean / d diffuse[2, 0] by AD against the central difference."""
    ad = float(tile_grads["kernels"][1][2, 0])
    fd = tile_grads["fd"]
    assert abs(ad - fd) <= 2e-3 + 0.05 * abs(fd), (ad, fd)
