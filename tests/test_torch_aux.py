"""The port's smaller helpers against the JAX package's on the same inputs
(made from a numpy seed): hemisphere samplers, the Lambertian term and
VNDF sampling, gamma correction, the image utilities, the transforms and
the env-map bin splitting.  They mirror tests/test_aux.py,
test_brdf.py, test_sampling.py and test_transform.py.

Tolerance: float32 elementwise results within rtol 1e-5 / atol 1e-6 (op
order and libm differ between XLA and torch); integer and structural
results (bins, texel picks) identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sycl_ray_tracing_tpu.ops import brdf as JBR
from sycl_ray_tracing_tpu.ops import envmap as JE
from sycl_ray_tracing_tpu.ops import image as JIM
from sycl_ray_tracing_tpu.ops import sampling as JS
from sycl_ray_tracing_tpu.ops import tonemap as JTM
from sycl_ray_tracing_tpu.ops import transform as JT
from sycl_ray_tracing_tpu_torch.ops import brdf as PBR
from sycl_ray_tracing_tpu_torch.ops import envmap as PE
from sycl_ray_tracing_tpu_torch.ops import image as PIM
from sycl_ray_tracing_tpu_torch.ops import sampling as PS
from sycl_ray_tracing_tpu_torch.ops import tonemap as PTM
from sycl_ray_tracing_tpu_torch.ops import transform as PT

RTOL, ATOL = 1e-5, 1e-6


def _close(p, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(j),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def frames():
    """Unit normals, unit view directions above them, and uniforms."""
    rng = np.random.default_rng(11)
    n = rng.normal(size=(4096, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    v = rng.normal(size=(4096, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v = np.where((v * n).sum(-1, keepdims=True) < 0, -v, v)
    u = rng.uniform(size=(4096, 2)).astype(np.float32)
    return n, v, u


@pytest.mark.parametrize("name", ["uniform_hemisphere", "cosine_hemisphere"])
def test_hemisphere_samplers_match_jax(frames, name):
    n, _v, u = frames
    jd, jpdf = getattr(JS, name)(jnp.asarray(n), jnp.asarray(u[:, 0]),
                                 jnp.asarray(u[:, 1]))
    pd, ppdf = getattr(PS, name)(torch.as_tensor(n), torch.as_tensor(u[:, 0]),
                                 torch.as_tensor(u[:, 1]))
    _close(pd, jd, atol=1e-5)
    _close(ppdf, jpdf)
    cos = (pd * torch.as_tensor(n)).sum(-1)
    assert float(cos.min()) >= -1e-5          # above the surface
    if name == "cosine_hemisphere":
        # pdf = cos / pi, and E[cos] = 2/3 (test_sampling.py:48-54)
        _close(ppdf, cos / np.pi, atol=1e-5)
        assert abs(float(cos.mean()) - 2.0 / 3.0) < 2e-2


def test_lambertian_and_vndf_match_jax(frames):
    n, v, u = frames
    alb = np.array([0.5, 0.25, 1.0], np.float32)
    _close(PBR.lambertian_brdf(torch.as_tensor(alb)),
           JBR.lambertian_brdf(jnp.asarray(alb)))
    rough = np.linspace(0.05, 1.0, n.shape[0]).astype(np.float32)
    jh, jpdf = JBR.ggx_vndf_sample(jnp.asarray(rough), jnp.asarray(v),
                                   jnp.asarray(n), jnp.asarray(u[:, 0]),
                                   jnp.asarray(u[:, 1]))
    ph, ppdf = PBR.ggx_vndf_sample(torch.as_tensor(rough), torch.as_tensor(v),
                                   torch.as_tensor(n),
                                   torch.as_tensor(u[:, 0]),
                                   torch.as_tensor(u[:, 1]))
    _close(ph, jh, atol=1e-5)
    # the pdf's GGX D(h) has a relative condition number ~ 1/alpha^2 near
    # noh = 1, so float32 ulps of h move it by up to 0.5% at roughness
    # 0.05 (both packages alike); 2e-4 holds from roughness 0.2 up
    smooth = rough >= 0.2
    _close(ppdf[smooth], np.asarray(jpdf)[smooth], rtol=2e-4)
    _close(ppdf, jpdf, rtol=1e-2)
    # microfacet normals are unit and above the surface (test_aux.py:137)
    np.testing.assert_allclose(ph.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    assert float((ph * torch.as_tensor(n)).sum(-1).min()) > 0.0
    assert float(ppdf.min()) > 0.0


def test_gamma_only_matches_jax():
    x = np.random.default_rng(4).uniform(-0.5, 2.0, (16, 16, 3)).astype(
        np.float32)
    _close(PTM.gamma_only(torch.as_tensor(x)), JTM.gamma_only(jnp.asarray(x)))
    _close(PTM.gamma_only(torch.as_tensor(x), 1.8),
           JTM.gamma_only(jnp.asarray(x), 1.8))


def test_image_utilities_match_jax():
    rng = np.random.default_rng(6)
    img = rng.uniform(0.0, 4.0, (12, 20, 3)).astype(np.float32)
    uv = rng.uniform(-0.1, 1.1, (500, 2)).astype(np.float32)
    ji, pi = jnp.asarray(img), torch.as_tensor(img)
    _close(PIM.luminance_of_pixel(pi, 7, 3), JIM.luminance_of_pixel(ji, 7, 3))
    _close(PIM.luminance_of_area(pi, 2, 9, 1, 7),
           JIM.luminance_of_area(ji, 2, 9, 1, 7))
    _close(PIM.sample_nearest(pi, torch.as_tensor(uv)),
           JIM.sample_nearest(ji, jnp.asarray(uv)))
    _close(PIM.sample_bilinear(pi, torch.as_tensor(uv)),
           JIM.sample_bilinear(ji, jnp.asarray(uv)), atol=1e-5)
    _close(PIM.normalize_range(pi), JIM.normalize_range(ji))
    r = PIM.normalize_range(pi)
    assert float(r.min()) == 0.0 and abs(float(r.max()) - 1.0) < 1e-6


def test_transforms_match_jax():
    """Every transform the JAX package has, entry for entry, and the
    reference checks of test_transform.py:60-95 on the port's."""
    cases = [
        ("rotation_y", (33.0,)), ("rotation_z", (-71.5,)),
        ("rotation_axis", ([1.0, 2.0, -0.5], 40.0)),
        ("lookat", ([0.0, 1.0, 5.0], [0.5, 0.0, 0.0], [0.0, 1.0, 0.0])),
        ("scale", (2.0,)), ("scale", (1.0, 2.0, 3.0)),
        ("perspective", (90.0, 1.5, 1.0, 10.0)),
        ("orthographic", (-2.0, 2.0, -1.0, 1.0, 0.0, 10.0)),
        ("viewport", (640.0, 480.0)),
    ]
    for name, args in cases:
        _close(getattr(PT, name)(*args), getattr(JT, name)(*args),
               atol=1e-6)
    m = PT.compose(PT.rotation_x(33.0), PT.translation(1.0, 2.0, 3.0))
    jm = JT.compose(JT.rotation_x(33.0), JT.translation(1.0, 2.0, 3.0))
    _close(PT.inverse(m), JT.inverse(jm), atol=1e-6)
    p = torch.tensor([[0.3, -0.7, 2.0]])
    _close(PT.apply_point(PT.inverse(m), PT.apply_point(m, p)), p, atol=1e-5)
    v = np.random.default_rng(8).normal(size=(5, 3)).astype(np.float32)
    _close(PT.apply_vector(m, torch.as_tensor(v)),
           JT.apply_vector(jm, jnp.asarray(v)))
    look = PT.lookat([0.0, 0.0, 5.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])
    np.testing.assert_allclose(-look[:3, 2].numpy(), [0.0, 0.0, -1.0],
                               atol=1e-6)
    persp = PT.perspective(90.0, 1.0, 1.0, 10.0)
    for z, want in ((-1.0, -1.0), (-10.0, 1.0)):
        got = PT.apply_point(persp, torch.tensor([[0.0, 0.0, z]]))[0, 2]
        assert abs(float(got) - want) < 1e-5


def test_transforms_keep_a_tensor_argument_graph():
    """rotation_y/z, rotation_axis, lookat and scale stack their entries,
    so a tensor argument's gradient flows, as jax.grad's does."""
    def jf(a):
        return jnp.sum(JT.compose(
            JT.rotation_axis(jnp.stack([1.0, a, 0.5]), 30.0 * a),
            JT.compose(JT.rotation_y(a * 10.0), JT.rotation_z(a * 5.0)))
            @ JT.lookat(jnp.stack([0.0, a, 5.0]), [0.0, 0.0, 0.0],
                        [0.0, 1.0, 0.0])) + jnp.sum(JT.scale(a))

    a = torch.tensor(0.7, requires_grad=True)
    out = (PT.compose(
        PT.rotation_axis(torch.stack([torch.tensor(1.0), a,
                                      torch.tensor(0.5)]), 30.0 * a),
        PT.compose(PT.rotation_y(a * 10.0), PT.rotation_z(a * 5.0)))
        @ PT.lookat(torch.stack([torch.tensor(0.0), a, torch.tensor(5.0)]),
                    [0.0, 0.0, 0.0], [0.0, 1.0, 0.0])).sum() \
        + PT.scale(a).sum()
    out.backward()
    jv, jg = jax.value_and_grad(jf)(jnp.float32(0.7))
    np.testing.assert_allclose(float(out.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(float(a.grad), float(jg), rtol=1e-4)


def test_importance_split_matches_jax():
    """The same bins in the same order, and they tile the image; the sun
    gets smaller bins than the average (test_aux.py:150-167)."""
    h, w = 32, 64
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    sky = np.stack([0.3 + 0.2 * np.sin(x / w * 2 * np.pi),
                    0.4 + 0.3 * (y / h),
                    0.6 + 0.1 * np.cos(x / w * 4 * np.pi)],
                   axis=-1).astype(np.float32)
    sky[8:11, 20:24] = 50.0
    for area, rad in ((16, 50.0), (4, 5.0)):
        bins = PE.importance_split(torch.as_tensor(sky), area, rad)
        assert bins == JE.importance_split(sky, area, rad)
        assert sum((x1 - x0) * (y1 - y0) for x0, x1, y0, y1 in bins) == h * w
    sun = [b for b in bins if b[0] <= 21 < b[1] and b[2] <= 9 < b[3]]
    assert (sun[0][1] - sun[0][0]) * (sun[0][3] - sun[0][2]) < h * w / len(
        bins)
