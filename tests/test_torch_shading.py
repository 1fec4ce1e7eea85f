"""The port's elementwise shading modules and camera against the JAX
package, on the same numpy inputs: rtol 1e-5 / atol 1e-6 (float32 ops in
another order or library); env-map texel indices identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sycl_ray_tracing_tpu.models import camera as jcam
from sycl_ray_tracing_tpu.ops import brdf as jbrdf
from sycl_ray_tracing_tpu.ops import envmap as jenv
from sycl_ray_tracing_tpu.ops import intersect as jint
from sycl_ray_tracing_tpu.ops import safe_math as jsm
from sycl_ray_tracing_tpu.ops import sampling as jsamp
from sycl_ray_tracing_tpu.ops import tonemap as jtm
from sycl_ray_tracing_tpu.utils.procedural import procedural_sky
from sycl_ray_tracing_tpu_torch.models import camera as pcam
from sycl_ray_tracing_tpu_torch.ops import brdf as pbrdf
from sycl_ray_tracing_tpu_torch.ops import envmap as penv
from sycl_ray_tracing_tpu_torch.ops import intersect as pint
from sycl_ray_tracing_tpu_torch.ops import safe_math as psm
from sycl_ray_tracing_tpu_torch.ops import sampling as psamp
from sycl_ray_tracing_tpu_torch.ops import tonemap as ptm

RTOL, ATOL = 1e-5, 1e-6
N = 512


def _close(j, p, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=rtol, atol=atol)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    n = _unit(rng, N)
    view = _unit(rng, N)
    view = np.where((view * n).sum(-1, keepdims=True) < 0, -view, view)
    return dict(
        normal=n, view=view, light=_unit(rng, N),
        diffuse=rng.uniform(0, 1, (N, 3)).astype(np.float32),
        metal=rng.uniform(0, 1, N).astype(np.float32),
        rough=rng.uniform(0.2, 1, N).astype(np.float32),
        u1=rng.uniform(0, 1, N).astype(np.float32),
        u2=rng.uniform(0, 1, N).astype(np.float32),
        tris=rng.uniform(-1, 1, (N, 3, 3)).astype(np.float32),
        pdf_a=rng.uniform(0, 2, N).astype(np.float32),
        pdf_b=rng.uniform(0, 2, N).astype(np.float32),
    )


def _both(inputs, *names):
    return ([jnp.asarray(inputs[k]) for k in names],
            [torch.tensor(inputs[k]) for k in names])


def test_safe_math(inputs):
    (jv, jn), (pv, pn) = _both(inputs, "view", "normal")
    _close(jsm.dot(jv, jn), psm.dot(pv, pn))
    _close(jsm.cross(jv, jn), psm.cross(pv, pn))
    _close(jsm.normalize(jv * 3.0), psm.normalize(pv * 3.0))
    _close(jsm.reflect(jv, jn), psm.reflect(pv, pn))
    _close(jsm.luminance(jv), psm.luminance(pv))
    _close(jsm.safe_asin(jv[:, 1]), psm.safe_asin(pv[:, 1]))
    _close(jsm.safe_acos(jv[:, 2]), psm.safe_acos(pv[:, 2]))
    _close(jsm.safe_div(jv, jn - 0.5), psm.safe_div(pv, pn - 0.5))
    _close(jsm.where3(jv[:, 0] > 0, jv, jn), psm.where3(pv[:, 0] > 0, pv, pn))


def test_sampling(inputs):
    (jn, jl, ju1, ju2, jt, ja, jb), (pn, pl, pu1, pu2, ptr, pa, pb) = _both(
        inputs, "normal", "light", "u1", "u2", "tris", "pdf_a", "pdf_b")
    for j, p in zip(jsamp.branchless_onb(jn), psamp.branchless_onb(pn)):
        _close(j, p)
    _close(jsamp.to_world(jn, jl), psamp.to_world(pn, pl))
    _close(jsamp.power_heuristic(ja, jb), psamp.power_heuristic(pa, pb))
    for j, p in zip(
        jsamp.sample_triangle_uniform(jt[:, 0], jt[:, 1], jt[:, 2], ju1, ju2),
        psamp.sample_triangle_uniform(ptr[:, 0], ptr[:, 1], ptr[:, 2], pu1,
                                      pu2),
    ):
        _close(j, p)
    _close(jsamp.triangle_area(jt), psamp.triangle_area(ptr))


def test_brdf_eval_and_pdf(inputs):
    names = ("diffuse", "metal", "rough", "light", "view", "normal")
    j, p = _both(inputs, *names)
    _close(jbrdf.cook_torrance_eval(*j), pbrdf.cook_torrance_eval(*p))
    _close(jbrdf.cook_torrance_pdf(j[2], j[4], j[3], j[5]),
           pbrdf.cook_torrance_pdf(p[2], p[4], p[3], p[5]))


@pytest.mark.parametrize("reference_bug", [False, True])
def test_ggx_importance_sample(inputs, reference_bug):
    names = ("diffuse", "metal", "rough", "view", "normal", "u1", "u2")
    j, p = _both(inputs, *names)
    out_j = jbrdf.ggx_importance_sample(*j, reference_bug=reference_bug)
    out_p = pbrdf.ggx_importance_sample(*p, reference_bug=reference_bug)
    # roughness >= 0.2 in the inputs: below it the NDF's 1/b^2 amplifies
    # the ulp differences of the two libraries' sin/cos past rtol 1e-5
    for a, b in zip(out_j, out_p):
        _close(a, b)


@pytest.fixture(scope="module")
def sky():
    img = procedural_sky(16, 32)
    img[3:5, 20:22] = 40.0  # a second hot spot so rows differ
    return img


def test_envmap_tables_identical(sky):
    js = jenv.build_sampler(sky)
    ps = penv.build_sampler(sky, "cpu")
    for f in jenv.EnvMapSampler._fields:
        np.testing.assert_array_equal(getattr(ps, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


def test_envmap_sample_texels_identical(sky, inputs):
    js = jenv.build_sampler(sky)
    ps = penv.build_sampler(sky, "cpu")
    (ju1, ju2), (pu1, pu2) = _both(inputs, "u1", "u2")
    dj, rj, pdfj, sj = jenv.sample(js, ju1, ju2)
    dp, rp, pdfp, sp = penv.sample(ps, pu1, pu2)
    # identical texels: the radiance rows are gathered, so equal texels
    # give bit-equal radiance
    np.testing.assert_array_equal(rp.numpy(), np.asarray(rj))
    _close(dj, dp)
    _close(pdfj, pdfp)
    _close(sj, sp)


def test_envmap_direction_lookups(sky, inputs):
    js = jenv.build_sampler(sky)
    ps = penv.build_sampler(sky, "cpu")
    (jd,), (pd,) = _both(inputs, "light")
    xj, yj = jenv.texel_coords_of_direction(sky.shape[:2], jd)
    xp, yp = penv.texel_coords_of_direction(sky.shape[:2], pd)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yp.numpy(), np.asarray(yj))
    np.testing.assert_array_equal(
        penv.eval_direction(ps.image, pd).numpy(),
        np.asarray(jenv.eval_direction(js.image, jd)))
    _close(jenv.pdf_of_direction(js, jd), penv.pdf_of_direction(ps, pd))


@pytest.mark.parametrize("name", sorted(pcam.PRESETS))
def test_camera_presets_generate_rays(name):
    rng = np.random.default_rng(3)
    px = rng.uniform(0, 64, 300).astype(np.float32)
    py = rng.uniform(0, 48, 300).astype(np.float32)
    cj = jcam.PRESETS[name]()
    cp = pcam.PRESETS[name]("cpu")
    _close(cj.view_matrix, cp.view_matrix)
    oj, dj = cj.generate_rays(jnp.asarray(px), jnp.asarray(py), 64, 48)
    op, dp = cp.generate_rays(torch.tensor(px), torch.tensor(py), 64, 48)
    _close(oj, op)
    _close(dj, dp)


def test_finalize_hit_and_oracle():
    """Hit records, including the miss conventions (prim clipped to 0,
    point = origin), and the brute-force oracle."""
    rng = np.random.default_rng(5)
    tris = rng.uniform(-1, 1, (200, 3, 3)).astype(np.float32)
    o = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    d = _unit(rng, 256)
    hj = jint.intersect_triangles(jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(tris))
    hp = pint.intersect_triangles(torch.tensor(o), torch.tensor(d),
                                  torch.tensor(tris))
    m = np.asarray(hj.hit)
    assert 0 < m.sum() < m.size
    np.testing.assert_array_equal(hp.hit.numpy(), m)
    np.testing.assert_array_equal(hp.prim.numpy(), np.asarray(hj.prim))
    assert (hp.prim.numpy()[~m] == 0).all()
    np.testing.assert_array_equal(hp.point.numpy()[~m], o[~m])
    for f in ("t", "point", "normal", "uv"):
        _close(np.asarray(getattr(hj, f))[m], getattr(hp, f)[torch.tensor(m)])
    # a known-miss prim of -1 goes through finalize_hit as a clean miss
    prim = np.where(m, np.asarray(hj.prim), -1).astype(np.int32)
    fj = jint.finalize_hit(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tris),
                           jnp.asarray(prim))
    fp = pint.finalize_hit(torch.tensor(o), torch.tensor(d),
                           torch.tensor(tris), torch.tensor(prim))
    np.testing.assert_array_equal(fp.hit.numpy(), np.asarray(fj.hit))
    np.testing.assert_array_equal(fp.prim.numpy(), np.asarray(fj.prim))
    _close(fj.t, fp.t)
    _close(fj.normal, fp.normal)


def test_tonemap():
    rng = np.random.default_rng(2)
    hdr = rng.uniform(-0.5, 20.0, (64, 3)).astype(np.float32)
    _close(jtm.tonemap(jnp.asarray(hdr)), ptm.tonemap(torch.tensor(hdr)))
