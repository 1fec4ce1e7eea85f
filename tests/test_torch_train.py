"""The port's distributed inverse-rendering step and trainer against the
JAX package's: make_train_step on a 4-rank gloo group (data 2 x sample 2)
against JAX's on a 4-device mesh of the 8 virtual CPU devices, and three
steps of train.run against make_train_step + optax.adam(2e-2) as
train.py:80-105 composes them.

Tolerances: the loss within rtol 1e-5 and each gradient element within
rtol 1e-4 / atol 1e-9 (tests/test_torch_gradients.py); the trained
materials within rtol 1e-4 / atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sycl_ray_tracing_tpu.models.camera import pbrt_dragon_camera as jax_cam
from sycl_ray_tracing_tpu.parallel import mesh as JM
from sycl_ray_tracing_tpu.parallel.render import make_train_step
from sycl_ray_tracing_tpu.utils.config import RenderConfig as JaxConfig
from sycl_ray_tracing_tpu_torch import train
from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
from sycl_ray_tracing_tpu_torch.models.scene import scene_from_numpy
from sycl_ray_tracing_tpu_torch.parallel import mesh as PM
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as PL
from sycl_ray_tracing_tpu_torch.utils import metrics
from test_torch_parallel import run_ranks, small_scene  # noqa: F401
from torch_card import (  # noqa: F401
    card,
    held_launches,
    main_tile,
    one_rank_group,
)


def test_train_step_4_ranks_matches_jax(small_scene, tmp_path):
    """make_train_step on data 2 x sample 2 with the sky optimized too:
    the loss, every material gradient and the sky's gradient against the
    JAX step on a 4-device mesh, within tests/test_torch_gradients.py's
    per-element tolerance (rtol 1e-4, atol 1e-9)."""
    js, arrays = small_scene
    kw = dict(width=8, height=4, samples=4, bounces=1, intersect="brute",
              estimator="shared")
    cfg = JaxConfig(**kw)
    mesh = JM.make_mesh(4, sample_axis=2)
    step = make_train_step(js, cfg, mesh, optimize_env=True)
    ys, xs = jnp.meshgrid(jnp.arange(cfg.height, dtype=jnp.float32),
                          jnp.arange(cfg.width, dtype=jnp.float32),
                          indexing="ij")
    mats = js.materials
    guess = mats.__class__(mats.emission,
                           jnp.clip(mats.diffuse + 0.2, 0.0, 1.0),
                           mats.metalness, mats.roughness)
    sky = js.env_map.image
    loss, (g_mats, g_env) = step(guess, sky, mats, sky, jax_cam(),
                                 xs.reshape(-1), ys.reshape(-1),
                                 jax.random.PRNGKey(2))
    spec = dict(sample_axis=2, config=kw, camera="pbrt_dragon", seed=2)
    got = run_ranks("train_step", 4, tmp_path, spec, arrays)
    assert float(loss) > 0
    assert np.abs(np.asarray(g_mats.diffuse)).sum() > 0
    for g in got:
        np.testing.assert_allclose(g["loss"], float(loss), rtol=1e-5)
        for k in ("emission", "diffuse", "metalness", "roughness"):
            np.testing.assert_allclose(g[f"mat_{k}"],
                                       np.asarray(getattr(g_mats, k)),
                                       rtol=1e-4, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(g["env"], np.asarray(g_env), rtol=1e-4,
                                   atol=1e-9)


def test_train_run_matches_optax_adam(small_scene):
    """Three steps of train.run (one rank) against make_train_step +
    optax.adam(2e-2) as train.py:80-105 composes them: the same
    perturbation, keys, updates and clamps, so the materials agree
    (rtol 1e-4 / atol 1e-6: Adam's update divides by sqrt(nu) + eps,
    which amplifies the gradients' last-ulp differences)."""
    js, arrays = small_scene
    kw = dict(width=8, height=4, samples=2, bounces=1, intersect="brute",
              estimator="shared", tile_rays=None)
    steps = 3
    out = train.run(scene_from_numpy(arrays, "cpu"),
                    pbrt_dragon_camera("cpu"), RenderConfig(**kw), steps,
                    PM.make_mesh(1, 1), log=lambda *a: None)

    # train.py:54-105 on a one-device mesh
    cfg = JaxConfig(**kw)
    true_mats = js.materials
    rng = np.random.default_rng(1)
    init = dataclasses.replace(
        true_mats,
        diffuse=jnp.clip(true_mats.diffuse + jnp.asarray(
            rng.uniform(-0.25, 0.25, true_mats.diffuse.shape), jnp.float32),
            0.0, 1.0),
        roughness=jnp.clip(true_mats.roughness + jnp.asarray(
            rng.uniform(-0.2, 0.2, true_mats.roughness.shape), jnp.float32),
            1e-2, 1.0),
    )
    step_fn = make_train_step(js, cfg, JM.make_mesh(1, 1),
                              optimize_env=False)
    opt = optax.adam(2e-2)
    mats = init
    opt_state = opt.init((mats.diffuse, mats.roughness))
    ys, xs = jnp.meshgrid(jnp.arange(cfg.height, dtype=jnp.float32),
                          jnp.arange(cfg.width, dtype=jnp.float32),
                          indexing="ij")
    losses = []
    for it in range(steps):
        k = jax.random.fold_in(jax.random.PRNGKey(1000), it)
        loss, (g,) = step_fn(mats, None, true_mats, None, jax_cam(),
                             xs.reshape(-1), ys.reshape(-1), k)
        updates, opt_state = opt.update((g.diffuse, g.roughness), opt_state)
        d, r = optax.apply_updates((mats.diffuse, mats.roughness), updates)
        mats = dataclasses.replace(mats, diffuse=jnp.clip(d, 0.0, 1.0),
                                   roughness=jnp.clip(r, 1e-2, 1.0))
        losses.append(float(loss))

    np.testing.assert_allclose(out["losses"], losses, rtol=1e-4)
    assert min(losses) > 0
    final = out["materials"]
    assert isinstance(final.diffuse, torch.Tensor)
    np.testing.assert_allclose(final.diffuse.numpy(),
                               np.asarray(mats.diffuse), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(final.roughness.numpy(),
                               np.asarray(mats.roughness), rtol=1e-4,
                               atol=1e-6)
    assert out["err0_d"] == pytest.approx(float(jnp.abs(
        init.diffuse - true_mats.diffuse).mean()), rel=1e-6)


@pytest.mark.card
def test_train_run_on_one_rank_of_the_card(card, monkeypatch):
    """Five steps on a one-rank NCCL group, the 200k dragon at 128x128,
    4 spp, 2 bounces: finite losses and gradients, the diffuse error
    falls; both list kernels launch, the first 8 of each their plain
    twins' bit for bit, none in a backward; three row sums a bounce and
    sample; no fused build (it runs above 2 * maxs * 64 clusters)."""
    scene, cam = main_tile(card)[:2]
    grad, in_bwd = torch.autograd.grad, []

    def counted(*args, **kw):
        before = sum(PL.LAUNCHES.values())
        out = grad(*args, **kw)
        in_bwd.append(sum(PL.LAUNCHES.values()) - before)
        return out

    monkeypatch.setattr(torch.autograd, "grad", counted)
    cfg = RenderConfig(128, 128, samples=4, bounces=2, tile_rays=None)
    PL.reset_launch_counts()
    metrics.reset_counts()
    with one_rank_group(card), held_launches(first=8) as held:
        out = train.run(scene, cam, cfg, 5, PM.make_mesh(1, 1),
                        log=lambda *a: None)
    g = torch.cat([x.flatten() for x in out["grads"]])
    assert np.isfinite(out["losses"]).all()
    assert torch.isfinite(g).all() and (g != 0).any()
    assert out["err_d"] < out["err0_d"]
    assert min(PL.LAUNCHES.values()) >= 1, PL.LAUNCHES
    for name, launches in held.items():
        assert launches and all(x["same"] for x in launches), name
    assert in_bwd == [0] * 5
    assert metrics.COUNTS.get("row_scatter.fused", 0) == 3 * 2 * 4 * 5
    maxs = max(PL.HIER_MAXS, PL.DEFAULT_MAXC_SHARE // 3)
    assert scene.clusters.num_clusters <= 2 * maxs * PL.S_CLUSTER
    assert metrics.COUNTS.get("cand_build.fused", 0) == 0
    assert metrics.COUNTS.get("cand_build.plain", 0) >= 1
