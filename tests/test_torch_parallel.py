"""The port's parallel package against the JAX package's: the mesh
helpers, render_sharded on a 4-rank (data 2 x sample 2) gloo group
against JAX's render_sharded on a 4-device mesh of the 8 virtual CPU
devices, and the 8-rank list-tracer frame of __graft_entry__.py:102-125
(data 2 x sample 4) against the mean MULTICHIP_r05.json recorded.

Each rank is a subprocess (tests/torch_distributed_worker.py) with its own
time limit and a free port, so a hang fails one test, not the suite.

Tolerances: render_sharded per pixel within rtol 1e-4 / atol 1e-6
(tests/test_torch_parity.py's per-pixel tolerance; the same samples on
the same mesh cells); the 8-rank frame's mean equal to the recorded
0.24613 to its five printed digits.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from sycl_ray_tracing_tpu.models.camera import pbrt_dragon_camera as jax_cam
from sycl_ray_tracing_tpu.parallel import mesh as JM
from sycl_ray_tracing_tpu.parallel.render import render_sharded as jax_sharded
from sycl_ray_tracing_tpu.utils.config import RenderConfig as JaxConfig
from sycl_ray_tracing_tpu.utils.procedural import dragon_scene as jax_dragon
from sycl_ray_tracing_tpu_torch.parallel import mesh as PM
from tests.test_torch_cluster import jax_scene_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_distributed_worker.py")
RANK_TIMEOUT = 240      # seconds each rank may take


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(task: str, world: int, out, spec: dict, scene=None) -> list:
    """Run ``task`` on ``world`` gloo ranks; returns each rank's saved
    arrays."""
    with open(os.path.join(out, "task.json"), "w") as f:
        json.dump(spec, f)
    if scene is not None:
        np.savez(os.path.join(out, "scene.npz"), **scene)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, WORKER, task, str(r), str(world), port, str(out)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-3000:]}"
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(world)]


def test_mesh_helpers_match_jax():
    for n in (1, 2, 3, 4, 6, 8, 16):
        for spp in (1, 2, 3, 4, 8, 12, 16, 64):
            assert PM.best_sample_axis(n, spp) == JM.best_sample_axis(n, spp)
    for n in (1, 7, 64, 65, 1000):
        for m in (1, 2, 3, 8):
            assert PM.pad_to_multiple(n, m) == JM.pad_to_multiple(n, m)
    one = PM.make_mesh(1, 1)
    assert one.shape == {"data": 1, "sample": 1}
    assert one.sample_group is None and one.data_group is None
    with pytest.raises(ValueError):
        PM.make_mesh(4, 2)          # no process group: a world of one


@pytest.fixture(scope="module")
def small_scene():
    js = jax_dragon(n_tris=2_000, with_sky=True, sky_res=(16, 32),
                    build_accel=False)
    return js, jax_scene_arrays(js)


def test_render_sharded_4_ranks_matches_jax(small_scene, tmp_path):
    js, arrays = small_scene
    kw = dict(width=8, height=6, samples=4, bounces=2, intersect="brute",
              estimator="shared")
    mesh = JM.make_mesh(4, sample_axis=2)
    want = np.asarray(jax_sharded(js, jax_cam(), JaxConfig(**kw),
                                  jax.random.PRNGKey(9), mesh))
    spec = dict(sample_axis=2, config=kw, camera="pbrt_dragon", seed=9)
    got = run_ranks("render_sharded", 4, tmp_path, spec, arrays)
    for r, g in enumerate(got):
        # rank r sits where JAX's mesh puts device r
        d, s = np.argwhere(np.vectorize(lambda x: x.id)(mesh.devices)
                           == jax.devices()[r].id)[0]
        assert g["coords"].tolist() == [d, s]
        np.testing.assert_array_equal(g["image"], got[0]["image"])
    assert want.shape == (6, 8, 3) and want.mean() > 1e-3
    np.testing.assert_allclose(got[0]["image"], want, rtol=1e-4, atol=1e-6)


def test_render_sharded_8_ranks_list_frame(tmp_path):
    """__graft_entry__.dryrun_multichip(8)'s list frame: dragon_scene(2000)
    with a 16x32 sky, 8x8, 4 spp, 2 bounces, list tracer, shared
    estimator, key 0, on data 2 x sample 4 (best_sample_axis(8, 4))."""
    with open(os.path.join(REPO, "MULTICHIP_r05.json")) as f:
        tail = json.load(f)["tail"]
    recorded = tail.split("list_mean=")[1].split()[0]
    assert recorded == "0.24613"
    assert PM.best_sample_axis(8, 4) == 4
    kw = dict(width=8, height=8, samples=4, bounces=2, intersect="list",
              estimator="shared")
    spec = dict(sample_axis=4, config=kw, camera="pbrt_dragon", seed=0,
                dragon=2_000, sky_res=[16, 32])
    got = run_ranks("render_sharded", 8, tmp_path, spec)
    assert [g["coords"].tolist() for g in got] == [
        [r // 4, r % 4] for r in range(8)]
    img = got[0]["image"]
    for g in got[1:]:
        np.testing.assert_array_equal(g["image"], img)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert f"{float(img.mean()):.5f}" == recorded

