"""The port's benchmark entry point (sycl_ray_tracing_tpu_torch/bench.py)
at its --small size on the CPU: the lines it prints, its exit codes, what
it imports and writes, a failing section, the Cornell sections, and its
section 1 frame and section 2 gradient against the JAX package's.

Tolerances: the frame per pixel within rtol 1e-4 / atol 1e-6 and the
diffuse gradient within rtol 1e-4 / atol 1e-9 at 1 bounce
(tests/test_torch_pathtracer.py, tests/test_torch_gradients.py): the same
samples; only float32 op order differs.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sycl_ray_tracing_tpu.models import pathtracer as JP
from sycl_ray_tracing_tpu.models.camera import (
    pbrt_dragon_camera as jax_dragon_camera,
)
from sycl_ray_tracing_tpu.utils.config import RenderConfig as JaxConfig
from sycl_ray_tracing_tpu.utils.procedural import dragon_scene as jax_dragon
from sycl_ray_tracing_tpu_torch import bench
from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
from sycl_ray_tracing_tpu_torch.ops.rng import prng_key
from sycl_ray_tracing_tpu_torch.utils.procedural import (
    cornell_standin,
    write_standin,
)
from test_torch_examples import (  # noqa: F401 (a fixture)
    assert_same_config,
    assert_same_scene,
    jax_frame,
    same_clusters,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK = ["--device", "cpu", "--small", "--repeats", "1", "--steady", "2"]
SECTION_NAMES = ["dragon_fwd", "dragon_fwd_bwd", "dragon870k_fwd",
                 "cornell_fwd", "weak_scaling"]
# the JAX bench's "extra" keys (bench.py:167-316) without its TPU ratio
JAX_EXTRA_KEYS = {"cluster_order", "dragon_overflow", "dragon_fwd_mrays",
                  "dragon_fwd_ms", "dragon_fwd_mrays_steady",
                  "dragon_fwd_bwd_mrays", "dragon_fwd_bwd_ms",
                  "dragon870k_overflow", "dragon870k_fwd_mrays",
                  "dragon870k_fwd_ms", "cornell_fwd_mrays",
                  "weak_scaling_proxy_cpu8"}


@pytest.fixture
def cornell_obj(tmp_path):
    """A small Cornell box (36 triangles) written as OBJ + MTL."""
    path = str(tmp_path / "cornell.obj")
    write_standin(path, cornell_standin())
    return path


def run_bench(argv, capsys):
    """bench.main(argv) in this process: (exit code, its JSON lines)."""
    capsys.readouterr()
    rc = bench.main(argv)
    return rc, [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


def test_sections_in_order_then_the_last_line(cornell_obj, capsys):
    rc, lines = run_bench(QUICK + ["--cornell", cornell_obj,
                                   "--weak-ranks", "2"], capsys)
    assert rc == 0
    assert [ln.get("section") for ln in lines] == SECTION_NAMES + [None]
    for ln in lines[:-1]:
        assert ln["ok"] is True and "error" not in ln, ln
        assert ln["device"] == {"name": "cpu", "power_limit_w": None,
                                "count": 0}
    for ln in lines[:4]:
        assert len(ln["times_s"]) == 1 and ln["build_s"] > 0
        # counters count CUDA launches only: none on the CPU
        assert ln["launches"] == {"block_tiles": 0, "list_tiles": 0}
    assert lines[0]["dragon_overflow"] is lines[2]["dragon870k_overflow"] \
        is False
    assert lines[2]["clusters"] <= bench.listtrace.MAX_CLUSTERS
    last = lines[-1]
    assert set(last) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert last["vs_baseline"] is None and last["unit"] == "Mrays/s"
    # section 5's key names its 2 ranks (the JAX name is for 8)
    assert set(last["extra"]) == (JAX_EXTRA_KEYS
                                  - {"weak_scaling_proxy_cpu8"}
                                  | {"weak_scaling_proxy_cpu2", "device"})
    assert last["extra"]["cluster_order"] == "sah"
    assert last["value"] == last["extra"]["dragon_fwd_mrays_steady"]
    run = bench.Run(bench._parse(["--weak-ranks", "2"]), None, bench.SMALL)
    for section in lines[:-1]:
        for k in bench.result_keys(run, section["section"]):
            assert last["extra"][k] == section[k]


def test_cornell_and_weak_scaling_give_finite_numbers(cornell_obj, capsys):
    rc, lines = run_bench(QUICK + ["--sections", "4,5", "--cornell",
                                   cornell_obj, "--weak-ranks", "2"], capsys)
    assert rc == 1       # dragon_fwd_mrays was not measured
    cornell, weak, last = lines
    assert cornell["ok"] and weak["ok"]
    assert math.isfinite(cornell["cornell_fwd_mrays"]) \
        and cornell["cornell_fwd_mrays"] > 0
    assert math.isfinite(weak["weak_scaling_proxy_cpu2"]) \
        and weak["weak_scaling_proxy_cpu2"] > 0
    assert weak["world"] == 2 and weak["threads_per_rank"] == 1
    assert len(weak["times_s"]) == len(weak["times_s_one_rank"]) == 1
    assert last["value"] == 0.0 and "errors" not in last["extra"]


def test_ranks_past_the_time_limit_are_an_error(cornell_obj, monkeypatch,
                                                 capsys):
    """Section 5's ranks are killed at its time limit; the section records
    the timeout as its error."""
    monkeypatch.setattr(bench, "WEAK_TIMEOUT", 0)
    rc, lines = run_bench(QUICK + ["--sections", "5", "--cornell",
                                   cornell_obj, "--weak-ranks", "2"], capsys)
    weak, last = lines
    assert weak["ok"] is False and "TimeoutExpired" in weak["error"]
    assert set(last["extra"]["errors"]) == {"weak_scaling"}


@pytest.mark.parametrize("ranks", [None, 3], ids=["default", "three"])
def test_weak_scaling_key_names_its_ranks(cornell_obj, monkeypatch, capsys,
                                          ranks):
    """Section 5's result is n * t1 / tn under weak_scaling_proxy_cpu<n>:
    the JAX bench's weak_scaling_proxy_cpu8 only at its 8 ranks (the
    default), another key at any other count.  The ranks' times are
    stubbed: no process starts."""
    times = {1: [2.0, 4.0], 8: [5.0, 7.0], 3: [3.0, 5.0]}
    worlds = []

    def rank_times(world, obj, run, deadline):
        worlds.append(world)
        return times[world]

    monkeypatch.setattr(bench, "_rank_times", rank_times)
    argv = QUICK + ["--sections", "5", "--cornell", cornell_obj]
    n = 8 if ranks is None else ranks
    if ranks is not None:
        argv += ["--weak-ranks", str(ranks)]
    rc, (weak, last) = run_bench(argv, capsys)
    assert rc == 1       # dragon_fwd_mrays was not measured
    assert worlds == [1, n]
    key = f"weak_scaling_proxy_cpu{n}"
    want = n * 3.0 / (sum(times[n]) / 2)
    assert weak["ok"] and weak[key] == want and last["extra"][key] == want
    assert weak["world"] == n and weak["threads_per_rank"] == 1
    assert weak["times_s_one_rank"] == times[1] and weak["times_s"] == times[n]
    assert (key == "weak_scaling_proxy_cpu8") is (ranks is None)
    assert set(last["extra"]) == {"cluster_order", key, "device"}


def test_missing_cornell_obj_fails_only_the_sections_that_read_it(
        tmp_path, capsys):
    missing = str(tmp_path / "absent" / "cornell_pbr.obj")
    rc, lines = run_bench(QUICK + ["--sections", "3,4,5", "--cornell",
                                   missing], capsys)
    assert rc == 1
    big, cornell, weak, last = lines
    assert big["ok"] and "error" not in big
    for ln in (cornell, weak):
        assert ln["ok"] is False and "OBJ file not found" in ln["error"]
    assert set(last["extra"]["errors"]) == {"cornell_fwd", "weak_scaling"}
    assert "dragon870k_fwd_mrays" in last["extra"]


@pytest.mark.parametrize("failing, rc_want", [(1, 1), (2, 0)],
                         ids=["section1", "section2"])
def test_a_failing_section_is_an_error_and_later_sections_print(
        monkeypatch, capsys, failing, rc_want):
    name, _fn = bench.SECTIONS[failing]

    def boom(run, line):
        line["partial"] = 1
        raise ValueError("boom")

    monkeypatch.setitem(bench.SECTIONS, failing, (name, boom))
    rc, lines = run_bench(QUICK + ["--sections", "1,2,3"], capsys)
    # the exit code is 0 only if dragon_fwd_mrays was measured
    assert rc == rc_want
    assert [ln.get("section") for ln in lines] == SECTION_NAMES[:3] + [None]
    bad = lines[failing - 1]
    assert bad["ok"] is False and "boom" in bad["error"] \
        and bad["partial"] == 1
    assert all(ln["ok"] for ln in lines[:3] if ln is not bad)
    assert lines[-1]["extra"]["errors"] == {name: bad["error"]}
    assert "dragon870k_fwd_mrays" in lines[-1]["extra"]


def test_history_only_where_asked(tmp_path, capsys):
    committed = os.path.join(REPO, "bench_history.jsonl")
    with open(committed, "rb") as f:
        before = f.read()
    rc, _ = run_bench(QUICK + ["--sections", "1"], capsys)
    assert rc == 0
    with open(committed, "rb") as f:
        assert f.read() == before
    hist = tmp_path / "history.jsonl"
    rc, lines = run_bench(QUICK + ["--sections", "1", "--history",
                                   str(hist)], capsys)
    (entry,) = [json.loads(t) for t in hist.read_text().splitlines()]
    assert entry["results"] == {k: v for k, v in lines[-1]["extra"].items()
                                if k != "device"}
    with open(committed, "rb") as f:
        assert f.read() == before


def _python(code, env=None, args=()):
    env = dict(os.environ, **(env or {}))
    return subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=240)


def test_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "from sycl_ray_tracing_tpu_torch import bench\n"
        "rc = bench.main(sys.argv[1:])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sycl_ray_tracing_tpu'))\n"
        "print('IMPORTED', bad)\n"
        "sys.exit(rc)\n")
    out = _python(code, args=QUICK + ["--sections", "1,2,3"])
    assert out.returncode == 0, out.stderr[-3000:]
    assert "IMPORTED []" in out.stdout.splitlines()


def test_exits_3_without_a_card():
    """Where CUDA shows no device and --device cpu is not given, the bench
    prints no result; on a CPU-only machine as on a card's with the card
    hidden."""
    out = _python("import runpy; runpy.run_module("
                  "'sycl_ray_tracing_tpu_torch.bench', run_name='__main__')",
                  env={"CUDA_VISIBLE_DEVICES": ""}, args=["--small"])
    assert out.returncode == bench.NO_CARD, out.stderr[-3000:]
    assert "Mrays" not in out.stdout and out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr


def _one_bounce():
    size = dataclasses.replace(bench.SMALL, bounces=1)
    cfg = bench.dragon_config(size)
    jcfg = JaxConfig(width=size.width, height=size.height, samples=1,
                     bounces=1, intersect="list", tile_rays=size.tile,
                     estimator="shared")
    assert_same_config(cfg, jcfg)
    scene = bench.dragon_scene(size.tris, with_sky=True,
                               sky_res=size.sky_res, device="cpu")
    js = jax_dragon(n_tris=size.tris, with_sky=True, sky_res=size.sky_res)
    assert_same_scene(scene, js)
    return scene, cfg, js, jcfg


def test_section1_frame_matches_jax(same_clusters):  # noqa: F811
    """Section 1's frame at --small with 1 bounce, key 0 (the warm-up's),
    against the JAX package's render of the same scene and key."""
    scene, cfg, js, jcfg = _one_bounce()
    img, ovf = bench.frame(scene, pbrt_dragon_camera("cpu"), cfg,
                           prng_key(0))
    want, j_ovf = jax_frame(js, jax_dragon_camera(), jcfg)
    assert ovf is j_ovf is False
    assert want.shape == (16, 16, 3) and want.mean() > 1e-4
    np.testing.assert_allclose(img.numpy(), want, rtol=1e-4, atol=1e-6)


def test_section2_gradient_matches_jax(same_clusters):  # noqa: F811
    """Section 2's value and diffuse gradient at --small with 1 bounce
    against jax.value_and_grad of bench.py:219-226's loss."""
    scene, cfg, js, jcfg = _one_bounce()
    val, grad = bench.value_and_grad(scene, pbrt_dragon_camera("cpu"), cfg,
                                     prng_key(3))
    mats = js.materials

    def loss(diffuse, key):
        s = js.with_materials(dataclasses.replace(mats, diffuse=diffuse))
        return JP.render(s, jax_dragon_camera(), jcfg, key).mean()

    jval, jgrad = jax.jit(jax.value_and_grad(loss))(mats.diffuse,
                                                   jax.random.PRNGKey(3))
    jgrad = np.asarray(jgrad)
    assert np.abs(jgrad).sum() > 0 and torch.isfinite(grad).all()
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-4, atol=1e-9)
