"""The check that decides ``correct``, on the CPU at the tests' size with
the program's plain kernels: the reference agrees with the port, the
bfloat16 control fails, and a run whose timed path is broken underneath
comes out not correct, once for each fault a cell can have (a state left
unchanged, half of the batch left out, an answer altered where it is
produced; no cell spans chips, so no exchange can be left out)."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import check
from benchmark import inputs as bench_inputs
from benchmark import loops, manifest, run
from benchmark.reference import pathtrace, rng

from conftest import REPO, tiny_config

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345


def _cell(name, **over):
    spec = manifest.load()
    cell = manifest.cell(spec, name)
    cfg = tiny_config(bench_inputs.load_config(cell["config"]))
    cfg.update(over)
    return cfg, manifest.traffic(cell["traffic"])


@pytest.mark.parametrize("size", [
    {}, {"width": 128, "height": 128, "tile_rays": 8192, "bounces": 3}],
    ids=["tiles", "compacted"])
def test_reference_equals_the_port_frame(size):
    """Tiled frames (2 tiles) and the compacted wavefront (from 8192
    rays a tile on): every pixel of every tile the same as the port's."""
    cfg, traffic = _cell("dragon870k.preview", **size)
    inputs = bench_inputs.scene_arrays(cfg)
    frames = loops.Frames(inputs, cfg, CPU)
    base = rng.key_of_seed(SEED)
    img, overflow = frames.frame(base, 3)
    assert not overflow
    ref = pathtrace.Scene(inputs, CPU)
    flat = img.reshape(-1, 3)
    n = cfg["tile_rays"]
    for t in range(-(-flat.shape[0] // n)):
        hdr = pathtrace.render_tile(ref, rng.fold_in(base, 3), t, n,
                                    cfg["width"], cfg["height"],
                                    cfg["bounces"])
        rows = min(n, flat.shape[0] - t * n)
        assert torch.equal(hdr[:rows], flat[t * n:t * n + rows])


def test_reference_follows_the_port_trainer():
    cfg, traffic = _cell("dragon870k.inverse")
    inputs = bench_inputs.scene_arrays(cfg)
    trainer = loops.Trainer(inputs, loops.program_scene(inputs, CPU), cfg,
                            traffic, SEED, CPU)
    n = traffic["reference_steps"]
    program = trainer.first_steps(n)
    for i in range(n, n + 3):
        trainer.step(i)
    window = trainer.followed(check.window_pick(SEED, n, 3))
    assert window["step"] in range(n, n + 3)
    gaps = loops.step_checks(inputs, cfg, traffic, SEED, program,
                             trainer.start_params(), window, CPU)
    assert all(v < 1e-5 for v in gaps.values()), gaps


@pytest.mark.parametrize("seed", [1, SEED])
def test_control_in_bfloat16_fails(seed):
    cfg, traffic = _cell("dragon870k.preview")
    inputs = bench_inputs.scene_arrays(cfg)
    frames = loops.Frames(inputs, cfg, CPU)
    images = [frames.frame(rng.key_of_seed(seed), i)[0] for i in range(2)]
    ok = loops.frame_checks(inputs, cfg, traffic, seed, images, CPU)
    bad = loops.frame_checks(inputs, cfg, traffic, seed, images, CPU,
                             torch.bfloat16)
    limit = traffic["limits"]["pixels_off"]
    assert ok <= limit < bad

    cfg, traffic = _cell("dragon870k.inverse")
    inputs = bench_inputs.scene_arrays(cfg)
    trainer = loops.Trainer(inputs, loops.program_scene(inputs, CPU), cfg,
                            traffic, seed, CPU)
    n = traffic["reference_steps"]
    program = trainer.first_steps(n)
    trainer.step(n)
    start = trainer.start_params()
    gaps = loops.step_checks(inputs, cfg, traffic, seed, program, start,
                             trainer.followed(n), CPU, torch.bfloat16)
    assert any(v > traffic["limits"][k] for k, v in gaps.items()), gaps


def _run(name, tiny_root, seconds=0.3):
    return run.run_cell(json.loads((tiny_root.parent / "BENCHMARK.json")
                                   .read_text()),
                        name, SEED, seconds, False, "cpu",
                        time.perf_counter(), root=tiny_root)


def test_sound_runs_are_correct(tiny_root):
    for name in ("dragon870k.preview", "dragon870k.inverse"):
        out = _run(name, tiny_root)
        assert out["correct"], (name, out["checks"])
        assert list(out)[-1] == "checks"


def test_a_fault_only_in_the_window_fails(tiny_root, monkeypatch):
    """The gradient altered in window steps alone (the followed first
    steps are sound): the check of the window's drawn step sees it."""
    from sycl_ray_tracing_tpu_torch.parallel import render

    make = render.make_train_step
    first = _cell("dragon870k.inverse")[1]["reference_steps"]

    def late(*a, **kw):
        step = make(*a, **kw)
        calls = []

        def altered(*sa, **skw):
            loss, (g,) = step(*sa, **skw)
            calls.append(1)
            if len(calls) > first:
                g = dataclasses.replace(g, diffuse=g.diffuse * 1.5)
            return loss, (g,)
        return altered

    monkeypatch.setattr(render, "make_train_step", late)
    out = _run("dragon870k.inverse", tiny_root)
    assert not out["correct"] and out["checks"]["grad_gap"]["value"] > 0.3


def _half_frame(render):
    def half(*a, **kw):
        img, aux = render(*a, **kw)
        flat = img.reshape(-1, 3).clone()
        flat[flat.shape[0] // 2:] = 0.0
        return flat.reshape(img.shape), aux
    return half


def _altered_trace(trace, with_grad_only=False):
    """Radiance of one ray in 5 off by 10% as the estimator makes it (in
    the trainer, only in the guess's render, which records a graph)."""
    def altered(*a, **kw):
        rad, aux = trace(*a, **kw)
        if with_grad_only and not torch.is_grad_enabled():
            return rad, aux
        rad = rad.clone()
        rad[: max(1, rad.shape[0] // 5)] *= 1.1
        return rad, aux
    return altered


def test_frame_faults_fail(tiny_root, monkeypatch):
    from sycl_ray_tracing_tpu_torch.models import pathtracer

    with monkeypatch.context() as m:
        m.setattr(pathtracer, "render", _half_frame(pathtracer.render))
        assert not _run("dragon870k.preview", tiny_root)["correct"]
    with monkeypatch.context() as m:
        m.setattr(pathtracer, "trace_shared",
                  _altered_trace(pathtracer.trace_shared))
        assert not _run("dragon870k.preview", tiny_root)["correct"]


def test_trainer_faults_fail(tiny_root, monkeypatch):
    from sycl_ray_tracing_tpu_torch.models import pathtracer
    from sycl_ray_tracing_tpu_torch.parallel import render

    with monkeypatch.context() as m:
        # the optimizer's step returns its state unchanged
        m.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
        out = _run("dragon870k.inverse", tiny_root)
        assert not out["correct"] and out["checks"]["change_gap"][
            "value"] == pytest.approx(1.0)
    with monkeypatch.context() as m:
        # half of the pixels left out, the loss the mean over the rest
        shard = render._shard_render

        def half(materials, env, camera, scene, px, py, *a):
            n = px.shape[0] // 2
            return shard(materials, env, camera, scene, px[:n], py[:n], *a)

        m.setattr(render, "_shard_render", half)
        assert not _run("dragon870k.inverse", tiny_root)["correct"]
    with monkeypatch.context() as m:
        m.setattr(pathtracer, "trace_shared",
                  _altered_trace(pathtracer.trace_shared, True))
        assert not _run("dragon870k.inverse", tiny_root)["correct"]


def test_no_jax_in_a_run(tiny_root):
    """A whole run in a fresh process loads no module whose top-level
    name is jax, jaxlib, flax or sycl_ray_tracing_tpu."""
    code = (
        "import json, pathlib, sys, time;"
        "from benchmark import run, manifest;"
        "run.run_cell(manifest.load(), 'dragon870k.preview', 1, 0.1, False,"
        " 'cpu', time.perf_counter(), root=pathlib.Path(sys.argv[1]));"
        "print(json.dumps(run.forbidden_modules()))")
    res = subprocess.run([sys.executable, "-c", code, str(tiny_root)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sycl_ray_tracing_tpu_torch_x", sys)
    assert "sycl_ray_tracing_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sycl_ray_tracing_tpu.models", sys)
    assert "sycl_ray_tracing_tpu" in run.forbidden_modules()


def test_a_ray_through_a_shared_edge_is_a_tie():
    """Both triangles of a shared edge are exact answers; the tree returns
    either by its rule and counts the tie."""
    from benchmark.reference.geometry import BIG_T, Tree

    tris = torch.tensor([[[0.0, 0, 0], [1, 0, 0], [0, 1, 0]],
                         [[1.0, 0, 0], [1, 1, 0], [0, 1, 0]],
                         [[5.0, 5, 0], [6, 5, 0], [5, 6, 0]]])
    tree = Tree(tris)
    o = torch.tensor([[0.5, 0.5, 1.0], [0.25, 0.25, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    tl = torch.full((2,), BIG_T)
    live = torch.ones(2, dtype=torch.bool)
    assert tree.query(o, d, tl, live, False).tolist() == [0, 0]
    assert tree.ties == 1
    tree.tie_high, tree.ties = True, 0
    assert tree.query(o, d, tl, live, False).tolist() == [1, 0]
    assert tree.ties == 1
    assert tree.query(o, d, torch.full((2,), 0.5), live, True).tolist() == [
        False, False]
