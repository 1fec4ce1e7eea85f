"""The port's five BASELINE-config examples (sycl_ray_tracing_tpu_torch/
examples/) against the JAX package's examples/ at small sizes, on the
CPU.

Each image test builds the config through the port module's ``build``
(its SMALL sizes patched down) and the JAX side through the JAX
package's own APIs exactly as the JAX script builds it (the scripts
themselves set up JAX and read fixed paths at import, so they are not
imported): the scene arrays must be equal, then ``_common.run`` renders,
checks, writes and reports the port's frame in a temporary cwd, and the
JAX script's jitted render gives the other.  MIS.obj and cornell_pbr.obj
are procedural stand-ins written as OBJ + MTL (chip_smoke.mis_standin,
cornell_standin) under a temporary $SRT_REFERENCE_ROOT.  Both sides take
the port's SAH cluster order (the JAX package's needs its native library
built), so they trace the same clusters.

Backends: configs 1 and 5 have no clusters, so "auto" is brute force on
both sides.  Config 2's "auto" is the cluster pair tracer in the JAX
package on the CPU and the list tracer (plain kernels) in the port;
config 3 names the list tracer (the JAX Pallas kernel in interpret mode,
as its own tests run it); config 4's "auto" is resolved on the JAX side
as on its accelerator (the list tracer), since its pair budgets, sized
for 32768-ray tiles, would gather ~2.7 GB a query on the CPU.  Every
backend gives brute force's image (tests/test_torch_parity.py).

Tolerances: every image per pixel within rtol 1e-4 / atol 1e-6 (the
same samples; only float32 op order differs, as in
tests/test_torch_cli.py; config 2 against the JAX render run op by op,
see its test); config 4's PNG byte for byte, its HDR file
every byte within 1 (one RGBE mantissa step where a value sits on a
rounding boundary).
"""

import dataclasses
import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from chip_smoke import cornell_standin, mis_standin, write_standin
from sycl_ray_tracing_tpu.models import pathtracer as JP
from sycl_ray_tracing_tpu.models.camera import Camera as JaxCamera
from sycl_ray_tracing_tpu.models.camera import mis_camera as jax_mis_camera
from sycl_ray_tracing_tpu.models.camera import (
    pbrt_dragon_camera as jax_dragon_camera,
)
from sycl_ray_tracing_tpu.models.scene import add_sphere as jax_add_sphere
from sycl_ray_tracing_tpu.models.scene import (
    make_materials as jax_make_materials,
)
from sycl_ray_tracing_tpu.models.scene import make_scene as jax_make_scene
from sycl_ray_tracing_tpu.ops import cluster as JC
from sycl_ray_tracing_tpu.ops import transform as JT
from sycl_ray_tracing_tpu.ops.tonemap import tonemap as jax_tonemap
from sycl_ray_tracing_tpu.utils.config import RenderConfig as JaxConfig
from sycl_ray_tracing_tpu.utils.hdr import write_hdr as jax_write_hdr
from sycl_ray_tracing_tpu.utils.obj_loader import load_scene as jax_load_scene
from sycl_ray_tracing_tpu.utils.png import write_png as jax_write_png
from sycl_ray_tracing_tpu.utils.procedural import dragon_scene as jax_dragon
from sycl_ray_tracing_tpu_torch import train
from sycl_ray_tracing_tpu_torch.examples import (
    _common,
    config1_spheres_direct,
    config2_obj_bvh,
    config3_dragon_mis,
    config4_env_tonemap,
    config5_inverse_sharded,
)
from sycl_ray_tracing_tpu_torch.models import pathtracer as PP
from sycl_ray_tracing_tpu_torch.ops import cluster as PC
from sycl_ray_tracing_tpu_torch.utils.config import REFERENCE_ROOT_ENV
from tests.test_torch_cluster import jax_scene_arrays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIS_SEG = 5     # the MIS stand-in at 334 triangles


def jax_common():
    """examples/_common.py, loaded by path (it imports JAX only inside
    setup_jax)."""
    spec = importlib.util.spec_from_file_location(
        "jax_examples_common", os.path.join(REPO, "examples", "_common.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_scene_arrays(scene) -> dict:
    """The port Scene's tensors under jax_scene_arrays' names."""
    a = dict(triangles=scene.triangles,
             material_indices=scene.material_indices,
             emissive_indices=scene.emissive_indices,
             emission=scene.materials.emission,
             diffuse=scene.materials.diffuse,
             metalness=scene.materials.metalness,
             roughness=scene.materials.roughness,
             tri_areas=scene.tri_areas)
    if scene.slot_packed is not None:
        a["slot_packed"] = scene.slot_packed
    if scene.env_map is not None:
        for f in scene.env_map._fields:
            a[f"env_{f}"] = getattr(scene.env_map, f)
    if scene.num_spheres:
        for f in ("sphere_centers", "sphere_radii", "sphere_material"):
            a[f] = getattr(scene, f)
    if scene.clusters is not None:
        for f in PC.CLUSTER_FIELDS + PC.CLUSTER_STATIC:
            a[f] = getattr(scene.clusters, f)
    return {k: np.asarray(v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in a.items()}


def assert_same_scene(port_scene, jax_scene):
    """Equal arrays; the triangle areas and the sky's sampling tables
    within rtol 1e-6 (float32 sums in another order)."""
    p, j = port_scene_arrays(port_scene), jax_scene_arrays(jax_scene)
    assert sorted(p) == sorted(j)
    for k in p:
        if k == "tri_areas" or k.startswith("env_"):
            np.testing.assert_allclose(p[k], j[k], rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(p[k], j[k], err_msg=k)


def assert_same_config(port_cfg, jax_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)


def jax_frame(scene, camera, cfg, jit=True):
    """The JAX script's render, key PRNGKey(0), with its overflow flag:
    jitted as the script runs it, or op by op (``jit=False``)."""
    def frame(s, c, k):
        return JP.render(s, c, cfg, k, with_aux=True)

    if jit:
        img, aux = jax.jit(frame)(scene, camera, jax.random.PRNGKey(0))
    else:
        with jax.disable_jit():
            img, aux = frame(scene, camera, jax.random.PRNGKey(0))
    return np.asarray(img), bool(aux["overflow"])


def run_port(ex, cwd, monkeypatch, capsys):
    """_common.run in ``cwd``; returns its result and its JSON line."""
    os.makedirs(cwd, exist_ok=True)
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    out = _common.run(ex)
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert line == out["report"]
    return out, line


@pytest.fixture
def same_clusters(monkeypatch):
    monkeypatch.setattr(JC, "sah_order", PC.sah_order)


@pytest.fixture
def reference_root(tmp_path, monkeypatch):
    """A $SRT_REFERENCE_ROOT holding the two stand-in OBJs."""
    root = tmp_path / "reference"
    write_standin(str(root / "data/OBJs/MIS.obj"), mis_standin(MIS_SEG))
    write_standin(str(root / "data/OBJs/cornell_pbr.obj"), cornell_standin())
    monkeypatch.setenv(REFERENCE_ROOT_ENV, str(root))
    return root


def jax_config1_scene():
    """examples/config1_spheres_direct.py:23-48 on the JAX package."""
    g = 3.0
    tris = np.array(
        [[[-g, 0, -g], [g, 0, g], [g, 0, -g]],
         [[-g, 0, -g], [-g, 0, g], [g, 0, g]],
         [[-0.6, 3, -0.6], [0.6, 3, -0.6], [0.6, 3, 0.6]],
         [[-0.6, 3, -0.6], [0.6, 3, 0.6], [-0.6, 3, 0.6]]], np.float32)
    mats = jax_make_materials(
        emission=[(1, 0, 1), (0, 0, 0), (30, 30, 30)],
        diffuse=[(0, 0, 0), (0.7, 0.7, 0.7), (0, 0, 0)],
        metalness=[0, 0, 0], roughness=[1.0, 1.0, 1.0])
    scene = jax_make_scene(tris, np.array([1, 1, 2, 2], np.int32), mats)
    scene = jax_add_sphere(scene, (0.0, 0.7, 0.0), 0.7,
                           diffuse=(0.8, 0.3, 0.3), roughness=1.0)
    scene = jax_add_sphere(scene, (1.4, 0.45, 0.6), 0.45,
                           diffuse=(0.3, 0.8, 0.3), roughness=1.0)
    return jax_add_sphere(scene, (-1.3, 0.5, -0.4), 0.5,
                          diffuse=(0.3, 0.3, 0.8), roughness=1.0)


def test_config1_matches_jax(tmp_path, monkeypatch, capsys):
    """Spheres, direct light, brute force on both sides, one untiled
    render; 32x32, 2 spp: per pixel, and the JSON line."""
    monkeypatch.setattr(config1_spheres_direct, "SMALL",
                        dict(size=32, spp=2))
    ex = config1_spheres_direct.build(small=True, device="cpu")
    cfg = JaxConfig(width=32, height=32, samples=2, bounces=1,
                    tile_rays=None)
    assert_same_config(ex.config, cfg)
    js = jax_config1_scene()
    assert_same_scene(ex.scene, js)
    assert PP._resolve_backend(ex.scene, cfg.intersect) == "brute"
    cam = JaxCamera.create(45.0, JT.compose(JT.rotation_x(-20.0),
                                            JT.translation(0.0, 0.2, 6.0)))
    np.testing.assert_allclose(ex.camera.view_matrix.numpy(),
                               np.asarray(cam.view_matrix), rtol=1e-6,
                               atol=1e-7)
    want, j_over = jax_frame(js, cam, cfg)
    out, line = run_port(ex, tmp_path, monkeypatch, capsys)
    assert set(line) == {"example", "seconds", "Mrays_per_s"}
    assert line["example"] == "config1_spheres_direct"
    assert out["overflow"] is j_over is False
    assert out["image"].mean() > 0.01 and (tmp_path / "example1.png").exists()
    np.testing.assert_allclose(out["image"], want, rtol=1e-4, atol=1e-6)


def test_config2_matches_jax(reference_root, same_clusters, tmp_path,
                             monkeypatch, capsys):
    """The MIS stand-in (334 triangles) through the OBJ loaders and
    build_acceleration(num_rays_hint=tile): 32x32, 2 spp, 4 bounces,
    256-ray tiles (4 tiles): per pixel against the JAX render run op by
    op.  On this scene the JAX package's jitted frame differs from its own
    op-by-op frame at a few pixels (15-23 channel values even at 1
    bounce, one of them 0 against 0.0011): XLA's fusion reorders float32
    ops where a sphere light's tiny triangles sit at a cosine near 0; the
    port's frame agrees with the op-by-op one everywhere."""
    monkeypatch.setattr(config2_obj_bvh, "SMALL",
                        dict(size=32, spp=2, tile=256))
    path = config2_obj_bvh.find_data(config2_obj_bvh.MIS_OBJ)
    assert path == str(reference_root / "data/OBJs/MIS.obj")
    ex = config2_obj_bvh.build(path, small=True, device="cpu")
    cfg = JaxConfig(width=32, height=32, samples=2, bounces=4, tile_rays=256)
    assert_same_config(ex.config, cfg)
    js = jax_load_scene(path).build_acceleration(num_rays_hint=256)
    assert_same_scene(ex.scene, js)
    assert ex.scene.num_triangles == 334 and ex.scene.num_lights > 300
    assert PP._resolve_backend(ex.scene, cfg.intersect) == "list"
    assert JP._resolve_backend(js, cfg.intersect) == "cluster"
    want, j_over = jax_frame(js, jax_mis_camera(), cfg, jit=False)
    out, _ = run_port(ex, tmp_path, monkeypatch, capsys)
    assert out["overflow"] is j_over is False
    assert out["image"].mean() > 0.05 and (tmp_path / "example2.png").exists()
    np.testing.assert_allclose(out["image"], want, rtol=1e-4, atol=1e-6)


def test_config3_matches_jax(same_clusters, tmp_path, monkeypatch, capsys):
    """dragon_scene(2_000, with_sky=False), intersect="list", 32x18, 1
    spp, 4 bounces, 128-ray tiles (5 tiles, the last padded by 64 rays):
    no sky, so the shared estimator's env terms are off; per pixel, and
    the JSON line's triangles."""
    monkeypatch.setattr(config3_dragon_mis, "SMALL",
                        dict(w=32, h=18, spp=1, tris=2_000, tile=128))
    ex = config3_dragon_mis.build(small=True, device="cpu")
    cfg = JaxConfig(width=32, height=18, samples=1, bounces=4,
                    tile_rays=128, intersect="list")
    assert_same_config(ex.config, cfg)
    js = jax_dragon(n_tris=2_000, with_sky=False)
    assert_same_scene(ex.scene, js)
    assert ex.scene.env_map is None
    want, j_over = jax_frame(js, jax_dragon_camera(), cfg)
    out, line = run_port(ex, tmp_path, monkeypatch, capsys)
    assert line["triangles"] == 2_000
    assert set(line) == {"example", "seconds", "Mrays_per_s", "triangles"}
    assert out["overflow"] is j_over is False
    assert out["image"].mean() > 1e-3 and (tmp_path / "example3.png").exists()
    np.testing.assert_allclose(out["image"], want, rtol=1e-4, atol=1e-6)


def test_config4_files_match_jax(same_clusters, tmp_path, monkeypatch,
                                 capsys):
    """The 2k dragon under a 16x32 sky, "auto", 32x18, 1 spp, 4 bounces,
    one untiled pass: per pixel; example4.png byte for byte equal to the
    file the JAX script writes from its image, example4.hdr the same size
    with every byte within 1 of JAX's (an RGBE mantissa on a rounding
    boundary may round the other way: the images agree per pixel)."""
    monkeypatch.setattr(config4_env_tonemap, "SMALL",
                        dict(w=32, h=18, spp=1, tris=2_000, tile=32768))
    monkeypatch.setattr(config4_env_tonemap, "SKY_RES", (16, 32))
    ex = config4_env_tonemap.build(small=True, device="cpu")
    cfg = JaxConfig(width=32, height=18, samples=1, bounces=4,
                    tile_rays=32768)
    assert_same_config(ex.config, cfg)
    js = jax_dragon(n_tris=2_000, with_sky=True, sky_res=(16, 32))
    assert_same_scene(ex.scene, js)
    resolve = JP._resolve_backend
    monkeypatch.setattr(JP, "_resolve_backend",
                        lambda s, b, platform=None: resolve(s, b, "tpu"))
    assert JP._resolve_backend(js, "auto") == "list"
    want, j_over = jax_frame(js, jax_dragon_camera(), cfg)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    # examples/config4_env_tonemap.py:35-36
    jax_write_png(str(jdir / "example4.png"), np.asarray(jax_tonemap(want)))
    jax_write_hdr(str(jdir / "example4.hdr"), want)
    out, _ = run_port(ex, tmp_path / "port", monkeypatch, capsys)
    assert out["overflow"] is j_over is False
    assert out["image"].mean() > 0.01
    np.testing.assert_allclose(out["image"], want, rtol=1e-4, atol=1e-6)
    assert (tmp_path / "port" / "example4.png").read_bytes() == \
        (jdir / "example4.png").read_bytes()
    p, j = ((d / "example4.hdr").read_bytes() for d in (tmp_path / "port",
                                                        jdir))
    assert len(p) == len(j)
    assert np.abs(np.frombuffer(p, np.uint8).astype(int)
                  - np.frombuffer(j, np.uint8)).max() <= 1


def test_config2_without_its_obj_exits_2(tmp_path, monkeypatch, capsys):
    """No MIS.obj under the cwd or $SRT_REFERENCE_ROOT: an error, exit 2,
    nothing rendered or written."""
    monkeypatch.setenv(REFERENCE_ROOT_ENV, str(tmp_path / "empty"))
    monkeypatch.chdir(tmp_path)

    def no_render(*a, **k):
        raise AssertionError("rendered without its OBJ")

    monkeypatch.setattr(PP, "render", no_render)
    assert config2_obj_bvh.main(["--small"], device="cpu") == 2
    assert capsys.readouterr().out.splitlines() == [
        "error: OBJ file not found: data/OBJs/MIS.obj"]
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("argv", [[], ["--small"]])
def test_config5_runs_the_trainer_with_the_jax_arguments(argv, monkeypatch):
    """config5 hands train.main the JAX script's argument lists
    (examples/config5_inverse_sharded.py:19-26) and returns its code."""
    seen = []

    def fake_main(args, device):
        seen.append((args, device))
        return 7

    monkeypatch.setattr(train, "main", fake_main)
    assert config5_inverse_sharded.main(argv, device="cpu") == 7
    want = (["--steps=20", "--w=12", "--h=12", "--samples=4"] if argv
            else ["--steps=100", "--w=32", "--h=32", "--samples=16"])
    assert seen == [(want, "cpu")]


def test_config5_without_its_obj_exits_2(tmp_path, monkeypatch, capsys):
    """No cornell_pbr.obj: the trainer prints the error and exits 2
    before it renders anything."""
    monkeypatch.setenv(REFERENCE_ROOT_ENV, str(tmp_path / "empty"))
    monkeypatch.chdir(tmp_path)

    def no_render(*a, **k):
        raise AssertionError("trained without its OBJ")

    monkeypatch.setattr(train, "run", no_render)
    assert config5_inverse_sharded.main(["--small"], device="cpu") == 2
    assert capsys.readouterr().out.splitlines() == [
        "error: OBJ file not found: data/OBJs/cornell_pbr.obj"]


def test_config5_trains_on_the_cornell_standin(reference_root, tmp_path,
                                               monkeypatch, capsys):
    """--small on the Cornell stand-in: 20 steps at 12x12, 4 spp, brute
    force (no clusters, so no list kernel), the diffuse error falls, exit
    0."""
    monkeypatch.chdir(tmp_path)
    assert config5_inverse_sharded.main(["--small"], device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "mesh: {'data': 1, 'sample': 1}"
    assert lines[-1].startswith("done in ")


@pytest.mark.parametrize("extra", [None, {"triangles": 200_000}])
@pytest.mark.parametrize("seconds,rays", [(1.23456, 65_536 * 16),
                                          (0.0004, 7), (3600.5, 2 ** 33)])
def test_report_matches_jax(extra, seconds, rays, capsys):
    """The JSON line: the JAX helper's keys, order and rounding."""
    _common.report("x", seconds, rays, extra)
    ours = capsys.readouterr().out
    jax_common().report("x", seconds, rays, extra)
    assert ours == capsys.readouterr().out
    assert list(json.loads(ours)) == ["example", "seconds", "Mrays_per_s"] \
        + list(extra or {})


def test_timed_render_warms_up_then_keeps_the_fastest():
    calls = []

    def fn(x):
        calls.append(x)
        return torch.full((2, 2, 3), float(len(calls))), {"overflow": False}

    img, aux, seconds = _common.timed_render(fn, 5, n=3)
    assert calls == [5] * 4 and aux == {"overflow": False}
    assert isinstance(img, np.ndarray) and img[0, 0, 0] == 4.0
    assert 0 <= seconds < 1


@pytest.mark.parametrize("argv", [[], ["--small"], ["x", "--small", "y"]])
def test_small_flag_matches_jax(argv, monkeypatch):
    monkeypatch.setattr("sys.argv", ["prog"] + argv)
    assert _common.small() == jax_common().small() == _common.small(argv)
