"""The port's CLI and its host modules against the JAX package's: the
argument parser, the whole CLI on the same written OBJ + sky (untiled, and
tiled against pathtracer.render too), the overflow regrow, the progressive
renderer resumed from a JAX-written checkpoint, the denoiser and
RenderMetrics.

The OBJ + MTL and the .hdr sky are written from the procedural 2k dragon
scene (utils.procedural's write_obj, the port's write_hdr), so no
reference data is read.  Each CLI runs with its own temporary directory
as the cwd: the CLI writes its five outputs there.

Tolerances: the CLIs' RT_output.hdr per pixel within rtol 1e-4 / atol
1e-6 (tests/test_torch_parity.py's per-pixel tolerance; the same samples,
only float32 op order differs) and their tone-mapped PNGs within one
8-bit step; the resumed image the same per-pixel tolerance; denoise within
atol 1e-5.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import main as jax_main
from sycl_ray_tracing_tpu.models import scene as JS
from sycl_ray_tracing_tpu.models.camera import pbrt_dragon_camera as jax_cam
from sycl_ray_tracing_tpu.models.progressive import (
    ProgressiveRenderer as JaxProgressive,
)
from sycl_ray_tracing_tpu.ops import cluster as JC
from sycl_ray_tracing_tpu.utils.config import RenderConfig as JaxConfig
from sycl_ray_tracing_tpu.utils.config import parse_cli as jax_parse_cli
from sycl_ray_tracing_tpu.utils.denoise import denoise as jax_denoise
from sycl_ray_tracing_tpu.utils.procedural import dragon_scene as jax_dragon
from sycl_ray_tracing_tpu_torch import main as port_main
from sycl_ray_tracing_tpu_torch.main import CLI_OUTPUTS
from sycl_ray_tracing_tpu_torch.models import scene as PS
from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
from sycl_ray_tracing_tpu_torch.models.progressive import (
    ProgressiveRenderer,
    ProgressiveState,
)
from sycl_ray_tracing_tpu_torch.ops import cluster as PC
from sycl_ray_tracing_tpu_torch.utils import config as PCFG
from sycl_ray_tracing_tpu_torch.utils import metrics
from sycl_ray_tracing_tpu_torch.utils.denoise import denoise
from sycl_ray_tracing_tpu_torch.utils.hdr import read_hdr, write_hdr
from sycl_ray_tracing_tpu_torch.utils.image_io import read_png
from sycl_ray_tracing_tpu_torch.utils.metrics import (
    RenderMetrics,
    device_op_totals,
    profiler_trace,
)
from sycl_ray_tracing_tpu_torch.utils.procedural import (
    dragon_scene,
    procedural_sky,
    write_obj,
)
from test_torch_cluster import jax_scene_arrays
from torch_card import card  # noqa: F401


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The 2k dragon scene as d.obj + d.mtl and a 16x32 sky as sky.hdr."""
    d = tmp_path_factory.mktemp("assets")
    s = dragon_scene(2_000, with_sky=False, build_accel=False, device="cpu")
    write_obj(str(d / "d.obj"), s.triangles, s.material_indices, s.materials)
    write_hdr(str(d / "sky.hdr"), procedural_sky(16, 32))
    return d


def _run_cli(fn, cwd, argv, **kw):
    old = os.getcwd()
    os.makedirs(cwd, exist_ok=True)
    os.chdir(cwd)
    try:
        return fn(argv, **kw)
    finally:
        os.chdir(old)


@pytest.mark.parametrize("argv", [
    [],
    ["scene.obj", "--sky=s.hdr", "--w=64", "--h=32", "--samples=16",
     "--bounces=3", "--camera=pbrt_dragon", "--intersect=list",
     "--estimator=parity", "--spp-pass=4"],
    ["--checkpoint=ck.npz", "--checkpoint-batch=2", "x.obj", "--samples=6"],
])
def test_parse_cli_matches_jax(argv):
    pc, pobj, psky = PCFG.parse_cli(argv)
    jc, jobj, jsky = jax_parse_cli(argv)
    assert (pobj, psky) == (jobj, jsky)
    assert [f.name for f in dataclasses.fields(pc)] == \
        [f.name for f in dataclasses.fields(jc)]
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc)


def test_find_data_looks_in_the_reference_root(tmp_path, monkeypatch):
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "a.obj").write_text("v 0 0 0\n")
    monkeypatch.chdir(tmp_path / "data")
    assert PCFG.find_data("a.obj") == "a.obj"
    monkeypatch.delenv(PCFG.REFERENCE_ROOT_ENV, raising=False)
    assert PCFG.find_data("data/a.obj") is None
    monkeypatch.setenv(PCFG.REFERENCE_ROOT_ENV, str(tmp_path))
    assert PCFG.find_data("data/a.obj") == str(tmp_path / "data" / "a.obj")


@pytest.mark.parametrize("backend", ["brute", "list"])
def test_cli_frame_matches_jax(assets, tmp_path, monkeypatch, capsys,
                               backend):
    """Both CLIs on the same OBJ + sky, 16x16, 2 spp, 2 bounces: every
    output is written, and the HDR images agree per pixel.  The JAX side
    takes the port's SAH cluster order (its own needs its native library
    built), so both trace the same clusters."""
    monkeypatch.setattr(JC, "sah_order", PC.sah_order)
    argv = [str(assets / "d.obj"), f"--sky={assets / 'sky.hdr'}", "--w=16",
            "--h=16", "--samples=2", "--bounces=2", "--camera=pbrt_dragon",
            f"--intersect={backend}", "--estimator=shared"]
    assert _run_cli(jax_main.main, tmp_path / "jax", argv) == 0
    capsys.readouterr()
    assert _run_cli(port_main.main, tmp_path / "port", argv,
                    device="cpu") == 0
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    for name in CLI_OUTPUTS:
        assert (tmp_path / "port" / name).exists(), name
    # the brute backend builds no clusters, so it has no accel_build
    assert set(report) == {"time/scene_load", "time/render", "count/rays",
                           "Mrays_per_s"} | (
        {"time/accel_build"} if backend == "list" else set())
    assert report["count/rays"] == 16 * 16 * 2 * 2
    p = read_hdr(str(tmp_path / "port" / "RT_output.hdr"))
    j = read_hdr(str(tmp_path / "jax" / "RT_output.hdr"))
    assert p.shape == (16, 16, 3) and p.mean() > 1e-3
    np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-6)
    for name in ("RT_output.png", "RT_output_denoised_0.5.png"):
        a = read_png(str(tmp_path / "port" / name)).astype(int)
        b = read_png(str(tmp_path / "jax" / name)).astype(int)
        assert np.abs(a - b).max() <= 1, name


def test_cli_regrow_matches_jax(assets, tmp_path, monkeypatch, capsys):
    """Clusters built with candidate depth 1 leave rays uncertified: both
    CLIs print the same doubling and end without an error."""
    monkeypatch.setattr(JC, "sah_order", PC.sah_order)
    for mod in (JS, PS):
        build = mod.Scene.build_acceleration

        def shallow(self, *a, _build=build, **kw):
            s = _build(self, *a, **kw)
            return s.with_clusters(s.clusters.with_list_maxc(1))

        monkeypatch.setattr(mod.Scene, "build_acceleration", shallow)
    argv = [str(assets / "d.obj"), "--sky=", "--w=8", "--h=8",
            "--samples=1", "--bounces=1", "--camera=pbrt_dragon",
            "--intersect=list", "--estimator=shared"]
    said = {}
    for name, fn, kw in (("jax", jax_main.main, {}),
                         ("port", port_main.main, {"device": "cpu"})):
        capsys.readouterr()
        assert _run_cli(fn, tmp_path / name, argv, **kw) == 0
        said[name] = [ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith(("WARNING", "ERROR"))]
    assert said["port"] == said["jax"] == [
        "WARNING: uncertified rays at candidate depth maxc=1; doubling and "
        "re-rendering"]


# the CLI arguments past the frame's, and COMPACT_MIN_B on both sides
# (None: as is, the plain loop at these widths): the shared estimator
# on brute force, with two samples a pass, the parity estimator's fused
# list-tracer bounce, and the shared estimator's compacted wavefront
TILED = {
    "shared": (["--samples=2", "--intersect=brute", "--estimator=shared"],
               None),
    "spp_pass": (["--samples=2", "--spp-pass=2", "--intersect=brute",
                  "--estimator=shared"], None),
    "parity": (["--samples=1", "--intersect=list", "--estimator=parity"],
               None),
    "compacted": (["--samples=1", "--intersect=list", "--estimator=shared"],
                  1),
}


@pytest.mark.parametrize("case", list(TILED))
def test_cli_tiled_matches_render_and_jax(assets, tmp_path, monkeypatch,
                                          case):
    """With tile_rays=96 the 16x16 frame takes the CLI's tiled path (3
    tiles, the last zero-padded, in one batch): the port's image equals
    pathtracer.render's on the same scene, config and key bit for bit (the
    same tile and key schedule), and so does that render a tile a batch;
    the JAX CLI's tiled image per pixel within rtol 1e-4 / atol 1e-6."""
    from sycl_ray_tracing_tpu.models import pathtracer as JP
    from sycl_ray_tracing_tpu.utils import config as JCFG
    from sycl_ray_tracing_tpu_torch.models import pathtracer
    from sycl_ray_tracing_tpu_torch.ops.rng import prng_key
    from sycl_ray_tracing_tpu_torch.utils.image_io import read_image_float
    from sycl_ray_tracing_tpu_torch.utils.obj_loader import load_scene

    args, min_b = TILED[case]
    monkeypatch.setattr(JC, "sah_order", PC.sah_order)
    if min_b is not None:
        for mod in (JP, pathtracer):
            monkeypatch.setattr(mod, "COMPACT_MIN_B", min_b)
    for mod in (JCFG, PCFG):
        parse = mod.parse_cli

        def tiled(argv, _parse=parse):
            cfg, obj, sky = _parse(argv)
            return dataclasses.replace(cfg, tile_rays=96), obj, sky

        monkeypatch.setattr(mod, "parse_cli", tiled)
    argv = [str(assets / "d.obj"), f"--sky={assets / 'sky.hdr'}", "--w=16",
            "--h=16", "--bounces=2", "--camera=pbrt_dragon", *args]
    assert _run_cli(jax_main.main, tmp_path / "jax", argv) == 0
    assert _run_cli(port_main.main, tmp_path / "port", argv,
                    device="cpu") == 0
    cfg = PCFG.parse_cli(argv)[0]
    scene = load_scene(str(assets / "d.obj"), device="cpu",
                       env_map_image=read_image_float(
                           str(assets / "sky.hdr"), flip_y=True))
    if cfg.intersect == "list":
        scene = scene.build_acceleration(num_rays_hint=cfg.tile_rays)
    renders = {}
    for batch in (pathtracer.BATCH_RAYS,
                  cfg.tile_rays * cfg.samples_per_pass):
        monkeypatch.setattr(pathtracer, "BATCH_RAYS", batch)
        tiles = []
        metrics.reset_counts()
        with torch.no_grad():
            img = pathtracer.render(
                scene, pbrt_dragon_camera("cpu"), cfg, prng_key(0),
                on_tile=lambda i, n, h, tiles=tiles: tiles.append(
                    (i, n, h.clone())))
        renders[batch] = (img, tiles, metrics.COUNTS["render.batches"])
    (want, tiles, made), (one, _tiles, made_one) = renders.values()
    # one batch of the 3 tiles, then on_tile once a tile, in order, with
    # the tile's rows of the image; a tile a batch gives the same image
    assert (made, made_one) == (1, 3)
    assert [(i, n) for i, n, _h in tiles] == [(0, 3), (1, 3), (2, 3)]
    flat = want.reshape(-1, 3)
    for i, _n, h in tiles:
        rows = flat[i * 96:(i + 1) * 96]
        assert torch.equal(h[:rows.shape[0]], rows)
    assert torch.equal(want, one)
    # render's image through the same RGBE writer as the CLI's
    write_hdr(str(tmp_path / "want.hdr"), want.numpy())
    p = read_hdr(str(tmp_path / "port" / "RT_output.hdr"))
    j = read_hdr(str(tmp_path / "jax" / "RT_output.hdr"))
    assert p.shape == (16, 16, 3) and p.mean() > 1e-3
    np.testing.assert_array_equal(p, read_hdr(str(tmp_path / "want.hdr")))
    np.testing.assert_allclose(p, j, rtol=1e-4, atol=1e-6)


def test_progressive_resumes_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX renderer saved after its first batch, resumed
    by the port's renderer, gives the port's uninterrupted image; the
    port's checkpoint is read back by the JAX loader."""
    js = jax_dragon(n_tris=2_000, with_sky=True, sky_res=(16, 32),
                    build_accel=False)
    ps = PS.scene_from_numpy(jax_scene_arrays(js), "cpu")
    kw = dict(width=8, height=8, samples=2, bounces=1, intersect="brute",
              tile_rays=None)
    ck = str(tmp_path / "jax.npz")
    jr = JaxProgressive(js, jax_cam(), JaxConfig(**kw), seed=7,
                        samples_per_batch=1)
    jr.step()
    jr.state.save(ck)

    cfg = PCFG.RenderConfig(**kw)
    resumed = ProgressiveRenderer.resume(ps, pbrt_dragon_camera("cpu"), cfg,
                                         ck, samples_per_batch=1)
    assert resumed.state.samples_done == 1 and resumed.state.seed == 7
    ours = str(tmp_path / "port.npz")
    img = resumed.run(checkpoint_path=ours)
    full = ProgressiveRenderer(ps, pbrt_dragon_camera("cpu"), cfg, seed=7,
                               samples_per_batch=1).run()
    assert img.shape == (8, 8, 3) and full.mean() > 1e-3
    np.testing.assert_allclose(img, full, rtol=1e-4, atol=1e-6)

    from sycl_ray_tracing_tpu.models.progressive import (
        ProgressiveState as JaxState,
    )

    back = JaxState.load(ours)
    assert back.samples_done == 2 and back.seed == 7
    assert back.overflow is False
    np.testing.assert_array_equal(back.hdr_sum,
                                  ProgressiveState.load(ours).hdr_sum)


@pytest.mark.parametrize("blend", [1.0, 0.75, 0.5])
def test_denoise_matches_jax(blend):
    rng = np.random.default_rng(11)
    img = rng.uniform(0.0, 2.0, (24, 20, 3)).astype(np.float32)
    img[6:9, 4:12] = 40.0           # an edge the range kernel must keep
    want = np.asarray(jax_denoise(jax.numpy.asarray(img), blend=blend))
    got = denoise(torch.as_tensor(img), blend=blend).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_render_metrics():
    m = RenderMetrics()
    with m.phase("build"):
        pass
    x = m.timed("render", lambda: torch.ones((8, 8)) * 2.0)
    assert float(x[0, 0]) == 2.0
    m.count("rays", 1e6)
    m.count("rays", 1e6)
    rep = m.report()
    assert "time/build" in rep and "time/render" in rep
    assert rep["count/rays"] == 2e6
    assert rep["Mrays_per_s"] == round(m.rays_per_second() / 1e6, 3)
    assert m.rays_per_second() > 0
    assert isinstance(m.dump(), str)


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with profiler_trace(None) as prof:
        assert prof is None
    with profiler_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64).cumsum(0)
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())
    # no CUDA activity on the CPU: no device ops to total
    assert device_op_totals(prof) == {}


# ---- on a card ----

CARD_ARGV = ["--w=64", "--h=64", "--bounces=8", "--camera=pbrt_dragon",
             "--intersect=list", "--estimator=shared"]


@pytest.mark.card
def test_cli_frame_on_the_card(assets, card, tmp_path, monkeypatch, capsys):
    """The CLI on the card at 4 spp: exit 0, no regrow, the block kernel
    launched, the five outputs, and RT_output.hdr equal to the rendered
    image to RGBE precision (each channel within 1/128 of its pixel's
    largest)."""
    from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as PL
    from sycl_ray_tracing_tpu_torch.utils import hdr

    wrote = []
    write = hdr.write_hdr
    monkeypatch.setattr(hdr, "write_hdr", lambda path, image: (
        wrote.append(np.array(image, np.float32)), write(path, image)))
    PL.reset_launch_counts()
    argv = [str(assets / "d.obj"), f"--sky={assets / 'sky.hdr'}",
            "--samples=4", *CARD_ARGV]
    assert _run_cli(port_main.main, tmp_path, argv, device=card) == 0
    out = capsys.readouterr().out.splitlines()
    assert not [ln for ln in out if ln.startswith(("WARNING", "ERROR"))]
    assert PL.LAUNCHES["block_tiles"] >= 1
    for name in CLI_OUTPUTS:
        assert (tmp_path / name).exists(), name
    img, back = wrote[-1], read_hdr(str(tmp_path / "RT_output.hdr"))
    assert np.isfinite(img).all() and img.mean() > 1e-3
    assert (np.abs(back - img)
            <= np.maximum(back, img).max(axis=-1, keepdims=True) / 128
            + 1e-30).all()


@pytest.mark.card
def test_cli_resumes_a_checkpoint_on_the_card(assets, card, tmp_path):
    """One batch saved by ProgressiveRenderer, resumed by the CLI to 2
    spp: the uninterrupted render's image bit for bit, certified."""
    from sycl_ray_tracing_tpu_torch.utils.image_io import read_image_float
    from sycl_ray_tracing_tpu_torch.utils.obj_loader import load_scene

    ck = str(tmp_path / "ck.npz")
    argv = [str(assets / "d.obj"), f"--sky={assets / 'sky.hdr'}",
            "--samples=2", f"--checkpoint={ck}", "--checkpoint-batch=1",
            *CARD_ARGV]
    cfg = PCFG.parse_cli(argv)[0]
    scene = load_scene(str(assets / "d.obj"), device=card,
                       env_map_image=read_image_float(
                           str(assets / "sky.hdr"), flip_y=True))
    scene = scene.build_acceleration(num_rays_hint=cfg.tile_rays)
    cam = pbrt_dragon_camera(card)
    first = ProgressiveRenderer(scene, cam, cfg, samples_per_batch=1)
    first.step()
    first.state.save(ck)
    assert _run_cli(port_main.main, tmp_path, argv, device=card) == 0
    resumed = ProgressiveState.load(ck)
    whole = ProgressiveRenderer(scene, cam, cfg, samples_per_batch=1)
    whole.run()
    assert resumed.samples_done == 2 and not resumed.overflow
    np.testing.assert_array_equal(resumed.image, whole.state.image)


@pytest.mark.card
def test_cli_regrow_on_the_card(assets, card, tmp_path, monkeypatch, capsys):
    """Clusters of candidate depth 1 leave rays uncertified: the CLI
    doubles the depth and ends with every ray certified."""
    build = PS.Scene.build_acceleration

    def shallow(self, *a, **kw):
        s = build(self, *a, **kw)
        return s.with_clusters(s.clusters.with_list_maxc(1))

    monkeypatch.setattr(PS.Scene, "build_acceleration", shallow)
    argv = [str(assets / "d.obj"), f"--sky={assets / 'sky.hdr'}",
            "--samples=2", *CARD_ARGV]
    assert _run_cli(port_main.main, tmp_path, argv, device=card) == 0
    said = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith(("WARNING", "ERROR"))]
    assert said and not [ln for ln in said if ln.startswith("ERROR")]
