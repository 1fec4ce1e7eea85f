"""The port's parity estimator (``estimator="parity"``, ``trace``: five
list-tracer queries a bounce) against the benchmark's plain reference of
it, benchmark/reference/estimators/parity.py, per pixel at the preview
traffic's tolerance (1e-6 + 1e-4 * |reference|), on the CPU with the list
tracer's plain kernel versions.

Two seeded procedural scenes with the benchmark's emissive panel and a
16x32 sky: a few thousand triangles (dense candidate builds), and a
stand-in of ~360k triangles, whose 2816 clusters lie above the
supercluster threshold 2 * 21 * 64 once the block lists hold 64 slots
(``DEFAULT_MAXC_SHARE``), so every main pass takes the supercluster build
and the per-ray escalation keeps its full 128 slots.  Frames of two tiles
at bounces 1 and 3.  A tie in t (a ray through a shared edge) is read
both ways, as the benchmark's check reads it.

Each fault must fail the same comparison on more than the preview
traffic's limit of pixels: the reference in bfloat16, the sky NEE's
brdf-sample term left out, the ``_NEE_BRDF`` / ``_ENV_BRDF`` key tags
swapped.  The spans ``nee.light`` / ``nee.env`` and the counter
``query.passes`` of a traced parity render are counted.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import inputs as bench_inputs
from benchmark import loops
from benchmark.reference import estimators, pathtrace, rng
from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace
from sycl_ray_tracing_tpu_torch.utils import metrics

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ATOL, RTOL = 1e-6, 1e-4
LIMIT = 0.1            # the preview traffic's pixels_off limit
SIZE = {"width": 16, "height": 12, "tile_rays": 128}
SCENES = {"small": 3_000, "supercluster": 360_000}
HIER_MAXC_SHARE = 64   # block-list slots that put 2816 clusters above
#                        the supercluster threshold


def _config(triangles: int, bounces: int) -> dict:
    cfg = bench_inputs.load_config("dragon870k_parity")
    cfg["mesh"]["standin_triangles"] = triangles
    cfg["sky"]["height"], cfg["sky"]["width"] = 16, 32
    cfg.update(SIZE, bounces=bounces)
    return cfg


@pytest.fixture(scope="module")
def built():
    """{scene name: (inputs, the port's Frames, the reference's Scene)},
    built once; ``Frames`` renders at the bounces of its ``rcfg``."""
    out = {}
    for name, n in SCENES.items():
        cfg = _config(n, 1)
        inputs = bench_inputs.scene_arrays(cfg)
        out[name] = (inputs, loops.Frames(inputs, cfg, CPU),
                     pathtrace.Scene(inputs, CPU))
    return out


def _port_frame(built, name, bounces, seed, monkeypatch):
    """The port's frame 0 under key(seed), flattened, and the supercluster
    builds its passes made."""
    inputs, frames, _ref = built[name]
    hier = []
    if name == "supercluster":
        monkeypatch.setattr(listtrace, "DEFAULT_MAXC_SHARE", HIER_MAXC_SHARE)
        build = listtrace.candidate_clusters_hier

        def spy(*args, **kw):
            hier.append(1)
            return build(*args, **kw)

        monkeypatch.setattr(listtrace, "candidate_clusters_hier", spy)
    monkeypatch.setattr(frames, "rcfg",
                        dataclasses.replace(frames.rcfg, bounces=bounces))
    img, overflow = frames.frame(rng.key_of_seed(seed), 0)
    assert not overflow
    return img.reshape(-1, 3), len(hier)


def _pixels_off(module, ref_scene, flat, seed, bounces) -> float:
    """The share of the frame's pixels where some channel is off the
    reference ``module`` on ``ref_scene`` by more than ATOL + RTOL *
    |reference|, each tile against the tie rule it is nearer."""
    key = rng.fold_in(rng.key_of_seed(seed), 0)
    n = SIZE["tile_rays"]
    bad = 0
    for tile in range(-(-flat.shape[0] // n)):
        rows = min(n, flat.shape[0] - tile * n)
        p = flat[tile * n:tile * n + rows]
        off = []
        for high in (False, True):
            ref_scene.tree.tie_high, ref_scene.tree.ties = high, 0
            r = module.render_tile(ref_scene, key, tile, n, SIZE["width"],
                                   SIZE["height"], bounces).float()[:rows]
            ok = (p - r).abs() <= ATOL + RTOL * r.abs()
            off.append(int((~ok.all(dim=1)).sum()))
            if not ref_scene.tree.ties:
                break
        ref_scene.tree.tie_high = False
        bad += min(off)
    return bad / flat.shape[0]


@pytest.fixture
def parity():
    """A fresh copy of the parity reference module (faults patch it)."""
    return estimators.load("parity", needs=("render_tile",))


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17, 4_200_000_001])
@pytest.mark.parametrize("bounces", [1, 3])
@pytest.mark.parametrize("name", list(SCENES))
def test_port_parity_frame_equals_the_reference(built, parity, monkeypatch,
                                                name, bounces, seed):
    flat, hier = _port_frame(built, name, bounces, seed, monkeypatch)
    assert torch.isfinite(flat).all() and float(flat.mean()) > 1e-3
    if name == "supercluster":
        assert built[name][1].scene.clusters.num_clusters > 2 * (
            HIER_MAXC_SHARE // 3) * 64
        assert hier >= 5 * 2
    assert _pixels_off(parity, built[name][2], flat, seed, bounces) == 0.0


def _no_env_brdf(mod):
    def zero(scene, hit, *args):
        return torch.zeros((hit["t"].shape[0], 3), dtype=scene.dtype)

    mod.env_brdf_term = zero


def _swap_tags(mod):
    mod._NEE_BRDF, mod._ENV_BRDF = mod._ENV_BRDF, mod._NEE_BRDF


@pytest.mark.parametrize("bounces", [1, 3])
@pytest.mark.parametrize("fault", ["bfloat16", "no_env_brdf_term",
                                   "swapped_brdf_tags"])
def test_each_fault_fails_the_comparison(built, parity, monkeypatch, fault,
                                         bounces):
    seed = 5
    flat, _ = _port_frame(built, "small", bounces, seed, monkeypatch)
    ref_scene = built["small"][2]
    if fault == "bfloat16":
        ref_scene = pathtrace.Scene(built["small"][0], CPU, torch.bfloat16)
    elif fault == "no_env_brdf_term":
        _no_env_brdf(parity)
    else:
        _swap_tags(parity)
    assert _pixels_off(parity, ref_scene, flat, seed, bounces) > LIMIT


def test_traced_parity_render_records_its_nee_spans_and_passes(built,
                                                               monkeypatch):
    """Each bounce of each tile opens nee.light and nee.env once, under
    its trace.bounce; every list-tracer pass counts under
    COUNTS["query.passes"], at least the five main passes a bounce."""
    bounces, tiles = 2, 2
    metrics.reset_counts()
    with metrics.tracing() as spans:
        _port_frame(built, "small", bounces, 7, monkeypatch)
    by_id = {s[3]: s for s in spans}
    for name in ("nee.light", "nee.env"):
        mine = [s for s in spans if s[0] == name]
        assert len(mine) == bounces * tiles
        assert sorted(s[7]["bounce"] for s in mine) == sorted(
            list(range(bounces)) * tiles)
        for s in mine:
            parent = by_id[s[4]]
            assert parent[0] == "trace.bounce"
            assert parent[7]["bounce"] == s[7]["bounce"]
    passes = sum(s[0] == "query.pass" for s in spans)
    assert metrics.COUNTS["query.passes"] == passes
    assert passes >= 5 * bounces * tiles


def test_the_reference_turns_tf32_off_and_imports_no_program():
    """render_tile turns TF32 off itself, and loading the module loads
    neither the port, the JAX package nor JAX."""
    code = (
        "import sys, json, torch\n"
        "from benchmark.reference import estimators, pathtrace, rng\n"
        "from benchmark import inputs\n"
        "torch.backends.cuda.matmul.allow_tf32 = True\n"
        "torch.backends.cudnn.allow_tf32 = True\n"
        "mod = estimators.load('parity', needs=('render_tile',))\n"
        "cfg = inputs.load_config('dragon870k_parity')\n"
        "cfg['mesh']['standin_triangles'] = 500\n"
        "cfg['sky']['height'], cfg['sky']['width'] = 8, 16\n"
        "scene = pathtrace.Scene(inputs.scene_arrays(cfg), 'cpu')\n"
        "hdr = mod.render_tile(scene, rng.key_of_seed(1), 0, 32, 8, 4, 1)\n"
        "print(json.dumps({'tf32': [torch.backends.cuda.matmul.allow_tf32,\n"
        "                           torch.backends.cudnn.allow_tf32],\n"
        "                  'finite': bool(torch.isfinite(hdr).all()),\n"
        "                  'modules': sorted({m.split('.')[0]\n"
        "                                     for m in sys.modules})}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["tf32"] == [False, False] and got["finite"]
    loaded = set(got["modules"])
    assert not loaded & {"jax", "jaxlib", "sycl_ray_tracing_tpu",
                         "sycl_ray_tracing_tpu_torch"}
