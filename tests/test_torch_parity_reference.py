"""The port's parity estimator (``estimator="parity"``, ``trace``: five
scene queries a bounce, traced by the list tracer in one fused call a
bounce) against the benchmark's plain reference of it,
benchmark/reference/estimators/parity.py, per pixel at the preview
traffic's tolerance (1e-6 + 1e-4 * |reference|), on the CPU with the list
tracer's plain kernel versions.  Each answer of a fused call equals the
same query made alone, on the CPU and, on one tile of the benchmark's
870k stand-in, on a card.

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
swapped.  The spans ``nee.light`` / ``nee.env`` and the counters
``query.passes`` and ``parity.fused_queries`` of a traced parity render
are counted.
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
from sycl_ray_tracing_tpu_torch.models import pathtracer as PP
from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace
from sycl_ray_tracing_tpu_torch.ops.rng import prng_key
from sycl_ray_tracing_tpu_torch.utils import metrics
from torch_card import card  # noqa: F401

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


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The frames' list walks run on one thread: the fused calls' tensors
    are wide enough for torch's intra-op threads, which stall for minutes
    when the test run's other workers hold every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
        # the main passes of the primaries and the first bounce's fused
        # call build them for the frame's one batch of two tiles (a later
        # call whose rays all died builds nothing)
        assert hier >= 2
    assert _pixels_off(parity, built[name][2], flat, seed, bounces) == 0.0


def _hold_fused_calls(scene, render) -> dict:
    """Runs ``render()`` with the parity estimator's query calls
    (``_trace_queries``) recorded, then makes each query of each call
    alone on the same rays and mask (``occluded`` / ``intersect_scene``,
    the list tracer; on CPU tensors its plain versions): the blocked bits,
    or the closest hit's prim and t, equal the fused call's.  The bounce
    that reads a call's continuation (q 0) re-intersects it on the
    continuation's own rays, so it reads what its own closest hit made
    alone would.  Returns {query number: calls that held it}."""
    calls, hits = [], []
    trace_queries, hit_of_prim = PP._trace_queries, PP._hit_of_prim

    def record_calls(*args):
        answers = trace_queries(*args)
        calls.append((args[3], args[4], answers))
        return answers

    def record_hits(scene, o, d, prim):
        hits.append((o, d, prim))
        return hit_of_prim(scene, o, d, prim)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(PP, "_trace_queries", record_calls)
        mp.setattr(PP, "_hit_of_prim", record_hits)
        render()
    held = {}
    for key, queries, answers in calls:
        fused = PP._finish_answers(scene, queries, answers)
        for q, (o, d, t_max, mask, any_hit) in queries.items():
            if any_hit:
                alone = PP.occluded(scene, o, d, t_max, "list", mask=mask)
                assert torch.equal(fused[q], alone), (key, q)
            else:
                alone = PP.intersect_scene(scene, o, d, "list", mask=mask)
                assert torch.equal(fused[q].prim, alone.prim), (key, q)
                assert torch.equal(fused[q].t, alone.t), (key, q)
            held[q] = held.get(q, 0) + 1
        if 0 in queries:
            (o, d), = [h[:2] for h in hits if h[2] is answers[0]]
            assert torch.equal(o, queries[0][0]), key
            assert torch.equal(d, queries[0][1]), key
    return held


@pytest.mark.parametrize("bounces", [1, 3])
@pytest.mark.parametrize("name", list(SCENES))
def test_fused_answers_equal_the_queries_made_alone(built, monkeypatch, name,
                                                    bounces):
    """Every call of a two-tile parity frame (one batch) on the list
    tracer: the primaries', and each bounce's four NEE rays with the next
    bounce's continuation (none after the last bounce), answer as each
    query alone does."""
    held = _hold_fused_calls(built[name][1].scene, lambda: _port_frame(
        built, name, bounces, 11, monkeypatch))
    assert held == {q: bounces for q in range(5)}


@pytest.mark.card
def test_fused_answers_equal_the_queries_made_alone_on_the_card(card):
    """The first 32768-ray tile of the parity cell's 512x512 8-bounce
    frame on its 870k stand-in, on the card: each fused call's answers
    equal the queries made alone, and the tile takes at most two list
    passes (a main pass and its escalation) a call: the primaries' and
    one a bounce."""
    cfg = bench_inputs.load_config("dragon870k_parity")
    frames = loops.Frames(bench_inputs.scene_arrays(cfg), cfg, card)
    n, w, bounces = cfg["tile_rays"], cfg["width"], cfg["bounces"]
    pix = torch.arange(n, device=card)
    passes = []

    def render():
        metrics.reset_counts()
        with torch.no_grad():
            _rad, aux = PP.render_rays(
                frames.scene, frames.camera, (pix % w).float(),
                (pix // w).float(), w, cfg["height"], prng_key(0), 1,
                bounces, "list", estimator="parity", with_aux=True)
        assert not aux["overflow"]
        passes.append(metrics.COUNTS["query.passes"])

    held = _hold_fused_calls(frames.scene, render)
    assert held == {q: bounces for q in range(5)}
    assert bounces + 1 <= passes[0] <= 2 * (bounces + 1), passes


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
    """Each bounce of each batch of tiles (the frame's two tiles make one)
    opens nee.light and nee.env twice under its trace.bounce, once a
    phase ("rays", then "shade"); the list tracer's main passes are one
    for a batch's primaries and one fused call a bounce
    (COUNTS["parity.fused_queries"]), each under its trace.primary or
    trace.bounce; every pass, main or escalation, counts under
    COUNTS["query.passes"]."""
    bounces, batches = 2, 1
    metrics.reset_counts()
    with metrics.tracing() as spans:
        _port_frame(built, "small", bounces, 7, monkeypatch)
    by_id = {s[3]: s for s in spans}
    for name in ("nee.light", "nee.env"):
        mine = [s for s in spans if s[0] == name]
        assert len(mine) == 2 * bounces * batches
        for phase in ("rays", "shade"):
            assert sorted(s[7]["bounce"] for s in mine
                          if s[7]["phase"] == phase) == sorted(
                list(range(bounces)) * batches)
        for s in mine:
            parent = by_id[s[4]]
            assert parent[0] == "trace.bounce"
            assert parent[7]["bounce"] == s[7]["bounce"]
    calls = [s for s in spans if s[0] == "query"]
    assert sorted(by_id[s[4]][0] for s in calls) == sorted(
        ["trace.primary"] * batches + ["trace.bounce"] * bounces * batches)
    main = [s for s in spans if s[0] == "query.pass"
            and by_id[s[4]][0] == "query"]
    assert len(main) == batches * (bounces + 1)
    assert metrics.COUNTS["parity.fused_queries"] == batches * bounces
    assert metrics.COUNTS["render.batches"] == batches
    passes = sum(s[0] == "query.pass" for s in spans)
    assert metrics.COUNTS["query.passes"] == passes


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
