"""The supercluster candidate build's dispatch, counters and the fused
kernel's shape checks on the CPU, and on a card the kernel against its
plain torch version, bit for bit (cand, ctn, overflow, covered), and the
870k frame that takes it: its hierarchical lists against the dense
build, its passes and launches against the plain twins, and the frame
certified with its builds counted.

The card tests skip without CUDA; on a card:

    python -m pytest -o addopts="" -m card tests/test_torch_cand_build.py
"""

import types

import pytest
import torch

from sycl_ray_tracing_tpu_torch.ops import cluster as PC
from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace as PL
from sycl_ray_tracing_tpu_torch.probes import hier_build as HB
from sycl_ray_tracing_tpu_torch.utils import metrics
from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_standin
from torch_card import (  # noqa: F401
    assert_certified_hits_are_brute_force,
    card,
    held_launches,
    recorded_runs,
)

BUILDS = ("candidate_clusters_hier", "candidate_clusters_grouped",
          "candidate_clusters")


@pytest.fixture(scope="module")
def mesh():
    """The hierarchical test mesh on the CPU and the probe's rays."""
    scene = PC.build_clusters(dragon_standin(HB.MESH_TRIS), device="cpu")
    o, d, tl = (torch.tensor(a) for a in HB.mesh_rays())
    return scene, o, d, tl


def _fake_scene(k1: int):
    """Cluster tables of ``k1`` superclusters, only shaped."""
    return PC.ClusterScene(
        sc_box=torch.zeros((k1, 8)),
        cl_box_rows=torch.zeros((k1, 8 * PC.S_CLUSTER)),
        cl_box=torch.zeros((1, 8)), cl_tris=torch.zeros((1, 1)),
        cl_tri_idx=torch.zeros((1, 1), dtype=torch.int32))


@pytest.mark.parametrize("impl", [None, "plain"])
def test_cpu_and_plain_take_the_torch_version(mesh, monkeypatch, impl):
    """CPU tensors and impl="plain" build through _hier_rows."""
    scene, o, d, tl = mesh
    calls = []
    orig = PC._hier_rows
    monkeypatch.setattr(PC, "_hier_rows",
                        lambda *a: calls.append(1) or orig(*a))
    out = PC.candidate_clusters_hier(scene, o, d, tl, 16, 4, 32,
                                     grouped=True, exact=True, ray_cert=True,
                                     impl=impl)
    assert calls and len(out) == 4


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("impl", [None, "plain", "cuda"])
def test_dispatch_on_a_card(mesh, grouped, impl):
    """On CUDA tensors (a stand-in that says it is one) grouped builds
    take the kernel, per-ray builds and impl="plain" the torch version,
    and impl="cuda" on a per-ray build raises."""
    scene = mesh[0]
    on_card = types.SimpleNamespace(is_cuda=True)
    if impl == "cuda" and not grouped:
        with pytest.raises(ValueError, match="block lists"):
            PC._hier_plain(scene, on_card, 16, 4, 32, grouped, impl)
        return
    plain = PC._hier_plain(scene, on_card, 16, 4, 32, grouped, impl)
    assert plain == (impl == "plain" or not grouped)


def test_per_ray_build_takes_the_torch_version(mesh, monkeypatch):
    scene, o, d, tl = mesh
    calls = []
    orig = PC._hier_rows
    monkeypatch.setattr(PC, "_hier_rows",
                        lambda *a: calls.append(a[7]) or orig(*a))
    PC.candidate_clusters_hier(scene, o, d, tl, 8, 4, 8, exact=True)
    assert calls and not any(calls)       # grouped=False in every chunk


@pytest.mark.parametrize("impl", ["cuda", "triton", "Plain"])
def test_bad_impl_raises(mesh, impl):
    """A bad impl raises; impl="cuda" on CPU tensors raises too."""
    scene, o, d, tl = mesh
    match = "CUDA tensors" if impl == "cuda" else "bad impl"
    with pytest.raises(ValueError, match=match):
        PC.candidate_clusters_hier(scene, o, d, tl, 16, 4, 32, grouped=True,
                                   impl=impl)


@pytest.mark.parametrize("k1,maxc,maxs,group,what", [
    (129, 16, 4, 32, "superclusters"),
    (4, 129, 4, 32, "maxc"),
    (4, 0, 4, 32, "maxc"),
    (4, 16, 129, 32, "maxs"),
    (4, 16, 4, 64, "group"),
])
def test_kernel_shape_checks_raise(k1, maxc, maxs, group, what):
    """The kernel's shared arrays hold K1 <= 128 superclusters, maxs and
    maxc <= 128 slots and 32 rays a block: past them the wrapper raises,
    before it asks for CUDA tensors."""
    o = torch.zeros((group, 3))
    with pytest.raises(ValueError, match=what):
        PC.candidate_clusters_hier(_fake_scene(k1), o, o, torch.zeros(group),
                                   maxc, maxs, group, grouped=True,
                                   impl="cuda")


def test_build_counters_on_a_cpu_query(mesh, monkeypatch):
    """A CPU query's builds all take the torch code: COUNTS'
    "cand_build.plain" equals the builds the list tracer made (the
    supercluster build of the main pass, the dense build of the
    escalation), "cand_build.fused" stays 0, and reset_counts clears
    them."""
    scene, o, d, _tl = mesh
    monkeypatch.setattr(PL, "DEFAULT_MAXC_SHARE", 4)
    monkeypatch.setattr(PL, "HIER_MAXS", 1)
    made = {}
    for name in BUILDS:
        orig = getattr(PL, name)

        def record(*a, _orig=orig, _name=name, **kw):
            made[_name] = made.get(_name, 0) + 1
            return _orig(*a, **kw)
        monkeypatch.setattr(PL, name, record)
    metrics.reset_counts()
    PL.closest_hit(scene, o[:512], d[:512], share=True)
    assert made.get("candidate_clusters_hier", 0) >= 1
    assert metrics.COUNTS["cand_build.plain"] == sum(made.values())
    assert metrics.COUNTS.get("cand_build.fused", 0) == 0
    metrics.reset_counts()
    assert metrics.COUNTS["cand_build.plain"] == 0
    assert metrics.COUNTS.get("cand_build.fused", 0) == 0


def test_the_build_loads_its_kernel_without_the_list_tracer():
    """ops/cluster.py reaches its kernel through ops/kernels/cuda_lib.py,
    the loader below both it and the list tracer: importing it loads no
    list tracer, and the list tracer's library is the one it loads."""
    import subprocess
    import sys

    code = ("import sys; import sycl_ray_tracing_tpu_torch.ops.cluster; "
            "print('sycl_ray_tracing_tpu_torch.ops.kernels.listtrace' "
            "in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "False"
    from sycl_ray_tracing_tpu_torch.ops.kernels import cuda_lib

    assert PC.load_cuda_library is cuda_lib.load_cuda_library
    assert PL.load_cuda_library is cuda_lib.load_cuda_library


# ---- on a card ----

# what each mesh case must show of the rule it is there for
RULES = {
    "sc-overflow": lambda s: s["overflow"] and s["poisoned_rows"] > 0,
    "fits": lambda s: s["short_rows"] > 0 and s["full_rows"] > 0,
    "full": lambda s: s["dropped_rays_in_full_rows"] > 0
    and s["covered_rays"] > 0,
    "no-cert": lambda s: s["full_rows"] > 0,
    "inexact": lambda s: s["poisoned_rows"] > 0,
    "defaults": lambda s: s["dropped_rays_in_full_rows"] > 0,
    "sc-overflow-8": lambda s: s["poisoned_rows"] > 0
    and s["dropped_rays_in_full_rows"] > 0,
}


@pytest.fixture(scope="module")
def card_cases(card):
    return {label: (args, kw) for label, args, kw in HB.mesh_cases(card)}


@pytest.mark.card
@pytest.mark.parametrize("label", [c[0] for c in HB.CASES])
def test_fused_build_equals_plain_on_the_mesh(card_cases, label):
    """Each mesh case (dead rays and a dead block, non-finite rays, SC
    overflow, short / full / poisoned rows, dropped columns) through the
    kernel, bit for bit the plain version's; one launch counted."""
    args, kw = card_cases[label]
    before = metrics.COUNTS.get("cand_build.fused", 0)
    out_p, diff = HB.hold(args, kw)
    assert not diff, f"{label}: {diff} differ"
    assert metrics.COUNTS["cand_build.fused"] == before + 1
    seen = HB.rules(out_p, args[6])
    assert seen["empty_rows"] >= 1, seen
    assert RULES[label](seen), seen


@pytest.fixture(scope="module")
def bounce870k(card):
    """The 870k stand-in, one tile's supercluster builds at one bounce
    (HB.bounce_builds, largest first) and the tile's first passes."""
    with recorded_runs() as runs:
        scene, made = HB.bounce_builds(card)
    return dict(scene=scene, made=made, runs=runs)


@pytest.mark.card
def test_fused_build_equals_plain_on_the_870k_first_bounce(bounce870k):
    """The 870k stand-in's supercluster builds of one tile at one bounce
    (the primary rays' and the first bounce's fused query, at the main
    pass's shapes) through the kernel, bit for bit the plain version's."""
    made = bounce870k["made"]
    assert made[0][0][4:] == (PL.DEFAULT_MAXC_SHARE, 42, PL.RB_SHARE)
    for args, kw in made:
        _out_p, diff = HB.hold(args, kw)
        assert not diff, f"{args[1].shape[0]} rays: {diff} differ"


@pytest.mark.card
def test_run_equals_plain_on_the_870k_first_bounce(bounce870k):
    """_run on the first bounce's fused query, kernels against twins."""
    *args, kw = bounce870k["runs"][1]
    outs = [PL._run(*args, **dict(kw, impl=impl))
            for impl in (None, "plain")]
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.card
def test_certified_hits_equal_brute_force_at_870k(bounce870k):
    """On a subset of the tile's primary rays."""
    o, d = (x[::256] for x in bounce870k["runs"][0][1:3])
    assert_certified_hits_are_brute_force(bounce870k["scene"], o, d)


@pytest.mark.card
def test_hierarchical_lists_agree_with_dense_at_870k(bounce870k):
    """The first bounce's supercluster build (its fused query's block
    lists) against the dense build of the same rays, on the lists
    without SC overflow: the same live counts, the same candidates where
    the dense list fits, entry-t within the coarser id-bit key's
    quantum."""
    (cs, o, d, tl, maxc, maxs, group), kw = bounce870k["made"][0]
    hc, ctn = PC.candidate_clusters_hier(cs, o, d, tl, maxc, maxs, group,
                                         **kw)[:2]
    dc, dt = PC.candidate_clusters_grouped(cs, o, d, tl, maxc, group,
                                           exact=True, ray_cert=True)[:2]
    ok = ctn[:, -1] >= 0
    assert torch.equal((hc >= 0).sum(1)[ok], (dc >= 0).sum(1)[ok])
    fits = ok & (dc[:, -1] < 0)
    assert fits.any()
    assert torch.equal(hc[fits].sort(1).values, dc[fits].sort(1).values)
    bits = max(PC._id_bits(maxs * PC.S_CLUSTER),
               PC._id_bits(cs.num_clusters))
    live = (dc >= 0) & ok[:, None]
    assert ((ctn - dt).abs()[live]
            <= 2.0 ** (bits - 23) * torch.maximum(ctn, dt)[live]).all()


@pytest.mark.card
def test_870k_frame_on_the_card(bounce870k):
    """The 512x512 frame at 8 bounces: every list-kernel launch equals its
    plain twin's bit for bit, block lists poisoned by SC overflow among
    them; then, counted, the frame is certified and finite, peaks under
    20 GiB, and makes one fused supercluster build a block_tiles launch
    and one torch build an escalation's list_tiles launch."""
    from sycl_ray_tracing_tpu_torch.models import pathtracer as pt
    from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
    from sycl_ray_tracing_tpu_torch.ops import rng
    from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig

    scene = bounce870k["scene"]
    cam = pbrt_dragon_camera(scene.device)
    cfg = RenderConfig(512, 512, samples=1, bounces=8, intersect="list",
                       estimator="shared", tile_rays=32768)
    key = rng.prng_key(0)
    with torch.no_grad():
        with held_launches() as held:
            pt.render(scene, cam, cfg, key)
        for name, launches in held.items():
            assert launches and all(x["same"] for x in launches), name
        assert any(x["poisoned"] for x in held["block_tiles"])
        PL.reset_launch_counts()
        metrics.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        img, aux = pt.render(scene, cam, cfg, key, with_aux=True)
        torch.cuda.synchronize()
    assert not aux["overflow"] and torch.isfinite(img).all()
    assert float(img.mean()) > 1e-4
    assert torch.cuda.max_memory_allocated() <= 20 << 30
    fused = metrics.COUNTS.get("cand_build.fused", 0)
    assert fused >= 1 and fused == PL.LAUNCHES["block_tiles"]
    assert metrics.COUNTS.get("cand_build.plain", 0) == \
        PL.LAUNCHES["list_tiles"] >= 1
