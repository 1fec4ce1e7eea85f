"""The port's spans and counters (utils/metrics.py: ``span``, ``tracing``,
``COUNTS``, ``host_read``) and the spans inside its hot path: what tracing
off records, nesting and ids, the per-thread stacks, the clock against
torch.profiler's, the blocking reads of the main path counted at each
site, and frames, gradients and launch counts bit-identical with tracing
on and off.  The tiny scene is the port's procedural dragon (2k
triangles, 16x32 sky) on the CPU."""

import dataclasses
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sycl_ray_tracing_tpu_torch.models import pathtracer as PP
from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
from sycl_ray_tracing_tpu_torch.ops import rng
from sycl_ray_tracing_tpu_torch.ops.kernels import listtrace
from sycl_ray_tracing_tpu_torch.parallel.mesh import make_mesh
from sycl_ray_tracing_tpu_torch.parallel.render import make_train_step
from sycl_ray_tracing_tpu_torch.utils import metrics
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_scene

# 16x16 in 2 tiles of 128 rays (one batch), 2 bounces, compacted
# (COMPACT_MIN_B 1)
FRAME = dict(width=16, height=16, samples=1, bounces=2, intersect="list",
             estimator="shared", tile_rays=128)
SITES = ("live_rays", "redo", "alive", "overflow")


@pytest.fixture(scope="module")
def scene():
    return dragon_scene(2_000, with_sky=True, sky_res=(16, 32),
                        device="cpu")


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s[0], []).append(s)
    return out


def _ancestors(spans, rec):
    """Names of the spans above ``rec``, innermost first."""
    by_id = {s[3]: s for s in spans}
    out = []
    while rec[4] is not None:
        rec = by_id[rec[4]]
        out.append(rec[0])
    return out


def test_span_off_is_the_shared_noop():
    assert metrics.span("a") is metrics.span("b", x=1)
    with metrics.tracing() as spans:
        pass
    with metrics.span("after"):
        pass
    assert spans == []
    assert not metrics._tracing


def test_spans_nest_with_parent_and_call_ids():
    with metrics.tracing() as spans:
        with metrics.span("render"):
            with metrics.span("render.batch", tile=0):
                with metrics.span("rng.draw"):
                    pass
            with metrics.span("render.batch", tile=1):
                pass
        with metrics.span("render"):
            pass
    by = _by_name(spans)
    first, second = by["render"]
    draw, = by["rng.draw"]
    t0, t1 = by["render.batch"]
    assert first[4] is None and second[4] is None
    assert first[5] != second[5]
    assert t0[4] == first[3] and t1[4] == first[3] and draw[4] == t0[3]
    assert {s[5] for s in (first, t0, t1, draw)} == {first[5]}
    assert t0[7] == {"tile": 0} and t1[7] == {"tile": 1}
    assert len({s[3] for s in spans}) == len(spans)
    for s in spans:
        assert s[1] <= s[2]
    assert first[1] <= t0[1] <= draw[1] <= draw[2] <= t0[2] <= t1[1] \
        <= t1[2] <= first[2] <= second[1]


def test_a_worker_thread_span_nests_under_the_waiting_span():
    """A span opened on a thread with no open span of its own, while a
    top-level span is open on another thread, takes that thread's
    innermost span as its parent (autograd's device thread replaying a
    bounce under train.backward)."""
    with metrics.tracing() as spans:
        with metrics.span("train.step"):
            with metrics.span("train.backward"):
                def work():
                    with metrics.span("trace.bounce", bounce=0):
                        with metrics.span("rng.draw"):
                            pass
                worker = threading.Thread(target=work)
                worker.start()
                worker.join(timeout=30)
                assert not worker.is_alive()
        with metrics.span("render"):
            pass
    by = _by_name(spans)
    backward, = by["train.backward"]
    bounce, = by["trace.bounce"]
    draw, = by["rng.draw"]
    step, = by["train.step"]
    assert bounce[4] == backward[3] and draw[4] == bounce[3]
    assert bounce[5] == draw[5] == step[5]
    assert bounce[6] == draw[6] != backward[6]
    assert by["render"][0][4] is None and by["render"][0][5] != step[5]


def test_span_clock_is_the_profilers():
    """A span around an op holds the op's torch.profiler record: both are
    on one clock."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with metrics.tracing() as spans:
            with metrics.span("op"):
                torch.ones(1000).sum()
    (_name, start, end, *_), = spans
    sums = [e for e in prof.profiler.kineto_results.events()
            if e.name() == "aten::sum"]
    assert sums
    for e in sums:
        assert start <= e.start_ns() <= e.end_ns() <= end


def _frame(scene, key=3):
    with torch.no_grad():
        return PP.render(scene, pbrt_dragon_camera("cpu"),
                         RenderConfig(**FRAME), rng.prng_key(key),
                         with_aux=True)


def test_host_reads_counted_at_each_site_and_frames_identical(
        scene, monkeypatch):
    """A tiny compacted, tiled frame: every blocking read is counted at
    its site, each once a query, a pass, a compacted bounce of its one
    batch (one width tried at 256 rays) and a frame; with tracing on, the
    same frame, the same counts, the same launches and one
    ``sync.<site>`` span a read."""
    monkeypatch.setattr(PP, "COMPACT_MIN_B", 1)
    out = {}
    for on in (False, True):
        metrics.reset_counts()
        listtrace.reset_launch_counts()
        if on:
            with metrics.tracing() as spans:
                img, aux = _frame(scene)
        else:
            img, aux = _frame(scene)
        out[on] = (img, aux, dict(metrics.COUNTS),
                   dict(listtrace.LAUNCHES))
    assert torch.equal(out[True][0], out[False][0])
    assert out[True][1:] == out[False][1:]
    counts = out[True][2]
    by = _by_name(spans)
    batches = 1
    assert counts["render.batches"] == batches
    assert counts["host_syncs.overflow"] == 1
    assert counts["host_syncs.alive"] == batches * FRAME["bounces"]
    assert counts["host_syncs.redo"] == len(by["query"]) \
        == batches * (1 + FRAME["bounces"])
    assert counts["host_syncs.live_rays"] == len(by["query.pass"])
    assert counts["host_syncs"] == sum(counts[f"host_syncs.{s}"]
                                       for s in SITES)
    for s in SITES:
        assert len(by[f"sync.{s}"]) == counts[f"host_syncs.{s}"]
    assert type(out[True][1]["overflow"]) is bool


def test_spans_of_a_frame_follow_its_layers(scene, monkeypatch):
    monkeypatch.setattr(PP, "COMPACT_MIN_B", 1)
    with metrics.tracing() as spans:
        _frame(scene)
    by = _by_name(spans)
    render, = by["render"]
    assert {s[5] for s in spans} == {render[5]}
    assert [s[7] for s in by["render.batch"]] == [{"tiles": 2,
                                                   "rays": 256}]
    expect = {
        "render.batch": ["render"],
        "trace.primary": ["render.batch", "render"],
        "bounce.compact": ["render.batch", "render"],
        "trace.bounce": ["render.batch", "render"],
        "query.escalate": ["query"],
        "query.build": ["query.pass", "query"],
        "query.kernel": ["query.pass", "query"],
        "sync.overflow": ["render"],
        "sync.alive": ["bounce.compact"],
        "sync.redo": ["query"],
    }
    for name, above in expect.items():
        for s in by.get(name, []):
            assert _ancestors(spans, s)[:len(above)] == above, name
    for s in by["query"]:
        assert _ancestors(spans, s)[0] in ("trace.primary", "trace.bounce")
    for s in by["query.pass"]:
        assert _ancestors(spans, s)[0] in ("query", "query.escalate")
    for s in by["rng.draw"]:
        assert _ancestors(spans, s)[0] in ("render.batch", "trace.bounce")
    assert [s[7]["bounce"] for s in by["trace.bounce"]] == [0, 1]
    assert {s[7]["kernel"] for s in by["query.kernel"]} <= {"block_tiles",
                                                            "list_tiles"}


def _train_step(scene):
    cfg = RenderConfig(width=8, height=8, samples=1, bounces=2,
                       intersect="list", estimator="shared", tile_rays=None)
    step = make_train_step(scene, cfg, make_mesh(1, 1), optimize_env=False)
    mats = scene.materials
    guess = dataclasses.replace(
        mats, diffuse=torch.clamp(mats.diffuse + 0.2, 0.0, 1.0))
    ys, xs = torch.meshgrid(torch.arange(8.0), torch.arange(8.0),
                            indexing="ij")
    return step(guess, None, mats, None, pbrt_dragon_camera("cpu"),
                xs.reshape(-1), ys.reshape(-1), rng.prng_key(5))


def test_backward_replays_nest_under_train_backward(scene, monkeypatch):
    """The trainer's step with a gradient on the materials: the
    checkpointed bounces replayed by torch.autograd.grad nest under
    train.backward, and replay no query and read nothing from the card;
    the loss and gradients are bit-identical with tracing on and off."""
    monkeypatch.setattr(PP, "COMPACT_MIN_B", 1)
    off = _train_step(scene)
    with metrics.tracing() as spans:
        on = _train_step(scene)
    assert torch.equal(on[0], off[0])
    for f in dataclasses.fields(on[1][0]):
        assert torch.equal(getattr(on[1][0], f.name),
                           getattr(off[1][0], f.name))
    by = _by_name(spans)
    step, = by["train.step"]
    assert {s[5] for s in spans} == {step[5]}
    for name in ("train.target", "train.guess", "train.backward"):
        assert _ancestors(spans, by[name][0]) == ["train.step"]
    replays = [s for s in by["trace.bounce"]
               if "train.backward" in _ancestors(spans, s)]
    assert len(replays) == 2
    for s in spans:
        if "train.backward" in _ancestors(spans, s):
            assert s[0] in ("trace.bounce", "rng.draw"), s[0]
