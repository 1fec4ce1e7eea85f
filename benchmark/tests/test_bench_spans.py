"""The span pass (benchmark/spans.py): its attribution on synthetic
records, its readers, a program without spans, the pass itself at the
tests' size on the CPU, and on a card the clock the program's spans and
the profiler's records share."""

from __future__ import annotations

import sys

import pytest
import torch

from benchmark import manifest, spans

MS = 1_000_000      # ns


def _span(name, start, end, sid, parent, thread=1, call=1, **attrs):
    return (name, start * MS, end * MS, sid, parent, call, thread, attrs)


def _dev(start, end, corr, name="k", stream=7):
    return (start * MS, end * MS, name, corr, stream)


def test_each_kernel_goes_to_the_span_that_launched_it_and_idle_sums():
    """One call [0, 110] ms: render > trace.bounce > (rng.draw, query >
    sync.redo).  Kernels launched in rng.draw, query and render's own
    time go there; one record with no launch is reported, not dropped.
    The idle intervals split over the innermost spans sum to the union's
    idle, time past the last span to the entry."""
    sp = [_span("render", 0, 100, 1, None),
          _span("trace.bounce", 10, 50, 2, 1, bounce=0, width=8),
          _span("rng.draw", 12, 20, 3, 2),
          _span("query", 25, 45, 4, 2, rays=8),
          _span("sync.redo", 40, 45, 5, 4)]
    device = [_dev(15, 30, 1), _dev(30, 38, 2), _dev(60, 70, 99),
              _dev(80, 90, 4)]
    launches = {1: (15 * MS, 1), 2: (26 * MS, 1), 4: (80 * MS, 1)}
    out = spans.attribute(sp, device, launches, [(0, 110 * MS)])
    assert out["device_by_span"] == pytest.approx(
        {"rng.draw": 0.015, "query": 0.008, "render": 0.010,
         spans.UNMATCHED: 0.010})
    assert out["unmatched_records"] == 1
    assert out["matched_share"] == pytest.approx(33 / 43)
    assert out["idle_s"] == pytest.approx(0.067)
    assert out["raw_idle_s"] == pytest.approx(0.067)
    assert out["idle_split_s"] == pytest.approx(out["idle_s"])
    assert out["idle_by_span"] == pytest.approx(
        {"render": 0.040, "trace.bounce": 0.007, "rng.draw": 0.003,
         "query": 0.002, "sync.redo": 0.005, spans.NONE: 0.010})
    assert out["idle_by_group"] == pytest.approx(
        {"entry": 0.050, "shading": 0.007, "rng": 0.003, "query": 0.002,
         "sync": 0.005})
    assert sum(out["idle_by_group"].values()) == pytest.approx(0.067)
    assert out["device_by_group"] == pytest.approx(
        {"rng": 0.015, "query": 0.008, "entry": 0.010, "unmatched": 0.010})
    assert out["early_launches"] == 0 and out["calls"] == 1
    assert out["device_by_op"] == [["rng", "k", pytest.approx(0.015)],
                                   ["entry", "k", pytest.approx(0.010)],
                                   ["query", "k", pytest.approx(0.008)]]


def test_threads_and_the_backward():
    """Autograd's thread (2) replays a bounce under train.backward, open
    on the main thread (1): its launches inside the replay go to the
    replay, its launches between replays to train.backward; a launch from
    a thread with no span goes to the innermost span open anywhere.
    Every record launched while train.backward is open is the
    backward's, and so is the idle along it."""
    sp = [_span("train.step", 0, 100, 1, None),
          _span("train.backward", 10, 90, 2, 1),
          _span("trace.bounce", 20, 40, 3, 2, thread=2),
          _span("rng.draw", 21, 23, 4, 3, thread=2)]
    device = [_dev(1, 6, 1), _dev(26, 30, 2), _dev(50, 60, 3),
              _dev(32, 36, 4), _dev(95, 99, 5)]
    launches = {1: (1 * MS, 1), 2: (25 * MS, 2), 3: (50 * MS, 2),
                4: (31 * MS, 7), 5: (94 * MS, 1)}
    out = spans.attribute(sp, device, launches, [(0, 100 * MS)])
    assert out["device_by_span"] == pytest.approx(
        {"train.step": 0.009, "trace.bounce": 0.008,
         "train.backward": 0.010})
    assert out["own_thread_launches"] == 3
    assert out["backward_device_s"] == pytest.approx(0.018)
    # idle along train.backward [10, 90]: [10, 26], [30, 32], [36, 50],
    # [60, 90]
    assert out["backward_idle_s"] == pytest.approx(0.062)
    assert out["idle_split_s"] == pytest.approx(out["idle_s"])


def test_a_kernel_before_its_launch_is_counted():
    sp = [_span("render", 0, 10, 1, None)]
    device = [_dev(2, 3, 1), _dev(2, 3, 2)]
    launches = {1: (2 * MS + spans.EARLY_NS, 1),
                2: (2 * MS + spans.EARLY_NS + 1, 1)}
    out = spans.attribute(sp, device, launches, [(0, 10 * MS)])
    assert out["early_launches"] == 1


def test_records_are_placed_on_the_host_clock():
    """The device records keep their durations but take their places from
    the host: on a stream, in launch order, each at the later of its
    launch and the end of the one before it; a record with no launch keeps
    its own times.  Idle is read from the placed records."""
    sp = [_span("render", 0, 12, 1, None),
          _span("rng.draw", 0, 2, 2, 1), _span("query", 2, 12, 3, 1)]
    device = [_dev(0.5, 2.5, 1), _dev(3, 4, 2), _dev(10, 11, 99),
              _dev(0, 1, 3, stream=8)]
    launches = {1: (1 * MS, 1), 2: (1.5 * MS, 1), 3: (0.5 * MS, 1)}
    assert spans.replay(device, launches) == [
        (1 * MS, 3 * MS), (3 * MS, 4 * MS), (10 * MS, 11 * MS),
        (0.5 * MS, 1.5 * MS)]
    out = spans.attribute(sp, device, launches, [(0, 12 * MS)])
    assert out["early_launches"] == 2
    # placed busy [0.5, 4] and [10, 11]: idle [0, 0.5], [4, 10], [11, 12]
    assert out["idle_s"] == pytest.approx(0.0075)
    assert out["idle_by_span"] == pytest.approx(
        {"rng.draw": 0.0005, "query": 0.007})
    # as recorded: busy [0, 2.5], [3, 4], [10, 11]
    assert out["raw_idle_s"] == pytest.approx(0.0075)


def _rec(kind, out):
    return {"kind": kind, "call_s": [1.0, 1.2, 0.8], "busy_s": 0.5,
            "traced_calls": 2, "span_pass": out}


def test_readers_scale_idle_to_an_unprofiled_call(tiny_root):
    """idle_ms.*: a layer's share of the pass's idle time times the idle
    of an unprofiled call (mean window call 1.0 s less 0.25 s busy);
    device_ms.*: device seconds a call; host_syncs.*: the counter a
    call; a reader of the other kind reads nothing."""
    out = {"calls": 2, "device_records": 10, "idle_s": 2.0,
           "idle_by_group": {"rng": 0.5, "shading": 0.25, "query": 1.0,
                             "entry": 0.25},
           "device_by_group": {"rng": 0.1, "shading": 0.2, "query": 0.4},
           "backward_idle_s": 0.4, "backward_device_s": 0.6,
           "counts_a_call": {"host_syncs": 260.0}}
    want = {"idle_ms.rng.render": 187.5, "idle_ms.shading.render": 93.75,
            "idle_ms.query.render": 375.0, "device_ms.shading.render": 150.0,
            "host_syncs.render": 260.0}
    for name, value in want.items():
        read = manifest.reader(name, tiny_root)
        assert read(_rec("render", out)) == pytest.approx(value), name
        assert read(_rec("train", out)) is None
    want = {"idle_ms.backward.train": 150.0,
            "device_ms.backward.train": 300.0, "host_syncs.train": 260.0}
    for name, value in want.items():
        read = manifest.reader(name, tiny_root)
        assert read(_rec("train", out)) == pytest.approx(value), name
        assert read(_rec("render", out)) is None


def _traced_argv(monkeypatch, cell):
    monkeypatch.setattr(sys, "argv", [
        "run.py", "--workload", cell, "--seed", "3000000001",
        "--seconds", "1", "--trace", "1"])


def test_a_program_without_spans_reads_nothing(tiny_root, monkeypatch):
    from sycl_ray_tracing_tpu_torch.utils import metrics

    _traced_argv(monkeypatch, "dragon870k.preview")
    monkeypatch.delattr(metrics, "tracing")
    rec = {"kind": "render", "call_s": [1.0], "busy_s": 0.5,
           "traced_calls": 2, "breakdown": {}}
    for name in ("idle_ms.rng.render", "device_ms.shading.render",
                 "host_syncs.render"):
        assert manifest.reader(name, tiny_root)(rec) is None
    assert rec["span_pass"] is None and rec["breakdown"] == {}


@pytest.mark.parametrize("cell, kind", [("dragon870k.preview", "render"),
                                        ("dragon870k.inverse", "train")])
def test_the_pass_at_the_tests_size(tiny_root, monkeypatch, capsys, cell,
                                    kind):
    """On the CPU the pass records the program's spans and counters (no
    device records, so no device or idle number) and adds its summary to
    the breakdown."""
    _traced_argv(monkeypatch, cell)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = {"kind": kind, "call_s": [1.0], "busy_s": 0.5, "traced_calls": 2,
           "traced_wall_s": 2.0, "breakdown": {}}
    syncs = manifest.reader(f"host_syncs.{kind}", tiny_root)(rec)
    assert syncs > 0
    out = rec["span_pass"]
    assert out["calls"] == 2 and out["spans_a_call"] > syncs
    assert out["device_records"] == 0 and out["matched_share"] is None
    assert set(rec["breakdown"]) == {"idle_by_span", "device_by_span",
                                     "device_ops_by_layer", "span_pass"}
    assert "span pass:" in capsys.readouterr().err
    idle = f"idle_ms.{'rng.render' if kind == 'render' else 'backward.train'}"
    assert manifest.reader(idle, tiny_root)(rec) is None


def test_span_clock_on_the_card(card):
    """On the card: a small frame's spans and the profiler's host records
    on one clock (every blocking read's span holds the start of its CUDA
    API record, each launch falls inside its call), every device record
    has its launch record, the split idle equals the placed records'
    union's, and the list tracer's, the shading's and the RNG's kernels
    are charged to their layers."""
    from sycl_ray_tracing_tpu_torch.models import pathtracer
    from sycl_ray_tracing_tpu_torch.models.camera import pbrt_dragon_camera
    from sycl_ray_tracing_tpu_torch.ops.rng import prng_key
    from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig
    from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_scene

    scene = dragon_scene(2_000, with_sky=True, sky_res=(16, 32),
                         device=card)
    cfg = RenderConfig(width=64, height=64, samples=1, bounces=2,
                       intersect="list", estimator="shared", tile_rays=2048)

    def frame(i):
        with torch.no_grad():
            return pathtracer.render(scene, pbrt_dragon_camera(card), cfg,
                                     prng_key(i)).cpu()

    frame(100)
    rec = spans.span_pass(frame, range(2), card)
    out = spans.attribute(rec["spans"], rec["device"], rec["launches"],
                          rec["calls"])
    assert out["device_records"] > 0
    assert out["matched_share"] >= 0.99, out
    assert out["sync_spans_holding_api"] == 1.0, out
    assert abs(out["idle_split_s"] - out["idle_s"]) <= 0.01 * out["idle_s"]
    hosts = [rec["launches"][r[3]][0] for r in rec["device"]
             if r[3] in rec["launches"]]
    assert all(any(c0 <= h <= c1 for c0, c1 in rec["calls"])
               for h in hosts)
    assert out["device_by_group"].get("query", 0) > 0
    assert out["device_by_group"].get("shading", 0) > 0
    assert out["device_by_group"].get("rng", 0) > 0
