"""The parity estimator's cell (dragon870k_parity.preview) on the CPU at the
tests' size: its plain reference loads and holds the port's frames, its
bfloat16 control fails, the tiny cell runs correct, a trainer cell on its
configuration exits 2 before set-up, and its three readers read the span
pass (and nothing from a program without the NEE spans or pass counter)."""

from __future__ import annotations

import json
import sys
import time

import pytest
import torch

from benchmark import inputs as bench_inputs
from benchmark import loops, manifest, run
from benchmark.reference import estimators, pathtrace, rng

from conftest import tiny_config

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345
CELL = "dragon870k_parity.preview"


def _cell(name):
    spec = manifest.load()
    cell = manifest.cell(spec, name)
    cfg = tiny_config(bench_inputs.load_config(cell["config"]))
    return cfg, manifest.traffic(cell["traffic"])


def _rec(kind, out):
    return {"kind": kind, "call_s": [1.0, 1.2, 0.8], "busy_s": 0.5,
            "traced_calls": 2, "span_pass": out}


def test_the_parity_estimator_has_its_reference():
    """estimator "parity" is checked by reference/estimators/parity.py,
    which renders tiles and has no trainer."""
    parity = estimators.load("parity", needs=("render_tile",))
    assert parity.render_tile is not pathtrace.render_tile
    assert not hasattr(parity, "train_loss")


@pytest.mark.parametrize("seed", [1, SEED])
def test_parity_frames_pass_and_their_bfloat16_control_fails(seed):
    """The parity cell's frames at the tests' size read no pixel off
    its reference, and that reference in bfloat16 in their place reads
    more than the preview traffic's limit."""
    cfg, traffic = _cell(CELL)
    inputs = bench_inputs.scene_arrays(cfg)
    frames = loops.Frames(inputs, cfg, CPU)
    images = [frames.frame(rng.key_of_seed(seed), i)[0] for i in range(2)]
    ok = loops.frame_checks(inputs, cfg, traffic, seed, images, CPU)
    bad = loops.frame_checks(inputs, cfg, traffic, seed, images, CPU,
                             torch.bfloat16)
    assert ok == 0.0 and bad > traffic["limits"]["pixels_off"]


def test_the_parity_cell_runs_correct(tiny_root):
    """The parity cell's progressive loop at the tests' size: correct,
    with the preview cell's end-to-end metrics."""
    out = run.run_cell(json.loads((tiny_root.parent / "BENCHMARK.json")
                                  .read_text()),
                       CELL, SEED, 0.3, False, "cpu", time.perf_counter(),
                       root=tiny_root)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"render_mrays", "frame_s_p90", "setup_s"}
    assert out["checks"]["overflow_frames"]["value"] == 0


def test_a_parity_trainer_exits_2_before_setup(tiny_root, monkeypatch,
                                               capsys):
    """A trainer cell on dragon870k_parity: the parity reference has no
    train_loss, so the run exits 2 naming parity.py, before any set-up."""
    spec = json.loads((tiny_root.parent / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "parity.inverse",
                              "config": "dragon870k_parity",
                              "traffic": "inverse", "chips": 1, "why": "x"})

    def set_up(ctx):
        raise AssertionError("the cell's set-up began")

    monkeypatch.setattr(manifest, "load", lambda *a, **kw: spec)
    monkeypatch.setattr(manifest, "ROOT", tiny_root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for kind in loops.LOOPS:
        monkeypatch.setitem(loops.LOOPS, kind, set_up)
    rc = run.main(["--workload", "parity.inverse", "--seed", "5",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
    lines = out.err.strip().splitlines()
    assert len(lines) == 1
    assert "parity.py" in lines[0] and "train_loss" in lines[0]


def test_parity_readers_read_the_nee_spans_and_the_pass_counter(tiny_root):
    """idle_ms.nee.parity: the spans nee.light and nee.env's share of the
    pass's idle time times the idle of an unprofiled call (0.75 s);
    device_ms.nee.parity: their device seconds a call;
    list_passes.parity: COUNTS["query.passes"] a call.  A pass with
    neither span nor counter (a program without them) reads nothing."""
    out = {"calls": 2, "device_records": 10, "idle_s": 2.0,
           "idle_by_span": {"nee.light": 0.5, "nee.env": 0.25,
                            "trace.bounce": 1.0, "query": 0.25},
           "device_by_span": {"nee.light": 0.1, "nee.env": 0.2,
                              "rng.draw": 0.4},
           "counts_a_call": {"host_syncs": 900.0, "query.passes": 352.5}}
    want = {"idle_ms.nee.parity": 281.25, "device_ms.nee.parity": 150.0,
            "list_passes.parity": 352.5}
    older = dict(out, idle_by_span={"trace.bounce": 2.0},
                 device_by_span={"rng.draw": 0.4},
                 counts_a_call={"host_syncs": 900.0})
    for name, value in want.items():
        read = manifest.reader(name, tiny_root)
        assert read(_rec("render", out)) == pytest.approx(value), name
        assert read(_rec("train", out)) is None
        assert read(_rec("render", older)) is None, name


def test_the_parity_pass_at_the_tests_size(tiny_root, monkeypatch):
    """On the CPU the parity cell's pass counts its list-tracer passes, at
    least five a bounce and a tile (no device records, so no NEE time)."""
    monkeypatch.setattr(sys, "argv", [
        "run.py", "--workload", CELL, "--seed", "3000000001",
        "--seconds", "1", "--trace", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rec = {"kind": "render", "call_s": [1.0], "busy_s": 0.5,
           "traced_calls": 2, "traced_wall_s": 2.0, "breakdown": {}}
    passes = manifest.reader("list_passes.parity", tiny_root)(rec)
    assert passes >= 5 * 2 * 2
    for name in ("idle_ms.nee.parity", "device_ms.nee.parity"):
        assert manifest.reader(name, tiny_root)(rec) is None
