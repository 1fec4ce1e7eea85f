"""BENCHMARK.json against the benchmark's contract, and the harness's
being driven by data: a new cell, configuration and metric are new files
and entries, found by name."""

from __future__ import annotations

import json
import re
import time

import pytest
import torch

from benchmark import loops, manifest, run

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return manifest.load()


def test_names_units_and_keys(spec):
    assert spec["command"] == ["python3", "-m", "benchmark.run"]
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    metrics = spec["end_to_end"] + spec["per_layer"]
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in spec[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in spec["end_to_end"])
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200


def test_no_four_chip_cell(spec):
    assert all(w["chips"] == 1 for w in spec["workloads"])


def test_every_cell_reports_what_it_should(spec):
    e2e = {m["name"] for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        reported = {m["name"] for m in manifest.end_to_end(spec, w["name"])}
        assert "setup_s" in reported and len(reported) >= 2
        assert manifest.per_layer(spec, w["name"])
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"] and set(m["workloads"]) <= cells, m
        for cell in m["workloads"]:
            reported = manifest.end_to_end(spec, cell)
            assert m["moves"] in {e["name"] for e in reported}, (m, cell)


def test_every_metric_config_and_traffic_has_its_file(spec):
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(manifest.reader(m["name"]))
    for w in spec["workloads"]:
        manifest.traffic(w["traffic"])
    layers = {}
    for m in spec["per_layer"]:
        layers.setdefault(m["layer"], set()).add(m["name"])
    assert set(layers) == {"render entry", "estimator and shading",
                           "backward", "candidate build", "list-tracer host",
                           "kernels", "device"}


def test_a_new_cell_and_metric_need_no_code(tiny_root):
    """A dummy configuration, traffic mix, metric and cell, written as
    files and entries in a copy of the benchmark, run without a change to
    any file that was there."""
    cfg = json.loads((tiny_root / "configs" / "dragon870k_sky.json")
                     .read_text())
    cfg["name"] = "dummy_sky"
    cfg["mesh"]["seed"] = 7
    (tiny_root / "configs" / "dummy_sky.json").write_text(json.dumps(cfg))
    traffic = json.loads((tiny_root / "traffic" / "preview.json")
                         .read_text())
    traffic["check_tiles"] = 1
    (tiny_root / "traffic" / "dummy.json").write_text(json.dumps(traffic))
    (tiny_root / "metrics" / "dummy_calls.py").write_text(
        "def read(rec):\n    return float(rec['calls'])\n")
    spec = json.loads((tiny_root.parent / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy_sky",
                              "traffic": "dummy", "chips": 1, "why": "x"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "dragon870k.preview" in m["workloads"]:
            m["workloads"].append("dummy.cell")
    spec["end_to_end"].append({"name": "dummy_calls", "unit": "calls",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["dummy.cell"]})
    out = run.run_cell(spec, "dummy.cell", 5, 0.2, False, "cpu",
                       time.perf_counter(), root=tiny_root)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"render_mrays", "frame_s_p90", "setup_s",
                                   "dummy_calls"}
    assert out["metrics"]["dummy_calls"]["value"] == out["attempted"]


# a reference of a new estimator: the shared one, each call it takes
# recorded in a file beside it
DUMMY = """from pathlib import Path

from benchmark.reference import pathtrace

CALLS = Path(__file__).with_name("dummy.calls")


def _called(name):
    with CALLS.open("a") as f:
        f.write(name + "\\n")


def render_tile(*args):
    _called("render_tile")
    return pathtrace.render_tile(*args)


def train_loss(*args):
    _called("train_loss")
    return pathtrace.train_loss(*args)
"""


def _estimator_cell(tiny_root, estimator: str, traffic: str) -> dict:
    """BENCHMARK.json of the copy with a cell "new.cell" of the traffic mix
    ``traffic`` on a configuration whose estimator is ``estimator``, and
    that configuration's file written."""
    cfg = json.loads((tiny_root / "configs" / "dragon870k_sky.json")
                     .read_text())
    cfg["name"], cfg["estimator"] = "new_sky", estimator
    (tiny_root / "configs" / "new_sky.json").write_text(json.dumps(cfg))
    spec = json.loads((tiny_root.parent / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "new.cell", "config": "new_sky",
                              "traffic": traffic, "chips": 1, "why": "x"})
    like = {"preview": "dragon870k.preview",
            "inverse": "dragon870k.inverse"}[traffic]
    for m in spec["end_to_end"]:
        if like in m.get("workloads", []):
            m["workloads"].append("new.cell")
    return spec


def _files(root) -> dict:
    return {p: p.read_bytes() for p in root.parent.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("traffic,called", [("preview", "render_tile"),
                                            ("inverse", "train_loss")])
def test_a_new_estimator_needs_only_its_reference_file(tiny_root,
                                                       monkeypatch, traffic,
                                                       called):
    """A configuration whose estimator is "dummy", with its reference a new
    file reference/estimators/dummy.py in a copy of the benchmark: the
    cell's check goes through that file, and no file that was there
    changes.  The program knows no "dummy" estimator: patched, it renders
    one as "shared", to which the dummy reference delegates."""
    from sycl_ray_tracing_tpu_torch.utils import config

    before = _files(tiny_root)
    spec = _estimator_cell(tiny_root, "dummy", traffic)
    (tiny_root / "reference" / "estimators" / "dummy.py").write_text(DUMMY)
    real = config.RenderConfig

    def as_shared(**kw):
        if kw.get("estimator") == "dummy":
            kw["estimator"] = "shared"
        return real(**kw)

    monkeypatch.setattr(config, "RenderConfig", as_shared)
    out = run.run_cell(spec, "new.cell", 5, 0.2, False, "cpu",
                       time.perf_counter(), root=tiny_root)
    assert out["correct"], out["checks"]
    calls = (tiny_root / "reference" / "estimators" / "dummy.calls")
    assert called in calls.read_text().split()
    after = _files(tiny_root)
    assert all(after.get(p) == b for p, b in before.items())


@pytest.mark.parametrize("traffic,module", [("preview", None),
                                            ("inverse", "render_only")])
def test_an_estimator_without_its_reference_exits_2_before_setup(
        tiny_root, monkeypatch, capsys, traffic, module):
    """An estimator with no reference file, and a trainer cell whose
    estimator's reference has no train_loss: the run exits 2 with one line
    naming the file, before any set-up, and prints no result."""
    name = module or "nowhere"
    if module:
        (tiny_root / "reference" / "estimators" / f"{module}.py").write_text(
            "from benchmark.reference.pathtrace import render_tile\n")
    spec = _estimator_cell(tiny_root, name, traffic)

    def set_up(ctx):
        raise AssertionError("the cell's set-up began")

    monkeypatch.setattr(manifest, "load", lambda *a, **kw: spec)
    monkeypatch.setattr(manifest, "ROOT", tiny_root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for kind in loops.LOOPS:
        monkeypatch.setitem(loops.LOOPS, kind, set_up)
    rc = run.main(["--workload", "new.cell", "--seed", "5", "--seconds",
                   "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
    lines = out.err.strip().splitlines()
    assert len(lines) == 1
    assert f"{name}.py" in lines[0]
    if module:
        assert "train_loss" in lines[0]
