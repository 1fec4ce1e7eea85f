"""BENCHMARK.json against the benchmark's contract, and the harness's
being driven by data: a new cell, configuration and metric are new files
and entries, found by name."""

from __future__ import annotations

import json
import re
import time

import pytest

from benchmark import manifest, run

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
    assert set(layers) == {"device", "kernels", "candidate build",
                           "list-tracer host"}


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
