"""BENCHMARK.json and the files the harness finds by name in it:
configs/<config>.json, traffic/<traffic>.json and metrics/<metric>.py.
A new configuration, traffic mix or metric is a new file and an entry in
BENCHMARK.json; no code here names one."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def load(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "traffic" / f"{name}.json").read_text())


def end_to_end(spec: dict, name: str) -> list:
    """The end-to-end metrics the cell reports."""
    return [m for m in spec["end_to_end"]
            if name in m.get("workloads", [name])]


def per_layer(spec: dict, name: str) -> list:
    """The per-layer metrics read in the cell: those that list it."""
    return [m for m in spec["per_layer"] if name in m["workloads"]]


def reader(metric: str, root: Path = ROOT):
    """The ``read(record)`` function of metrics/<metric>.py."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: list, record: dict, root: Path = ROOT) -> dict:
    """{name: {"value", "unit"}} of each metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value = reader(m["name"], root)(record)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
