"""CPU tests of the benchmark harness.  Tests marked ``card`` need a CUDA
device and skip without one (decided inside the ``card`` fixture, never
at import).  Run them all with

    python -m pytest benchmark/tests -q -p no:cacheprovider -n 0
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
REPO = BENCH.parent

# the tests' size: every width and depth cut far below the cells'
TINY = {"standin_triangles": 2000, "sky": (16, 32), "width": 16,
        "height": 12, "bounces": 2, "tile_rays": 128}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny_config(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    cfg["mesh"]["standin_triangles"] = TINY["standin_triangles"]
    cfg["sky"]["height"], cfg["sky"]["width"] = TINY["sky"]
    for k in ("width", "height", "bounces", "tile_rays"):
        cfg[k] = TINY[k]
    return cfg


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of the benchmark's files in ``tmp_path/benchmark`` with every
    configuration cut to the tests' size, and BENCHMARK.json beside it."""
    root = tmp_path / "benchmark"
    for sub in ("traffic", "metrics"):
        shutil.copytree(BENCH / sub, root / sub)
    (root / "configs").mkdir()
    for p in (BENCH / "configs").glob("*.json"):
        cfg = tiny_config(json.loads(p.read_text()))
        (root / "configs" / p.name).write_text(json.dumps(cfg))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return root
