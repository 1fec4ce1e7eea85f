"""The plain reference of each estimator, one module a name: a
configuration's ``"estimator"`` is checked by
``<root>/reference/estimators/<estimator>.py``, found by path as
``manifest.reader`` finds metrics/<metric>.py, so a copy of the
benchmark finds its own.  A module exposes

    render_tile(scene, frame_key, tile, tile_rays, width, height, bounces)

(the tile's HDR, [tile_rays, 3]) and, to check a trainer cell,

    train_loss(scene, diffuse, roughness, key, width, height, bounces,
               tie_high)

(the loss and the ties its renders met), both on a ``pathtrace.Scene``:
the geometry, its tie rules and its tie counting are every estimator's.
A new estimator's reference is one new file here; no code names one.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

from benchmark.manifest import ROOT


class Missing(LookupError):
    """An estimator with no reference file, or whose reference lacks a
    function the cell's check calls."""


def load(name: str, root: Path = ROOT, needs=()):
    """The module of ``<root>/reference/estimators/<name>.py``.  Raises
    Missing, naming the file, where there is none or where it lacks one
    of the functions ``needs`` names."""
    path = Path(root) / "reference" / "estimators" / f"{name}.py"
    if not path.is_file():
        raise Missing(f"estimator {name!r} has no reference: {path} is "
                      "missing")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_estimator_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lacking = [f for f in needs if not callable(getattr(mod, f, None))]
    if lacking:
        raise Missing(f"estimator {name!r}: {path} has no "
                      f"{', '.join(lacking)}")
    return mod
