"""The port's native library: its own copies of the C++ sources (the SAH
builder and the OBJ parser), the same cluster order as the JAX package's,
and no path into the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

from sycl_ray_tracing_tpu import native as JN
from sycl_ray_tracing_tpu.ops import cluster as JC
from sycl_ray_tracing_tpu_torch import native
from sycl_ray_tracing_tpu_torch.ops import cluster as PC
from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_standin

REPO = Path(__file__).resolve().parents[1]
PORT_DIR = REPO / "sycl_ray_tracing_tpu_torch"
JAX_DIR = REPO / "sycl_ray_tracing_tpu"


def test_native_source_inside_the_port():
    for src, name in ((native.SOURCE, "bvh_builder.cpp"),
                      (native.OBJ_SOURCE, "obj_parser.cpp")):
        src = src.resolve()
        assert src.is_relative_to(PORT_DIR.resolve())
        # a copy, kept unchanged
        assert src.read_bytes() == (JAX_DIR / "native" / name).read_bytes()


def test_sah_order_matches_jax(tmp_path, monkeypatch):
    """The port's SAH order equals the JAX package's, each built from its
    own package's source.  Both are built with the port's flags (the JAX
    side into a temporary directory), so this compares the same source
    under the same flags and checks the Python glue around it.  The JAX
    Makefile's ``-march=native`` lets g++ contract FMAs, which can change
    the SAH splits: built that way on a host with FMA, the JAX order may
    differ from the port's."""
    lib = tmp_path / "libsrt_native.so"
    srcs = [str(JAX_DIR / "native" / f) for f in ("bvh_builder.cpp",
                                                  "obj_parser.cpp")]
    subprocess.run(["g++", *native.CXXFLAGS, "-o", str(lib), *srcs],
                   check=True, capture_output=True, timeout=300)
    monkeypatch.setattr(JN, "_LIB_PATH", str(lib))
    monkeypatch.setattr(JN, "_lib", None)
    monkeypatch.setattr(JN, "_load_failed", False)
    tris = dragon_standin(3_000)
    want = JC.sah_order(tris)
    assert want is not None
    np.testing.assert_array_equal(PC.sah_order(tris), want)


AUDIT = r"""
import importlib, os, pkgutil, sys, tempfile
from pathlib import Path

JAX_DIR = os.path.realpath(sys.argv[1]) + os.sep
seen = []

def _under_jax(p):
    if isinstance(p, int):
        return False
    return os.path.realpath(os.fsdecode(p)).startswith(JAX_DIR)

def hook(event, args):
    if event in ("open", "os.listdir", "os.scandir"):
        paths = [args[0]]
    elif event == "subprocess.Popen":
        paths = [args[0], *(args[1] or [])]
    else:
        return
    seen.extend(str(p) for p in paths if p is not None and _under_jax(p))

sys.addaudithook(hook)
import sycl_ray_tracing_tpu_torch as p
mods = [importlib.import_module(m.name)
        for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]
import chip_smoke
from sycl_ray_tracing_tpu_torch import native
from sycl_ray_tracing_tpu_torch.ops.cluster import sah_order
from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_standin

# a fresh build of the native library, then a cluster order and an OBJ
# parse (its C++ parser and the MTL next to it) from it
with tempfile.TemporaryDirectory() as build_dir:
    native.BUILD_DIR = Path(build_dir)
    native._lib = None
    tris = dragon_standin(500)
    assert sah_order(tris).size == tris.shape[0]
    from sycl_ray_tracing_tpu_torch.utils.obj_loader import parse_obj
    obj = Path(build_dir) / "t.obj"
    obj.write_text("mtllib t.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                   "usemtl a\nf 1 2 3\n")
    (Path(build_dir) / "t.mtl").write_text("newmtl a\nKd 1 0 0\n")
    assert parse_obj(str(obj)).material_indices.tolist() == [1]
# the kernel sources the module constants name (nvcc is not needed here)
for m in mods:
    for name, v in vars(m).items():
        for x in (v if isinstance(v, (list, tuple)) else [v]):
            if isinstance(x, Path) and _under_jax(x):
                seen.append(f"{m.__name__}.{name} = {x}")
assert not seen, seen
print("clean")
"""


def test_port_never_opens_the_jax_package():
    """No module of the port builds or opens a path under the JAX package:
    every port module imported, the native library (SAH builder and OBJ
    parser) built afresh and run, and
    every Path constant of the port's modules checked, with an audit hook
    on open / listdir / subprocess."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", AUDIT, str(JAX_DIR)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("clean")
