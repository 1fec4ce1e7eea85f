"""Native binned-SAH builder and OBJ geometry parser, loaded with ctypes
(counterpart of sycl_ray_tracing_tpu/native/__init__.py).

The C++ sources are this package's own ``csrc/bvh_builder.cpp`` and
``csrc/obj_parser.cpp``, copies of the JAX package's
``native/bvh_builder.cpp`` and ``native/obj_parser.cpp`` kept unchanged.
At first use they are compiled with g++ (CXXFLAGS: no FMA contraction)
into one library in this package's ``build/`` directory (which
.gitignore lists).  Built so, both
sources give the same cluster order; the JAX package's Makefile builds
with ``-march=native``, whose FMA contraction can change the SAH splits
on a host with FMA, so its order may differ from this one.  A build failure
raises: the cluster build never falls back to Morton order unless the
caller asks for ``order="morton"``, and the OBJ loader never falls back
to its Python parser unless the caller asks for ``use_native=False``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PKG_DIR / "build"
SOURCE = PKG_DIR / "csrc" / "bvh_builder.cpp"
OBJ_SOURCE = PKG_DIR / "csrc" / "obj_parser.cpp"
# no -march=native: the SAH split choices must not depend on the host's
# FMA contraction, so every machine builds the same cluster order
CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++20", "-ffp-contract=off"]

_lib = None


def build_shared_library(sources, out_prefix: str, compiler: list,
                         flags: list, headers=()) -> Path:
    """Compile ``sources`` into BUILD_DIR/<prefix>_<hash>.so, once per
    content hash of sources, the ``headers`` they include, and flags.  The
    library is written under a temporary name and renamed into place, so
    concurrent builders (test workers) never load a half-written file.
    Raises on failure."""
    h = hashlib.sha256()
    for src in list(sources) + list(headers):
        h.update(Path(src).read_bytes())
    h.update(" ".join(compiler + flags).encode())
    out = BUILD_DIR / f"{out_prefix}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = compiler + flags + ["-o", tmp] + [str(s) for s in sources]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"build of {out.name} failed ({' '.join(cmd)}):\n"
                f"{res.stdout}{res.stderr}"
            )
        (BUILD_DIR / f"{out.stem}.log").write_text(res.stdout + res.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """Build (at first use) and load the SAH builder and the OBJ parser;
    raises on failure."""
    global _lib
    if _lib is None:
        for src in (SOURCE, OBJ_SOURCE):
            if not src.exists():
                raise FileNotFoundError(f"native source missing: {src}")
        path = build_shared_library([SOURCE, OBJ_SOURCE], "libsrt_native",
                                    ["g++"], CXXFLAGS)
        lib = ctypes.CDLL(str(path))
        lib.bvh_build.restype = ctypes.c_int32
        lib.bvh_build.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.bvh_flatten.restype = ctypes.c_int32
        lib.bvh_flatten.argtypes = [ctypes.c_void_p] * 3
        lib.obj_parse.restype = ctypes.c_int32
        lib.obj_parse.argtypes = [ctypes.c_char_p] + [
            ctypes.POINTER(ctypes.c_int32)] * 3
        lib.obj_fetch.restype = ctypes.c_int32
        lib.obj_fetch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_char_p]
        _lib = lib
    return _lib


def sah_build(triangles: np.ndarray, leaf_size: int = 4):
    """Binned-SAH build.  Returns (nodes_box [M,8] f32, nodes_meta [M,4]
    i32, slot_order [num_leaves*leaf_size] i32); raises on failure."""
    lib = load()
    tris = np.ascontiguousarray(triangles, np.float32).reshape(-1, 9)
    num_nodes = ctypes.c_int32(0)
    num_leaves = ctypes.c_int32(0)
    rc = lib.bvh_build(tris.ctypes.data, tris.shape[0], leaf_size,
                       ctypes.byref(num_nodes), ctypes.byref(num_leaves))
    if rc != 0:
        raise RuntimeError(f"bvh_build failed with code {rc}")
    m, k = num_nodes.value, num_leaves.value
    nodes_box = np.zeros((m, 8), np.float32)
    nodes_meta = np.zeros((m, 4), np.int32)
    slot_order = np.zeros((k * leaf_size,), np.int32)
    rc = lib.bvh_flatten(nodes_box.ctypes.data, nodes_meta.ctypes.data,
                         slot_order.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"bvh_flatten failed with code {rc}")
    return nodes_box, nodes_meta, slot_order


def parse_obj_geometry(path: str):
    """OBJ geometry parse (native/__init__.py:103-127).  Returns
    (triangles [N,3,3] f32, material_slot [N] i32 (-1: no usemtl),
    slot_names list[str] in usemtl order); raises on failure."""
    lib = load()
    n_tris = ctypes.c_int32(0)
    n_names = ctypes.c_int32(0)
    names_bytes = ctypes.c_int32(0)
    rc = lib.obj_parse(os.fsencode(path), ctypes.byref(n_tris),
                       ctypes.byref(n_names), ctypes.byref(names_bytes))
    if rc != 0:
        raise OSError(f"obj_parse failed with code {rc} on {path}")
    n = n_tris.value
    tris = np.zeros((n, 9), np.float32)
    mats = np.zeros((n,), np.int32)
    names_buf = ctypes.create_string_buffer(max(1, names_bytes.value))
    rc = lib.obj_fetch(tris.ctypes.data, mats.ctypes.data, names_buf)
    if rc != 0:
        raise RuntimeError(f"obj_fetch failed with code {rc}")
    raw = names_buf.raw[: names_bytes.value]
    names = [s.decode("utf-8", "replace") for s in raw.split(b"\0") if s]
    return tris.reshape(n, 3, 3), mats, names
