"""Wavefront OBJ + MTL scene loader (counterpart of
sycl_ray_tracing_tpu/utils/obj_loader.py; numpy host-side parsing).

Capability parity with the reference's rapidobj-based loader
(utils.cpp:16-98):
  * all shapes flattened into one triangle buffer, polygons triangulated
  * per-triangle material indices with a +1 offset — material row 0 is the
    magenta debug material, unmatched faces map to it (utils.cpp:53-56,75)
  * emissive triangle indices collected where Ke > 0 (utils.cpp:58-69)
  * materials built from Kd / Ke / Pm (metallic) / Pr (roughness) OBJ-PBR
    extensions (utils.cpp:73-95)
  * roughness clamped >= 1e-2 (utils.cpp:82)
  * illum == 0 => fall back to default roughness/metalness (utils.cpp:84-92)

The geometry goes through the port's native C++ parser
(csrc/obj_parser.cpp, built at first use; a failed build raises) unless
the caller asks for the pure-Python parser with ``use_native=False``;
both give the same arrays.  The scene's tensors go on the card unless
the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from sycl_ray_tracing_tpu_torch.utils.device import resolve_device

DEFAULT_ROUGHNESS = 1.0
DEFAULT_METALNESS = 0.0


@dataclass
class ParsedOBJ:
    """Host-side SoA mirror of the reference ParsedOBJ (parsed_obj.h:9-16)."""

    triangles: np.ndarray          # [N,3,3] float32
    material_indices: np.ndarray   # [N] int32 (0 = debug material)
    emissive_indices: np.ndarray   # [K] int32
    # material SoA, row 0 = debug material
    emission: np.ndarray           # [M,3]
    diffuse: np.ndarray            # [M,3]
    metalness: np.ndarray          # [M]
    roughness: np.ndarray          # [M]
    material_names: List[str] = field(default_factory=list)


def _parse_mtl(path: str):
    """Parse an MTL file -> list of material dicts in declaration order."""
    materials: List[Dict] = []
    cur: Dict | None = None
    if not os.path.exists(path):
        return materials
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "newmtl":
                cur = {
                    "name": parts[1] if len(parts) > 1 else "",
                    "Kd": (0.8, 0.8, 0.8),
                    "Ke": (0.0, 0.0, 0.0),
                    "Pm": DEFAULT_METALNESS,
                    "Pr": DEFAULT_ROUGHNESS,
                    "illum": 0,
                }
                materials.append(cur)
            elif cur is None:
                continue
            elif tag == "Kd":
                cur["Kd"] = tuple(float(v) for v in parts[1:4])
            elif tag == "Ke":
                cur["Ke"] = tuple(float(v) for v in parts[1:4])
            elif tag == "Pm":
                cur["Pm"] = float(parts[1])
            elif tag == "Pr":
                cur["Pr"] = float(parts[1])
            elif tag == "illum":
                cur["illum"] = int(parts[1])
    return materials


def _scan_mtllibs(path: str) -> List[str]:
    """Collect mtllib paths referenced by an OBJ (cheap line scan)."""
    base_dir = os.path.dirname(os.path.abspath(path))
    libs = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("mtllib"):
                libs.append(os.path.join(base_dir, line[6:].strip()))
    return libs


def _material_table(mtl_materials: List[Dict]):
    """Material SoA with the magenta debug material at row 0 and the
    reference's clamp/illum rules (utils.cpp:73-95)."""
    M = len(mtl_materials) + 1
    emission = np.zeros((M, 3), np.float32)
    diffuse = np.zeros((M, 3), np.float32)
    metalness = np.zeros((M,), np.float32)
    roughness = np.ones((M,), np.float32)
    emission[0] = (1.0, 0.0, 1.0)
    names = ["__default__"]
    for i, m in enumerate(mtl_materials):
        row = i + 1
        emission[row] = m["Ke"]
        diffuse[row] = m["Kd"]
        if m["illum"] == 0:
            metalness[row] = DEFAULT_METALNESS
            roughness[row] = DEFAULT_ROUGHNESS
        else:
            metalness[row] = m["Pm"]
            roughness[row] = max(1e-2, m["Pr"])
        names.append(m["name"])
    return emission, diffuse, metalness, roughness, names


def _finalize(triangles, material_indices, table) -> ParsedOBJ:
    emission, diffuse, metalness, roughness, names = table
    tri_emission = emission[material_indices]
    # the magenta debug material (row 0) is NOT a light source — the
    # reference only collects triangles whose MTL has Ke>0 (utils.cpp:58-69)
    is_light = (tri_emission > 0.0).any(axis=-1) & (material_indices > 0)
    return ParsedOBJ(
        triangles=np.ascontiguousarray(triangles, np.float32),
        material_indices=material_indices,
        emissive_indices=np.nonzero(is_light)[0].astype(np.int32),
        emission=emission,
        diffuse=diffuse,
        metalness=metalness,
        roughness=roughness,
        material_names=names,
    )


def parse_obj_native(path: str) -> ParsedOBJ:
    """C++ geometry parse (csrc/obj_parser.cpp) + python MTL parse."""
    from sycl_ray_tracing_tpu_torch import native

    triangles, mat_slots, slot_names = native.parse_obj_geometry(path)
    mtl_materials: List[Dict] = []
    name_to_id: Dict[str, int] = {}
    for lib in _scan_mtllibs(path):
        for m in _parse_mtl(lib):
            name_to_id[m["name"]] = len(mtl_materials)
            mtl_materials.append(m)
    table = _material_table(mtl_materials)
    # usemtl slot -> MTL declaration id -> +1 material row (0 = debug)
    slot_to_row = np.array(
        [name_to_id.get(n, -1) + 1 for n in slot_names] + [0], np.int32
    )
    material_indices = slot_to_row[
        np.where(mat_slots >= 0, mat_slots, len(slot_names))
    ]
    return _finalize(triangles, material_indices, table)


def parse_obj(path: str, use_native: bool = True) -> ParsedOBJ:
    """Parse OBJ+MTL into flat SoA arrays (reference Utils::parse_obj).

    ``use_native`` takes the C++ geometry parser (which raises if it
    cannot be built), else the pure-python one; both produce identical
    arrays (tests/test_torch_io.py).
    """
    if use_native:
        return parse_obj_native(path)
    positions: List[tuple] = []
    tri_vertex_ids: List[tuple] = []
    tri_materials: List[int] = []
    mtl_materials: List[Dict] = []
    mtl_name_to_id: Dict[str, int] = {}
    current_material = -1
    base_dir = os.path.dirname(os.path.abspath(path))

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0]
            if tag == "v":
                positions.append(
                    (float(parts[1]), float(parts[2]), float(parts[3]))
                )
            elif tag == "mtllib":
                mtl_path = os.path.join(base_dir, " ".join(parts[1:]))
                for m in _parse_mtl(mtl_path):
                    mtl_name_to_id[m["name"]] = len(mtl_materials)
                    mtl_materials.append(m)
            elif tag == "usemtl":
                name = " ".join(parts[1:])
                current_material = mtl_name_to_id.get(name, -1)
            elif tag == "f":
                # vertex spec is v, v/vt, v/vt/vn or v//vn; fan-triangulate
                ids = []
                for spec in parts[1:]:
                    v = spec.split("/")[0]
                    vid = int(v)
                    ids.append(vid - 1 if vid > 0 else len(positions) + vid)
                for k in range(1, len(ids) - 1):
                    tri_vertex_ids.append((ids[0], ids[k], ids[k + 1]))
                    tri_materials.append(current_material)

    pos = np.asarray(positions, np.float32)
    if len(tri_vertex_ids) == 0:
        raise ValueError(f"no faces found in {path}")
    vid = np.asarray(tri_vertex_ids, np.int64)             # [N,3]
    triangles = pos[vid]                                   # [N,3,3]

    table = _material_table(mtl_materials)
    material_indices = np.asarray(tri_materials, np.int32) + 1  # +1 offset
    return _finalize(triangles, material_indices, table)


def load_scene(obj_path: str, env_map_image=None, device="cuda"):
    """Parse an OBJ and assemble a Scene with its tensors on ``device``."""
    from sycl_ray_tracing_tpu_torch.models.scene import (
        make_materials,
        make_scene,
    )

    device = resolve_device(device)
    parsed = parse_obj(obj_path)
    materials = make_materials(
        parsed.emission, parsed.diffuse, parsed.metalness, parsed.roughness,
        device=device,
    )
    return make_scene(
        parsed.triangles,
        parsed.material_indices,
        materials,
        emissive_indices=parsed.emissive_indices,
        env_map_image=env_map_image,
        device=device,
    )
