"""The benchmark's inputs, made from a configuration file alone: the
stand-in mesh, the floor and the light panel, the material table, the
procedural sky and the camera's pose.  The program and the reference are
handed the same arrays.

``dragon_standin`` and ``procedural_sky`` are frozen copies of
sycl_ray_tracing_tpu_torch/utils/procedural.py at commit e337019, and
``scene_arrays`` assembles what its ``dragon_scene`` assembles.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent


@dataclasses.dataclass(frozen=True)
class Inputs:
    triangles: np.ndarray         # [N,3,3] float32
    material_indices: np.ndarray  # [N] int32
    emission: np.ndarray          # [M,3]
    diffuse: np.ndarray           # [M,3]
    metalness: np.ndarray         # [M]
    roughness: np.ndarray         # [M]
    sky: np.ndarray               # [H,W,3] float32
    camera: tuple                 # (fov degrees, rotation about X, translation)


def load_config(name: str, root: Path = ROOT) -> dict:
    """configs/<name>.json."""
    return json.loads((root / "configs" / f"{name}.json").read_text())


def dragon_standin(n_tris: int, seed: int) -> np.ndarray:
    """~n_tris triangles [N,3,3] of a displaced torus-knot tube, centred
    at the origin, about 4 units across."""
    rng = np.random.default_rng(seed)
    nu = int(np.sqrt(n_tris / 2 * 4))
    nv = max(8, n_tris // (2 * nu))
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    p, q = 2, 3
    r_curve = 1.2 + 0.5 * np.cos(q * uu)
    cx = r_curve * np.cos(p * uu)
    cy = r_curve * np.sin(p * uu)
    cz = 0.6 * np.sin(q * uu)

    def d_du(a):
        return np.roll(a, -1, axis=0) - np.roll(a, 1, axis=0)

    tx, ty, tz = d_du(cx), d_du(cy), d_du(cz)
    tl = np.sqrt(tx * tx + ty * ty + tz * tz) + 1e-9
    tx, ty, tz = tx / tl, ty / tl, tz / tl
    nx, ny, nz = d_du(tx), d_du(ty), d_du(tz)
    nl = np.sqrt(nx * nx + ny * ny + nz * nz) + 1e-9
    nx, ny, nz = nx / nl, ny / nl, nz / nl
    bx = ty * nz - tz * ny
    by = tz * nx - tx * nz
    bz = tx * ny - ty * nx
    tube_r = 0.35 * (1.0 + 0.25 * np.sin(5 * uu) * np.cos(3 * vv))
    tube_r *= 1.0 + 0.08 * np.sin(12 * uu + 7 * vv)
    px = cx + tube_r * (np.cos(vv) * nx + np.sin(vv) * bx)
    py = cy + tube_r * (np.cos(vv) * ny + np.sin(vv) * by)
    pz = cz + tube_r * (np.cos(vv) * nz + np.sin(vv) * bz)
    verts = np.stack([px, pz, py], axis=-1).astype(np.float32)
    i0 = np.arange(nu)[:, None]
    j0 = np.arange(nv)[None, :]
    i1 = (i0 + 1) % nu
    j1 = (j0 + 1) % nv
    a = verts[i0, j0]
    b = verts[i1, j0]
    c = verts[i1, j1]
    d = verts[i0, j1]
    t1 = np.stack([a, b, c], axis=2).reshape(-1, 3, 3)
    t2 = np.stack([a, c, d], axis=2).reshape(-1, 3, 3)
    tris = np.concatenate([t1, t2], axis=0)
    rng.shuffle(tris, axis=0)
    return np.ascontiguousarray(tris[:n_tris])


def procedural_sky(h: int, w: int, sun_intensity: float) -> np.ndarray:
    """HDR equirect sky [H,W,3]: a blue gradient, a warm horizon, a brown
    ground and a small, very bright sun disc."""
    y = np.linspace(0.0, 1.0, h)[:, None]
    img = np.zeros((h, w, 3), np.float32)
    sky_t = np.clip(y * 2.0, 0.0, 1.0)
    img[..., 0] = 0.25 + 0.9 * sky_t
    img[..., 1] = 0.45 + 0.5 * sky_t
    img[..., 2] = 1.1 - 0.45 * sky_t
    ground = (y > 0.5).repeat(w, axis=1)
    img[ground] = np.array([0.25, 0.2, 0.15], np.float32)
    sun_y, sun_x = 0.3, 0.7
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    d2 = ((yy - sun_y) * 2) ** 2 + ((xx - sun_x)) ** 2
    img[d2 < (0.015 ** 2)] = sun_intensity
    return img


def scene_arrays(cfg: dict) -> Inputs:
    """The configuration's scene: the stand-in mesh, a floor of two
    triangles and a light panel of two, their materials, the sky and the
    camera."""
    mesh = cfg["mesh"]
    dragon = dragon_standin(mesh["standin_triangles"], mesh["seed"])
    g = mesh["floor_half"]
    y = mesh["floor_y"]
    ground = np.array([[[-g, y, -g], [g, y, g], [g, y, -g]],
                       [[-g, y, -g], [-g, y, g], [g, y, g]]], np.float32)
    lp, ly = mesh["panel_half"], mesh["panel_y"]
    panel = np.array([[[-lp, ly, -lp], [lp, ly, -lp], [lp, ly, lp]],
                      [[-lp, ly, -lp], [lp, ly, lp], [-lp, ly, lp]]],
                     np.float32)
    tris = np.concatenate([dragon, ground, panel], axis=0)
    mat_idx = np.concatenate([np.full(dragon.shape[0], 1, np.int32),
                              np.full(2, 2, np.int32),
                              np.full(2, 3, np.int32)])
    m = cfg["materials"]
    sky = cfg["sky"]
    cam = cfg["camera"]
    return Inputs(
        triangles=tris, material_indices=mat_idx,
        emission=np.asarray(m["emission"], np.float32),
        diffuse=np.asarray(m["diffuse"], np.float32),
        metalness=np.asarray(m["metalness"], np.float32),
        roughness=np.asarray(m["roughness"], np.float32),
        sky=procedural_sky(sky["height"], sky["width"], sky["sun_intensity"]),
        camera=(cam["fov"], cam["rotation_x"], tuple(cam["translation"])))
