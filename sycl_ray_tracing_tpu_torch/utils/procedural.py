"""Procedural stand-in assets (counterpart of
sycl_ray_tracing_tpu/utils/procedural.py).

The numpy generators are copied verbatim so both packages build
bit-identical scene arrays from the same arguments.  The reference's
flagship assets (pbrt_dragon.obj ~870k tris, the 2k evening-road HDR
skysphere) are replaced by workloads of equivalent scale and character:

  * ``dragon_standin(n_tris)`` — a displaced torus-knot mesh: high poly
    count, curved surfaces, strong spatial coherence (like a scanned model)
  * ``procedural_sky(h, w)`` — smooth HDR gradient sky + ground + a bright
    sun disc (high dynamic range for importance sampling)

The reference's MIS.obj and cornell_pbr.obj, which the BASELINE examples
read, have stand-ins too: ``mis_standin()`` and ``cornell_standin()``,
written as OBJ + MTL by ``write_standin`` (``write_obj`` writes any
scene's triangles that way).
"""

from __future__ import annotations

import os

import numpy as np

from sycl_ray_tracing_tpu_torch.utils.device import resolve_device


def dragon_standin(n_tris: int = 200_000, seed: int = 0) -> np.ndarray:
    """Generate ~n_tris triangles [N,3,3] of a displaced torus-knot tube.

    Matches the PBRT-dragon scene placement (model near the origin below the
    camera preset rotated -45° about X, camera.cpp:7): mesh is centered at
    the origin, roughly 4 units across, sitting on y ∈ [-1.5, 1.5].
    """
    rng = np.random.default_rng(seed)
    # choose grid so 2*nu*nv ≈ n_tris
    nu = int(np.sqrt(n_tris / 2 * 4))
    nv = max(8, n_tris // (2 * nu))
    u = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    v = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")       # [nu,nv]

    # (p,q) torus knot center curve
    p, q = 2, 3
    r_curve = 1.2 + 0.5 * np.cos(q * uu)
    cx = r_curve * np.cos(p * uu)
    cy = r_curve * np.sin(p * uu)
    cz = 0.6 * np.sin(q * uu)

    # tube frame (approximate Frenet via finite differences along u)
    def d_du(a):
        return np.roll(a, -1, axis=0) - np.roll(a, 1, axis=0)

    tx, ty, tz = d_du(cx), d_du(cy), d_du(cz)
    tl = np.sqrt(tx * tx + ty * ty + tz * tz) + 1e-9
    tx, ty, tz = tx / tl, ty / tl, tz / tl
    # normal ~ derivative of tangent
    nx, ny, nz = d_du(tx), d_du(ty), d_du(tz)
    nl = np.sqrt(nx * nx + ny * ny + nz * nz) + 1e-9
    nx, ny, nz = nx / nl, ny / nl, nz / nl
    bx = ty * nz - tz * ny
    by = tz * nx - tx * nz
    bz = tx * ny - ty * nx

    tube_r = 0.35 * (1.0 + 0.25 * np.sin(5 * uu) * np.cos(3 * vv))
    # bumpy displacement for normal variation (dragon-scales character)
    tube_r *= 1.0 + 0.08 * np.sin(12 * uu + 7 * vv)
    px = cx + tube_r * (np.cos(vv) * nx + np.sin(vv) * bx)
    py = cy + tube_r * (np.cos(vv) * ny + np.sin(vv) * by)
    pz = cz + tube_r * (np.cos(vv) * nz + np.sin(vv) * bz)
    verts = np.stack([px, pz, py], axis=-1).astype(np.float32)  # y-up

    # two triangles per quad, wrap-around indexing
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
    return np.ascontiguousarray(tris[: n_tris])


def procedural_sky(h: int = 512, w: int = 1024, sun_intensity: float = 500.0,
                   seed: int = 0) -> np.ndarray:
    """HDR equirect sky [H,W,3]: gradient blue sky, warm horizon, ground,
    and a small very bright sun disc."""
    y = np.linspace(0.0, 1.0, h)[:, None]          # 0 = top pole
    x = np.linspace(0.0, 1.0, w)[None, :]
    img = np.zeros((h, w, 3), np.float32)
    # sky gradient (top half), warm near horizon
    sky_t = np.clip(y * 2.0, 0.0, 1.0)
    img[..., 0] = 0.25 + 0.9 * sky_t
    img[..., 1] = 0.45 + 0.5 * sky_t
    img[..., 2] = 1.1 - 0.45 * sky_t
    # ground (bottom half): dull brown
    ground = (y > 0.5).repeat(w, axis=1)
    img[ground] = np.array([0.25, 0.2, 0.15], np.float32)
    # sun disc
    sun_y, sun_x = 0.3, 0.7
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    d2 = ((yy - sun_y) * 2) ** 2 + ((xx - sun_x)) ** 2
    sun = d2 < (0.015 ** 2)
    img[sun] = sun_intensity
    return img


def dragon_scene(n_tris: int = 200_000, with_sky: bool = True,
                 sky_res: tuple = (512, 1024), build_accel: bool = True,
                 device="cuda"):
    """Assemble the flagship benchmark scene: dragon stand-in on a ground
    plane with a rough-metal material + emissive panel + HDR sky, with
    its tensors on ``device``."""
    from sycl_ray_tracing_tpu_torch.models.scene import (
        make_materials,
        make_scene,
    )

    device = resolve_device(device)
    dragon = dragon_standin(n_tris - 12)
    # ground plane + emissive panel above
    g = 8.0
    # wound so the geometric normal faces +y (shading is one-sided,
    # matching the reference's un-flipped triangle normals)
    ground = np.array(
        [
            [[-g, -1.6, -g], [g, -1.6, g], [g, -1.6, -g]],
            [[-g, -1.6, -g], [-g, -1.6, g], [g, -1.6, g]],
        ],
        np.float32,
    )
    lp = 1.5
    panel = np.array(
        [
            [[-lp, 4.0, -lp], [lp, 4.0, -lp], [lp, 4.0, lp]],
            [[-lp, 4.0, -lp], [lp, 4.0, lp], [-lp, 4.0, lp]],
        ],
        np.float32,
    )
    tris = np.concatenate([dragon, ground, panel], axis=0)
    n_d, n_g, n_p = dragon.shape[0], 2, 2
    mat_idx = np.concatenate(
        [
            np.full(n_d, 1, np.int32),   # dragon: rough metal
            np.full(n_g, 2, np.int32),   # ground: diffuse
            np.full(n_p, 3, np.int32),   # panel: emissive
        ]
    )
    mats = make_materials(
        emission=[(1.0, 0.0, 1.0), (0, 0, 0), (0, 0, 0), (8.0, 7.5, 7.0)],
        diffuse=[(0, 0, 0), (0.9, 0.7, 0.3), (0.5, 0.5, 0.5), (0, 0, 0)],
        metalness=[0.0, 0.8, 0.0, 0.0],
        roughness=[1.0, 0.35, 0.8, 1.0],
        device=device,
    )
    sky = procedural_sky(*sky_res) if with_sky else None
    scene = make_scene(tris, mat_idx, mats, env_map_image=sky, device=device)
    if build_accel:
        scene = scene.build_acceleration()
    return scene


def write_obj(path: str, triangles, material_indices, materials) -> None:
    """Write triangles [N,3,3], their material rows [N] and a Materials
    table as OBJ + MTL (``path`` and ``path`` with .mtl), for the loader
    to read back: three vertices per triangle (%.9g, exact for float32),
    faces in order under one ``usemtl`` per run of a material, MTL
    material k for row k >= 1 (row 0 is the loader's debug material)
    with illum 2, so Pm and Pr are read."""
    tris = np.asarray(triangles, np.float32).reshape(-1, 3)
    mi = np.asarray(material_indices)
    mtl_path = os.path.splitext(path)[0] + ".mtl"
    table = {f: np.asarray(getattr(materials, f).detach().cpu().numpy(),
                           np.float32)
             for f in ("emission", "diffuse", "metalness", "roughness")}
    with open(mtl_path, "w") as f:
        for k in range(1, table["emission"].shape[0]):
            f.write(f"newmtl m{k}\n"
                    "Kd {:.9g} {:.9g} {:.9g}\n".format(*table["diffuse"][k])
                    + "Ke {:.9g} {:.9g} {:.9g}\n".format(*table["emission"][k])
                    + f"Pm {table['metalness'][k]:.9g}\n"
                    f"Pr {table['roughness'][k]:.9g}\nillum 2\n")
    with open(path, "w") as f:
        f.write(f"mtllib {os.path.basename(mtl_path)}\n")
        np.savetxt(f, tris, fmt="v %.9g %.9g %.9g")
        starts = np.flatnonzero(np.r_[True, mi[1:] != mi[:-1]])
        ends = np.r_[starts[1:], mi.shape[0]]
        for a, b in zip(starts, ends):
            f.write(f"usemtl m{int(mi[a])}\n")
            ids = np.arange(3 * a + 1, 3 * b + 1).reshape(-1, 3)
            np.savetxt(f, ids, fmt="f %d %d %d")


def _quad(a, b, c, d, toward) -> list:
    """Two triangles of the planar quad a-b-c-d, wound so that their
    geometric normal points along ``toward`` (shading is one-sided)."""
    a, b, c, d = (np.asarray(p, np.float32) for p in (a, b, c, d))
    if np.dot(np.cross(b - a, c - a), toward) < 0:
        b, d = d, b
    return [[a, b, c], [a, c, d]]


def _box(lo, hi, turn_deg=0.0) -> list:
    """12 outward-facing triangles of the box [lo, hi] turned by
    ``turn_deg`` about its vertical axis."""
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    mid = (lo + hi) / 2
    c, s = np.cos(np.radians(turn_deg)), np.sin(np.radians(turn_deg))

    def corner(ix, iy, iz):
        p = np.where([ix, iy, iz], hi, lo) - mid
        return mid + np.array(
            [c * p[0] + s * p[2], p[1], -s * p[0] + c * p[2]], np.float32)

    tris = []
    for axis in range(3):
        for side in (0, 1):
            ids = []
            for u, v in ((0, 0), (1, 0), (1, 1), (0, 1)):
                bits = [u, v]
                bits.insert(axis, side)
                ids.append(corner(*bits))
            tris += _quad(*ids, toward=np.mean(ids, axis=0) - mid)
    return tris


def _sphere(center, radius, seg) -> list:
    """A UV sphere of 4*seg*(seg-1) outward-facing triangles."""
    center = np.asarray(center, np.float32)
    th = np.linspace(0.0, np.pi, seg + 1)
    ph = np.linspace(0.0, 2 * np.pi, 2 * seg + 1)

    def p(i, j):
        return center + radius * np.array(
            [np.sin(th[i]) * np.cos(ph[j]), np.cos(th[i]),
             np.sin(th[i]) * np.sin(ph[j])], np.float32)

    tris = []
    for i in range(seg):
        for j in range(2 * seg):
            a, b, c, d = p(i, j), p(i + 1, j), p(i + 1, j + 1), p(i, j + 1)
            # the pole bands' quads have one degenerate triangle
            tris += [t for t in _quad(a, b, c, d, (a + c) / 2 - center)
                     if np.linalg.norm(np.cross(t[1] - t[0], t[2] - t[0]))
                     > 0]
    return tris


def mis_standin(seg: int = 16) -> tuple:
    """A procedural stand-in for the reference's MIS.obj (Veach's
    multiple-importance-sampling scene, 3860 triangles): four glossy
    metal plates of rising roughness under four spherical lights of
    falling size and rising radiance, a dim overhead panel, a floor and a
    back wall, in the view of models.camera.mis_camera.  ``seg`` sets the
    spheres' tessellation (16: 3,854 triangles).  Returns (triangles
    [N,3,3], material rows [N], {emission, diffuse, metalness,
    roughness}: row 0 the loader's debug material)."""
    parts = [
        (_quad((-10, -7.5, -6), (10, -7.5, -6), (10, -7.5, 6),
               (-10, -7.5, 6), (0, 1, 0)), 1),
        (_quad((-10, -7.5, -5), (10, -7.5, -5), (10, 4, -5), (-10, 4, -5),
               (0, 0, 1)), 1),
        (_quad((-3, 4, -2), (3, 4, -2), (3, 4, 2), (-3, 4, 2), (0, -1, 0)),
         2),
    ]
    # the plates rise toward the back wall, each tilted a little more
    for k, (y, z) in enumerate(((-6.0, 1.5), (-5.0, 0.5), (-4.0, -0.5),
                                (-3.0, -1.5))):
        tilt = np.radians(25.0 + 8.0 * k)
        dy, dz = 0.6 * np.sin(tilt), -0.6 * np.cos(tilt)
        parts.append((_quad((-3.5, y - dy, z - dz), (3.5, y - dy, z - dz),
                            (3.5, y + dy, z + dz), (-3.5, y + dy, z + dz),
                            (0, np.cos(tilt), np.sin(tilt))), 3 + k))
    radii = (0.05, 0.15, 0.4, 1.0)
    for k, (x, r) in enumerate(zip((-3.75, -1.25, 1.25, 3.75), radii)):
        parts.append((_sphere((x, 0.5, -3.0), r, seg), 7 + k))
    tris = np.array([t for p, _ in parts for t in p], np.float32)
    mat = np.concatenate([np.full(len(p), m, np.int32) for p, m in parts])
    colors = ((1.0, 0.3, 0.3), (0.3, 1.0, 0.3), (0.3, 0.5, 1.0),
              (1.0, 0.9, 0.6))
    table = dict(
        emission=[(1, 0, 1), (0, 0, 0), (2, 2, 2)] + [(0, 0, 0)] * 4
        + [tuple(4.0 / r ** 2 * c for c in col)
           for r, col in zip(radii, colors)],
        diffuse=[(0, 0, 0), (0.4, 0.4, 0.4), (0, 0, 0)]
        + [(0.7, 0.7, 0.7)] * 4 + [(0, 0, 0)] * 4,
        metalness=[0, 0, 0] + [1.0] * 4 + [0] * 4,
        roughness=[1, 0.9, 1] + [0.05, 0.15, 0.35, 0.7] + [1] * 4)
    return tris, mat, table


def cornell_standin() -> tuple:
    """A procedural stand-in for the reference's cornell_pbr.obj: the
    Cornell box (white floor, ceiling and back wall, red left and green
    right walls, a ceiling light) with a tall and a short box, in the view
    of models.camera.cornell_box_camera.  Returns what mis_standin
    returns."""
    parts = [
        (_quad((-1, 0, -1), (1, 0, -1), (1, 0, 1), (-1, 0, 1), (0, 1, 0)), 1),
        (_quad((-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1), (0, -1, 0)),
         1),
        (_quad((-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1), (0, 0, 1)),
         1),
        (_quad((-1, 0, -1), (-1, 2, -1), (-1, 2, 1), (-1, 0, 1), (1, 0, 0)),
         2),
        (_quad((1, 0, -1), (1, 2, -1), (1, 2, 1), (1, 0, 1), (-1, 0, 0)), 3),
        (_quad((-0.25, 1.98, -0.25), (0.25, 1.98, -0.25),
               (0.25, 1.98, 0.25), (-0.25, 1.98, 0.25), (0, -1, 0)), 4),
        (_box((-0.7, 0.0, -0.6), (-0.1, 1.2, 0.0), 18.0), 5),
        (_box((0.1, 0.0, 0.0), (0.7, 0.6, 0.6), -17.0), 6),
    ]
    tris = np.array([t for p, _ in parts for t in p], np.float32)
    mat = np.concatenate([np.full(len(p), m, np.int32) for p, m in parts])
    table = dict(
        emission=[(1, 0, 1)] + [(0, 0, 0)] * 3 + [(17, 12, 4)]
        + [(0, 0, 0)] * 2,
        diffuse=[(0, 0, 0), (0.73, 0.73, 0.73), (0.65, 0.05, 0.05),
                 (0.12, 0.45, 0.15), (0, 0, 0), (0.73, 0.73, 0.73),
                 (0.6, 0.6, 0.8)],
        metalness=[0, 0, 0, 0, 0, 0.2, 0.5],
        roughness=[1, 0.8, 0.6, 0.6, 1, 0.5, 0.3])
    return tris, mat, table


def write_standin(path: str, standin: tuple) -> None:
    """Write mis_standin()'s or cornell_standin()'s scene as OBJ + MTL
    at ``path`` (its directories made)."""
    from sycl_ray_tracing_tpu_torch.models.scene import make_materials

    tris, mat, table = standin
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_obj(path, tris, mat, make_materials(**table, device="cpu"))
