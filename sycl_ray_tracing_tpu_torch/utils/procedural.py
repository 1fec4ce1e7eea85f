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
"""

from __future__ import annotations

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
