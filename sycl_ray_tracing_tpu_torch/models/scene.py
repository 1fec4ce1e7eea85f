"""Scene representation: structure-of-arrays tensors (counterpart of
sycl_ray_tracing_tpu/models/scene.py).

Every constructor takes a ``device``: the card unless the caller asks
for the CPU (utils/device.py).  ``scene_from_numpy`` carries a JAX ``Scene``'s leaves across as
numpy arrays, so both packages can render the very same scene.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from sycl_ray_tracing_tpu_torch.ops.bvh import (
    BVH_FIELDS,
    ThreadedBVH,
    bvh_from_numpy,
)
from sycl_ray_tracing_tpu_torch.ops.cluster import (
    CLUSTER_FIELDS,
    CLUSTER_STATIC,
    ClusterScene,
    build_cluster_arrays,
    clusters_from_numpy,
    default_budgets,
)
from sycl_ray_tracing_tpu_torch.ops.envmap import (
    EnvMapSampler,
    build_sampler,
    sampler_from_numpy,
)
from sycl_ray_tracing_tpu_torch.ops.kernels.rows import gather_rows
from sycl_ray_tracing_tpu_torch.ops.sampling import triangle_area
from sycl_ray_tracing_tpu_torch.utils.device import resolve_device

# tri | material << 20 packing of the cluster-slot shading table
SLOT_TRI_BITS = 20
MAX_SLOT_MATERIALS = 1 << 11


@dataclasses.dataclass(frozen=True)
class Materials:
    """SoA material table (reference SimpleMaterial, simple_material.h:6-13).
    Row 0 is the magenta debug/default material."""

    emission: torch.Tensor   # [M,3]
    diffuse: torch.Tensor    # [M,3]
    metalness: torch.Tensor  # [M]
    roughness: torch.Tensor  # [M]

    @property
    def count(self) -> int:
        return self.emission.shape[0]

    def packed(self) -> torch.Tensor:
        """[M,8] rows: emission3 | diffuse3 | metalness | roughness."""
        return torch.cat(
            [self.emission, self.diffuse, self.metalness[:, None],
             self.roughness[:, None]], dim=1,
        )

    def lookup(self, idx: torch.Tensor):
        """Per-ray (emission, diffuse, metalness, roughness) by material
        index [...]: one row gather of the packed table (scene.py:41),
        whose gradient is ops/kernels/rows.row_sum."""
        rows = gather_rows(self.packed(), idx)
        return rows[..., 0:3], rows[..., 3:6], rows[..., 6], rows[..., 7]


def make_materials(emission, diffuse, metalness, roughness,
                   device="cuda") -> Materials:
    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Materials(emission=f32(emission), diffuse=f32(diffuse),
                     metalness=f32(metalness), roughness=f32(roughness))


@dataclasses.dataclass(frozen=True)
class Scene:
    """Complete render scene.  ``material_indices`` maps triangle index ->
    material row, ``sphere_material`` sphere index -> material row (the
    spheres are empty unless given).  ``slot_packed`` [K2,T] i32 is the
    cluster-slot shading table aligned with ``clusters.cl_tri_idx``:
    tri_idx | material_id << 20, so one gather by the list tracer's packed
    (cluster, lane) winner resolves primitive and material."""

    triangles: torch.Tensor            # [N,3,3] float32
    materials: Materials
    material_indices: torch.Tensor     # [N] int32
    emissive_indices: torch.Tensor     # [K] int32 (triangle ids with Ke>0)
    sphere_centers: Optional[torch.Tensor] = None   # [S,3] (None: empty)
    sphere_radii: Optional[torch.Tensor] = None     # [S]
    sphere_material: Optional[torch.Tensor] = None  # [S] int32
    env_map: Optional[EnvMapSampler] = None         # None -> black sky
    bvh: Optional[ThreadedBVH] = None
    clusters: Optional[ClusterScene] = None
    tri_areas: Optional[torch.Tensor] = None   # [N]
    slot_packed: Optional[torch.Tensor] = None

    def __post_init__(self):
        dev = self.triangles.device
        for name, shape, dtype in (("sphere_centers", (0, 3), torch.float32),
                                   ("sphere_radii", (0,), torch.float32),
                                   ("sphere_material", (0,), torch.int32)):
            if getattr(self, name) is None:
                object.__setattr__(self, name, torch.zeros(
                    shape, dtype=dtype, device=dev))

    @property
    def device(self) -> torch.device:
        return self.triangles.device

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]

    @property
    def num_spheres(self) -> int:
        return self.sphere_centers.shape[0]

    @property
    def num_lights(self) -> int:
        return self.emissive_indices.shape[0]

    def with_clusters(self, clusters) -> "Scene":
        return dataclasses.replace(self, clusters=clusters)

    def with_bvh(self, bvh) -> "Scene":
        return dataclasses.replace(self, bvh=bvh)

    def with_materials(self, materials: Materials) -> "Scene":
        """The same scene with other materials (for example ones whose
        tensors require grad: the render differentiates through them)."""
        return dataclasses.replace(self, materials=materials)

    def with_env_map(self, image) -> "Scene":
        """The same scene under another sky [H,W,3]: a torch image keeps
        its graph (texel gradients reach it), host arrays go to the
        scene's device."""
        return dataclasses.replace(
            self, env_map=build_sampler(image, self.device))

    def build_acceleration(self, num_rays_hint: int = 32768,
                           order="sah") -> "Scene":
        """Build the clustered acceleration structure (native SAH leaf
        order by default), its pair budgets and the cluster-slot shading
        table (scene.py:124-142).  ``num_rays_hint`` sizes the pair
        tracer's static budgets, and so the most rays a tiled render
        batches on it (ClusterScene.budget_rays).  Give the wavefront
        TILE size (RenderConfig.tile_rays), not the image size: its
        phase-3 gather holds p2_budget rows of 1152 floats (2.7 GB at
        32768)."""
        arrays = build_cluster_arrays(self.triangles.detach().cpu().numpy(),
                                      order)
        p1, p2 = default_budgets(num_rays_hint, arrays["sc_box"].shape[0])
        clusters = clusters_from_numpy(arrays, self.device, p1_budget=p1,
                                       p2_budget=p2)
        scene = self.with_clusters(clusters)
        return dataclasses.replace(scene, slot_packed=_slot_table(scene))


def _slot_table(scene: Scene) -> Optional[torch.Tensor]:
    """tri_idx | material_id << 20 per cluster slot (host numpy,
    scene.py:148-167); None when the packing would overflow."""
    idx = scene.clusters.cl_tri_idx.cpu().numpy()
    n = scene.num_triangles
    if n > (1 << SLOT_TRI_BITS) or scene.materials.count > MAX_SLOT_MATERIALS:
        return None
    valid = idx >= 0
    ci = np.clip(idx, 0, max(0, n - 1))
    matid = scene.material_indices.cpu().numpy()[ci]
    sp = np.where(valid, idx, 0).astype(np.int32) | (
        np.where(valid, matid, 0).astype(np.int32) << SLOT_TRI_BITS
    )
    return torch.as_tensor(sp, device=scene.device)


def make_scene(triangles, material_indices, materials: Materials,
               emissive_indices=None, sphere_centers=None, sphere_radii=None,
               sphere_material=None, env_map_image=None,
               device="cuda") -> Scene:
    """Assemble a Scene from host arrays, deriving emissive indices from
    material emission if not given (reference utils.cpp:58-69)."""
    device = resolve_device(device)
    tris = np.asarray(triangles, np.float32)
    mi = np.asarray(material_indices, np.int32)
    if emissive_indices is None:
        em = materials.emission.detach().cpu().numpy()
        is_emissive = (em[mi] > 0.0).any(axis=-1)
        # row 0 is the debug material, never a light
        is_emissive &= mi > 0
        emissive_indices = np.nonzero(is_emissive)[0]
    triangles_t = torch.as_tensor(tris, device=device)
    spheres = {}
    if sphere_centers is not None:
        spheres = dict(
            sphere_centers=torch.as_tensor(
                np.asarray(sphere_centers, np.float32), device=device),
            sphere_radii=torch.as_tensor(
                np.asarray(sphere_radii, np.float32), device=device),
            sphere_material=torch.as_tensor(
                np.asarray(sphere_material, np.int32), device=device))
    return Scene(
        triangles=triangles_t,
        materials=materials,
        material_indices=torch.as_tensor(mi, device=device),
        emissive_indices=torch.as_tensor(
            np.asarray(emissive_indices, np.int32), device=device),
        env_map=(None if env_map_image is None
                 else build_sampler(env_map_image, device)),
        tri_areas=triangle_area(triangles_t),
        **spheres,
    )


def add_sphere(scene: Scene, center, radius: float,
               emission=(0.0, 0.0, 0.0), diffuse=(1.0, 1.0, 1.0),
               metalness: float = 0.0, roughness: float = 0.5) -> Scene:
    """Insert an analytic sphere with a material row of its own (the
    reference's add_sphere_to_scene, main.cpp:20-30; scene.py:220-255)."""
    dev = scene.device
    mats = scene.materials

    def row(x):
        return torch.tensor([x], dtype=torch.float32, device=dev)

    new_mats = Materials(
        emission=torch.cat([mats.emission, row(emission)]),
        diffuse=torch.cat([mats.diffuse, row(diffuse)]),
        metalness=torch.cat([mats.metalness, row(metalness)]),
        roughness=torch.cat([mats.roughness, row(max(1e-2, roughness))]),
    )
    return dataclasses.replace(
        scene,
        materials=new_mats,
        sphere_centers=torch.cat([scene.sphere_centers, row(center)]),
        sphere_radii=torch.cat([scene.sphere_radii, row(radius)]),
        sphere_material=torch.cat([
            scene.sphere_material,
            torch.tensor([mats.count], dtype=torch.int32, device=dev)]),
    )


def scene_from_numpy(arrays: dict, device) -> Scene:
    """The port's Scene from a JAX Scene's leaves as numpy arrays.

    Keys: ``triangles``, ``material_indices``, ``emissive_indices``,
    ``emission``, ``diffuse``, ``metalness``, ``roughness``, ``tri_areas``;
    optionally ``sphere_centers``, ``sphere_radii``, ``sphere_material``;
    the env sampler's tables under ``env_<field>`` (image, row_cdf,
    cond_cdf, total, cond_blk, cond_fine); the cluster tables under their
    ClusterScene names plus ``list_maxc``, ``p1_budget``, ``p2_budget``
    and ``fanout``; ``slot_packed``; and a BVH's tables under
    ``bvh_<field>`` plus ``bvh_leaf_size``."""
    def t(name, dtype):
        return torch.tensor(np.asarray(arrays[name], dtype), device=device)

    env = None
    if "env_image" in arrays:
        env = sampler_from_numpy(
            {f: arrays[f"env_{f}"] for f in EnvMapSampler._fields}, device)
    clusters = None
    if "cl_tris" in arrays:
        clusters = clusters_from_numpy(
            {f: arrays[f] for f in CLUSTER_FIELDS}, device,
            **{k: arrays[k] for k in CLUSTER_STATIC if k in arrays})
    bvh = None
    if "bvh_nodes_box" in arrays:
        bvh = bvh_from_numpy({f: arrays[f"bvh_{f}"] for f in BVH_FIELDS},
                             device, int(arrays.get("bvh_leaf_size", 4)))
    spheres = {}
    if "sphere_centers" in arrays:
        spheres = dict(sphere_centers=t("sphere_centers", np.float32),
                       sphere_radii=t("sphere_radii", np.float32),
                       sphere_material=t("sphere_material", np.int32))
    return Scene(
        triangles=t("triangles", np.float32),
        materials=Materials(
            emission=t("emission", np.float32),
            diffuse=t("diffuse", np.float32),
            metalness=t("metalness", np.float32),
            roughness=t("roughness", np.float32),
        ),
        material_indices=t("material_indices", np.int32),
        emissive_indices=t("emissive_indices", np.int32),
        env_map=env,
        clusters=clusters,
        tri_areas=t("tri_areas", np.float32),
        slot_packed=(t("slot_packed", np.int32) if "slot_packed" in arrays
                     else None),
        bvh=bvh,
        **spheres,
    )
