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

from sycl_ray_tracing_tpu_torch.ops.cluster import (
    CLUSTER_FIELDS,
    ClusterScene,
    build_cluster_arrays,
    clusters_from_numpy,
)
from sycl_ray_tracing_tpu_torch.ops.envmap import (
    EnvMapSampler,
    build_sampler,
    sampler_from_numpy,
)
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


def make_materials(emission, diffuse, metalness, roughness,
                   device="cuda") -> Materials:
    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return Materials(emission=f32(emission), diffuse=f32(diffuse),
                     metalness=f32(metalness), roughness=f32(roughness))


@dataclasses.dataclass(frozen=True)
class Scene:
    """Complete render scene (triangles only: analytic spheres are not
    ported yet, ROADMAP Queue 1, item 11).  ``slot_packed`` [K2,T] i32 is the
    cluster-slot shading table aligned with ``clusters.cl_tri_idx``:
    tri_idx | material_id << 20, so one gather by the list tracer's packed
    (cluster, lane) winner resolves primitive and material."""

    triangles: torch.Tensor            # [N,3,3] float32
    materials: Materials
    material_indices: torch.Tensor     # [N] int32
    emissive_indices: torch.Tensor     # [K] int32 (triangle ids with Ke>0)
    env_map: Optional[EnvMapSampler]   # None -> black sky
    clusters: Optional[ClusterScene] = None
    tri_areas: Optional[torch.Tensor] = None   # [N]
    slot_packed: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.triangles.device

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]

    @property
    def num_lights(self) -> int:
        return self.emissive_indices.shape[0]

    def with_clusters(self, clusters) -> "Scene":
        return dataclasses.replace(self, clusters=clusters)

    def build_acceleration(self, order="sah") -> "Scene":
        """Build the clustered acceleration structure (native SAH leaf
        order by default) and the cluster-slot shading table."""
        arrays = build_cluster_arrays(self.triangles.cpu().numpy(), order)
        scene = self.with_clusters(clusters_from_numpy(arrays, self.device))
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
               emissive_indices=None, env_map_image=None,
               device="cuda") -> Scene:
    """Assemble a Scene from host arrays, deriving emissive indices from
    material emission if not given (reference utils.cpp:58-69)."""
    device = resolve_device(device)
    tris = np.asarray(triangles, np.float32)
    mi = np.asarray(material_indices, np.int32)
    if emissive_indices is None:
        em = materials.emission.cpu().numpy()
        is_emissive = (em[mi] > 0.0).any(axis=-1)
        # row 0 is the debug material, never a light
        is_emissive &= mi > 0
        emissive_indices = np.nonzero(is_emissive)[0]
    triangles_t = torch.as_tensor(tris, device=device)
    return Scene(
        triangles=triangles_t,
        materials=materials,
        material_indices=torch.as_tensor(mi, device=device),
        emissive_indices=torch.as_tensor(
            np.asarray(emissive_indices, np.int32), device=device),
        env_map=(None if env_map_image is None
                 else build_sampler(env_map_image, device)),
        tri_areas=triangle_area(triangles_t),
    )


def scene_from_numpy(arrays: dict, device) -> Scene:
    """The port's Scene from a JAX Scene's leaves as numpy arrays.

    Keys: ``triangles``, ``material_indices``, ``emissive_indices``,
    ``emission``, ``diffuse``, ``metalness``, ``roughness``, ``tri_areas``;
    optionally the env sampler's tables under ``env_<field>`` (image,
    row_cdf, cond_cdf, total, cond_blk, cond_fine), the cluster tables
    under their ClusterScene names plus ``list_maxc``, and
    ``slot_packed``.  Spheres (``sphere_radii`` non-empty) are not ported
    and raise."""
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
            list_maxc=int(arrays.get("list_maxc", 0)),
        )
    n_sph = np.asarray(arrays.get("sphere_radii", np.zeros(0))).shape[0]
    if n_sph:
        raise NotImplementedError(
            "spheres are not ported yet (ROADMAP Queue 1, item 11)")
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
    )
