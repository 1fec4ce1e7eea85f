"""Pinhole camera: presets + batched primary-ray generation (counterpart of
sycl_ray_tracing_tpu/models/camera.py; reference camera.h, camera.cpp,
render_kernel.cpp:56-73)."""

from __future__ import annotations

import dataclasses

import torch

from sycl_ray_tracing_tpu_torch.ops import transform as T


def _default_coordinate_system() -> torch.Tensor:
    """-Z forward coordinate flip (reference camera.cpp:3)."""
    return torch.diag(torch.tensor([1.0, 1.0, -1.0, 1.0], dtype=torch.float32))


@dataclasses.dataclass(frozen=True)
class Camera:
    view_matrix: torch.Tensor   # [4,4]
    fov_dist: torch.Tensor      # [] scalar

    @staticmethod
    def create(fov_degrees: float = 45.0, transform=None,
               device="cpu") -> "Camera":
        """fov is the FULL field of view in degrees (camera.h:22-31)."""
        if transform is None:
            transform = T.identity()
        view = T.compose(transform, _default_coordinate_system())
        return Camera(
            view_matrix=view.to(device),
            fov_dist=torch.tensor(T.fov_distance(fov_degrees),
                                  dtype=torch.float32, device=device),
        )

    def generate_rays(self, px: torch.Tensor, py: torch.Tensor,
                      width: int, height: int):
        """Primary rays through continuous pixel coords px, py [B]: NDC in
        [-1,1], aspect on x, two points through the view matrix."""
        x_ndc = (px / width * 2.0 - 1.0) * (width / height)
        y_ndc = py / height * 2.0 - 1.0
        origin = T.apply_point(self.view_matrix,
                               torch.zeros(px.shape + (3,), dtype=torch.float32,
                                           device=px.device))
        target_ndc = torch.stack(
            [x_ndc, y_ndc, self.fov_dist.expand(px.shape)], dim=-1
        )
        target_world = T.apply_point(self.view_matrix, target_ndc)
        direction = target_world - origin
        direction = direction / torch.linalg.vector_norm(
            direction, dim=-1, keepdim=True)
        return origin, direction


# The five reference presets (camera.cpp:4-8)
def cornell_box_camera(device="cpu") -> Camera:
    return Camera.create(45.0, T.translation(0.0, 1.0, 3.5), device)


def ganesha_camera(device="cpu") -> Camera:
    return Camera.create(
        45.0, T.compose(T.rotation_x(-15.0), T.translation(-0.0205, 0.67, 1.0)),
        device,
    )


def ite_orb_camera(device="cpu") -> Camera:
    return Camera.create(
        45.0, T.compose(T.rotation_x(-45.0), T.translation(0.0, 0.15, 1.5)),
        device,
    )


def pbrt_dragon_camera(device="cpu") -> Camera:
    return Camera.create(
        45.0, T.compose(T.rotation_x(-45.0), T.translation(0.0, -1.0, 10.5)),
        device,
    )


def mis_camera(device="cpu") -> Camera:
    return Camera.create(
        45.0, T.compose(T.rotation_x(-10.0), T.translation(0.0, -3.0, 10.5)),
        device,
    )


PRESETS = {
    "cornell": cornell_box_camera,
    "ganesha": ganesha_camera,
    "ite_orb": ite_orb_camera,
    "pbrt_dragon": pbrt_dragon_camera,
    "mis": mis_camera,
}
