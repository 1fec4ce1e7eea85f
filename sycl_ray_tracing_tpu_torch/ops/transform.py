"""4x4 row-major homogeneous transforms: the subset ``models/camera.py``
uses (counterpart of sycl_ray_tracing_tpu/ops/transform.py).

Transforms are built as float32 tensors on the CPU; ``Camera.create``
moves the composed view matrix to its device.
"""

from __future__ import annotations

import math

import torch


def identity() -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32)


def translation(x, y, z) -> torch.Tensor:
    m = torch.eye(4, dtype=torch.float32)
    m[:3, 3] = torch.tensor([x, y, z], dtype=torch.float32)
    return m


def rotation_x(deg) -> torch.Tensor:
    """Rotation about X (mat.cpp:210-220)."""
    r = torch.deg2rad(torch.tensor(deg, dtype=torch.float32))
    c, s = torch.cos(r), torch.sin(r)
    m = torch.eye(4, dtype=torch.float32)
    m[1, 1] = c
    m[2, 2] = c
    m[1, 2] = -s
    m[2, 1] = s
    return m


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b: apply ``b`` first, then ``a`` (row-major like mat.h)."""
    return a @ b


def apply_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points [...,3] with homogeneous divide (mat.cpp:94-111)."""
    xyz = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3] + m[3, 3]
    return xyz / w[..., None]


def fov_distance(fov_degrees: float) -> float:
    """1/tan(fov/2) for a FULL field of view in degrees (camera.h:22-31)."""
    return 1.0 / math.tan(math.radians(fov_degrees) / 2.0)
