"""4x4 row-major homogeneous transforms: the subset ``models/camera.py``
uses (counterpart of sycl_ray_tracing_tpu/ops/transform.py).

Transforms are built as float32 tensors on the CPU, or on the device of
a tensor argument; ``Camera.create`` moves the composed view matrix to
its device.  Tensor arguments keep their autograd graph, so a camera pose
can be differentiated through them.
"""

from __future__ import annotations

import math

import torch


def identity() -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32)


def _scalars(*vals) -> torch.Tensor:
    """Python numbers and 0-d tensors stacked into one float32 vector on
    the first tensor's device (else the CPU); tensors keep their graph."""
    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)), None)
    return torch.stack([torch.as_tensor(v, dtype=torch.float32, device=dev)
                        for v in vals])


def translation(x, y, z) -> torch.Tensor:
    return _scalars(1.0, 0.0, 0.0, x, 0.0, 1.0, 0.0, y, 0.0, 0.0, 1.0, z,
                    0.0, 0.0, 0.0, 1.0).reshape(4, 4)


def rotation_x(deg) -> torch.Tensor:
    """Rotation about X (mat.cpp:210-220)."""
    r = torch.deg2rad(_scalars(deg)[0])
    c, s = torch.cos(r), torch.sin(r)
    return _scalars(1.0, 0.0, 0.0, 0.0, 0.0, c, -s, 0.0, 0.0, s, c, 0.0,
                    0.0, 0.0, 0.0, 1.0).reshape(4, 4)


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
