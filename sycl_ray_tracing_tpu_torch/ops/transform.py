"""4x4 row-major homogeneous transforms (counterpart of
sycl_ray_tracing_tpu/ops/transform.py; reference gkit Transform,
mat.cpp): identity, translation, scale, rotations (X/Y/Z/axis), lookat,
projections and viewport, composition, inverse, and application to
points and directions.

Transforms are built as float32 tensors on the CPU, or on the device of
a tensor argument; ``Camera.create`` moves the composed view matrix to
its device.  Tensor arguments keep their autograd graph, so a camera pose
can be differentiated through them.
"""

from __future__ import annotations

import math

import torch

from sycl_ray_tracing_tpu_torch.ops.safe_math import cross, normalize


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


def _rot(deg, axis: int) -> torch.Tensor:
    """Rotation by ``deg`` degrees about axis 0/1/2 (mat.cpp:210-244)."""
    r = torch.deg2rad(_scalars(deg)[0])
    c, s = torch.cos(r), torch.sin(r)
    if axis == 0:
        rows = (1.0, 0.0, 0.0, 0.0, 0.0, c, -s, 0.0, 0.0, s, c, 0.0)
    elif axis == 1:
        rows = (c, 0.0, s, 0.0, 0.0, 1.0, 0.0, 0.0, -s, 0.0, c, 0.0)
    else:
        rows = (c, -s, 0.0, 0.0, s, c, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0)
    return _scalars(*rows, 0.0, 0.0, 0.0, 1.0).reshape(4, 4)


def rotation_x(deg) -> torch.Tensor:
    """Rotation about X (mat.cpp:210-220)."""
    return _rot(deg, 0)


def rotation_y(deg) -> torch.Tensor:
    """Rotation about Y (mat.cpp:222-232)."""
    return _rot(deg, 1)


def rotation_z(deg) -> torch.Tensor:
    """Rotation about Z (mat.cpp:234-244)."""
    return _rot(deg, 2)


def _vec3(v, dev=None) -> torch.Tensor:
    """A 3-vector as float32 (a tensor keeps its graph and device)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return _scalars(*v) if dev is None else _scalars(*v).to(dev)


def rotation_axis(axis, deg) -> torch.Tensor:
    """Rotation about an arbitrary axis (mat.cpp:246-276 semantics)."""
    a = normalize(_vec3(axis))
    r = torch.deg2rad(_scalars(deg)[0])
    c, s = torch.cos(r), torch.sin(r)
    x, y, z = a[0], a[1], a[2]
    return _scalars(
        x * x + (1 - x * x) * c, x * y * (1 - c) - z * s,
        x * z * (1 - c) + y * s, 0.0,
        x * y * (1 - c) + z * s, y * y + (1 - y * y) * c,
        y * z * (1 - c) - x * s, 0.0,
        x * z * (1 - c) - y * s, y * z * (1 - c) + x * s,
        z * z + (1 - z * z) * c, 0.0,
        0.0, 0.0, 0.0, 1.0).reshape(4, 4)


def lookat(eye, target, up) -> torch.Tensor:
    """Camera-to-world transform looking from eye to target (mat.cpp:349+):
    columns right, up, -forward, eye."""
    dev = next((v.device for v in (eye, target, up)
                if isinstance(v, torch.Tensor)), None)
    eye, target, up = (_vec3(v, dev) for v in (eye, target, up))
    d = normalize(target - eye)          # forward
    r = normalize(cross(d, up))          # right
    u = normalize(cross(r, d))           # true up
    cols = torch.stack([r, u, -d, eye], dim=1)                    # [3,4]
    return torch.cat([cols, _scalars(0.0, 0.0, 0.0, 1.0).to(cols.device)
                      [None]], dim=0)


def scale(x, y=None, z=None) -> torch.Tensor:
    """Scale transform (mat.cpp Scale); scale(s) is uniform."""
    y = x if y is None else y
    z = x if z is None else z
    return torch.diag(_scalars(x, y, z, 1.0))


def perspective(fov_degrees: float, aspect: float, znear: float,
                zfar: float) -> torch.Tensor:
    """Perspective projection (mat.cpp Perspective, gkit convention)."""
    itan = 1.0 / math.tan(math.radians(fov_degrees) * 0.5)
    m = torch.zeros((4, 4), dtype=torch.float32)
    m[0, 0] = itan / aspect
    m[1, 1] = itan
    m[2, 2] = -(zfar + znear) / (zfar - znear)
    m[2, 3] = -2.0 * zfar * znear / (zfar - znear)
    m[3, 2] = -1.0
    return m


def orthographic(left: float, right: float, bottom: float, top: float,
                 znear: float, zfar: float) -> torch.Tensor:
    """Orthographic projection (mat.cpp Ortho)."""
    m = identity()
    m[0, 0] = 2.0 / (right - left)
    m[1, 1] = 2.0 / (top - bottom)
    m[2, 2] = -2.0 / (zfar - znear)
    m[0, 3] = -(right + left) / (right - left)
    m[1, 3] = -(top + bottom) / (top - bottom)
    m[2, 3] = -(zfar + znear) / (zfar - znear)
    return m


def viewport(width: float, height: float) -> torch.Tensor:
    """NDC -> pixel viewport transform (mat.cpp Viewport)."""
    w, h = width / 2.0, height / 2.0
    m = identity()
    m[0, 0], m[0, 3] = w, w
    m[1, 1], m[1, 3] = h, h
    m[2, 2], m[2, 3] = 0.5, 0.5
    return m


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b: apply ``b`` first, then ``a`` (row-major like mat.h)."""
    return a @ b


def inverse(m: torch.Tensor) -> torch.Tensor:
    return torch.linalg.inv(m).to(torch.float32)


def apply_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Transform points [...,3] with homogeneous divide (mat.cpp:94-111)."""
    xyz = p @ m[:3, :3].T + m[:3, 3]
    w = p @ m[3, :3] + m[3, 3]
    return xyz / w[..., None]


def apply_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Transform directions [...,3]: rotation/scale only (mat.cpp:113-126)."""
    return v @ m[:3, :3].T


def fov_distance(fov_degrees: float) -> float:
    """1/tan(fov/2) for a FULL field of view in degrees (camera.h:22-31)."""
    return 1.0 / math.tan(math.radians(fov_degrees) / 2.0)
