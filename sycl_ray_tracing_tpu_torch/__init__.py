"""sycl_ray_tracing_tpu_torch — the PyTorch + CUDA port of the path tracer.

The JAX package ``sycl_ray_tracing_tpu`` is the reference; this package
mirrors its layout (``ops/``, ``ops/kernels/``, ``models/``, ``utils/``)
so each module's counterpart is easy to find.  Plain tensor code is
PyTorch; the list tracer's two Pallas kernels are hand-written CUDA C++
for Hopper (``csrc/listtrace.cu``), built with nvcc at first use.

This package never imports JAX.
"""

__version__ = "0.1.0"

from sycl_ray_tracing_tpu_torch.models.scene import Scene, Materials
from sycl_ray_tracing_tpu_torch.models.camera import Camera
from sycl_ray_tracing_tpu_torch.utils.config import RenderConfig

__all__ = [
    "Scene",
    "Materials",
    "Camera",
    "RenderConfig",
    "__version__",
]
