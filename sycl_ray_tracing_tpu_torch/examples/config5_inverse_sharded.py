"""BASELINE config 5: differentiable inverse rendering — optimize material
parameters against a target render, with gradients averaged over the
("data", "sample") mesh of ranks (counterpart of
examples/config5_inverse_sharded.py).

    python -m sycl_ray_tracing_tpu_torch.examples.config5_inverse_sharded [--small]
    torchrun --nproc-per-node=N -m sycl_ray_tracing_tpu_torch.examples.config5_inverse_sharded

It runs the port's trainer (sycl_ray_tracing_tpu_torch/train.py) on the
reference's cornell_pbr.obj, looked up under $SRT_REFERENCE_ROOT, and
exits with its code: 2 when the OBJ is not found, 1 when the diffuse
error did not fall.  The trainer builds no acceleration structure, so its
renders take brute force and launch no list kernel.
"""

from __future__ import annotations

from sycl_ray_tracing_tpu_torch import train
from sycl_ray_tracing_tpu_torch.examples._common import small


def train_args(small: bool = False) -> list:
    if small:
        return ["--steps=20", "--w=12", "--h=12", "--samples=4"]
    return ["--steps=100", "--w=32", "--h=32", "--samples=16"]


def main(argv=None, device="cuda") -> int:
    return train.main(train_args(small(argv)), device=device)


if __name__ == "__main__":
    raise SystemExit(main())
