"""Device mesh helpers (counterpart of sycl_ray_tracing_tpu/parallel/mesh.py).

The reference's only parallelism is an OpenMP ``parallel for`` over image
rows with a shared read-only scene (render_kernel.cpp:198-203).  The mesh
here is a 2D grid of torch.distributed ranks, one rank per device,

    ("data", "sample")

where pixels/rays shard over "data", spp over "sample", and the scene is
replicated on every device.  Rank r sits at (r // n_sample, r % n_sample),
as the JAX mesh reshapes its device list.  The mesh holds one process
group per row (the ranks that share a data index: a reduction over
"sample") and one per column (the ranks that share a sample index: a
reduction or gather over "data").  Without an initialized process group a
one-rank mesh has no groups and its collectives are the identity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_data: int
    n_sample: int
    rank: int
    # the ranks of this rank's row (varying sample index) and column
    # (varying data index); None without a process group
    sample_group: Optional[Any] = None
    data_group: Optional[Any] = None

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "sample": self.n_sample}

    @property
    def data_index(self) -> int:
        return self.rank // self.n_sample

    @property
    def sample_index(self) -> int:
        return self.rank % self.n_sample

    def _group(self, axis: str):
        if axis not in ("data", "sample"):
            raise ValueError(f"bad mesh axis {axis!r}")
        return self.data_group if axis == "data" else self.sample_group

    def pmean(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """Mean of ``x`` over the ranks along ``axis`` (jax.lax.pmean):
        an all_reduce sum over the axis' group, then a division by its
        size.  Returns a new tensor."""
        out = x.detach().clone()
        if self._group(axis) is not None:
            dist.all_reduce(out, group=self._group(axis))
        return out / self.shape[axis]

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The ``axis`` ranks' ``x`` concatenated along dim 0, in mesh
        order."""
        group = self._group(axis)
        if group is None:
            return x.detach().clone()
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x.detach().contiguous(), group=group)
        return torch.cat(parts)


def make_mesh(n_devices: Optional[int] = None, sample_axis: int = 1) -> Mesh:
    """Build a ("data", "sample") mesh over the process group's ranks.

    ``n_devices`` must be the world size (default): each rank is one
    device.  Every rank creates every row and column group, in the same
    order, as torch.distributed requires.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a world of {n} "
                         f"ranks, not {world}")
    if n % sample_axis != 0:
        raise ValueError(
            f"{n} devices not divisible by sample_axis={sample_axis}"
        )
    n_data = n // sample_axis
    if not dist.is_initialized():
        return Mesh(n_data, sample_axis, 0)
    rank = dist.get_rank()
    sample_group = data_group = None
    for d in range(n_data):
        g = dist.new_group([d * sample_axis + s for s in range(sample_axis)])
        if rank // sample_axis == d:
            sample_group = g
    for s in range(sample_axis):
        g = dist.new_group([d * sample_axis + s for d in range(n_data)])
        if rank % sample_axis == s:
            data_group = g
    return Mesh(n_data, sample_axis, rank, sample_group, data_group)


def best_sample_axis(n_devices: int, samples: int) -> int:
    """Largest power-of-two sample-axis size that divides both."""
    s = 1
    while (
        s * 2 <= n_devices
        and n_devices % (s * 2) == 0
        and samples % (s * 2) == 0
    ):
        s *= 2
    return s


def pad_to_multiple(n: int, m: int) -> int:
    return int(math.ceil(n / m) * m)
