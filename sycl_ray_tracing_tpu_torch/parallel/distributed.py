"""Multi-process runtime: torch.distributed bring-up (counterpart of
sycl_ray_tracing_tpu/parallel/distributed.py).

One process per device.  ``initialize`` joins the process group (NCCL on
the card; gloo only when the caller asks for the CPU), and
``global_mesh`` lays every rank of every host on the ("data", "sample")
mesh that parallel/render.py's functions take.  A single process needs
no bring-up: its mesh has one rank and no collectives.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from sycl_ray_tracing_tpu_torch.parallel.mesh import Mesh, make_mesh
from sycl_ray_tracing_tpu_torch.utils.device import resolve_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> torch.device:
    """Join the process group and return the device this process renders
    on.

    With no arguments, reads torchrun's MASTER_ADDR / MASTER_PORT /
    WORLD_SIZE / RANK (LOCAL_RANK picks the card).  ``coordinator_address``
    is "host:port".  A no-op, returning ``device``, when no coordinator
    is known.  The backend is NCCL when ``device`` is CUDA and gloo when
    it is the CPU; without CUDA a CUDA device raises.
    """
    device = resolve_device(device)
    addr = coordinator_address
    if addr is None and "MASTER_ADDR" in os.environ:
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if addr is None:
        return device
    num = (num_processes if num_processes is not None
           else int(os.environ.get("WORLD_SIZE", "1")))
    pid = (process_id if process_id is not None
           else int(os.environ.get("RANK", "0")))
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   pid % torch.cuda.device_count()))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}",
                            world_size=num, rank=pid)
    return device


def global_mesh(sample_axis: int = 1) -> Mesh:
    """("data", "sample") mesh over ALL ranks of ALL processes, in rank
    order (torchrun numbers a host's ranks contiguously, so "data" splits
    across hosts only at host boundaries)."""
    return make_mesh(None, sample_axis)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def process_info() -> dict:
    world = dist.get_world_size() if dist.is_initialized() else 1
    return {
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }
