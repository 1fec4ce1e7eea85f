"""The least time an H100 could take for the list kernels' work:
bound = max(operations / 67 TFLOP/s FP32, bytes / 3.35 TB/s), the SXM
part's published peaks at its full 700 W (state the card's power limit
beside every share read against them).

Frozen copy of ``bound``, ``block_tiles_work`` and ``list_tiles_work``
with ``stop=None`` from sycl_ray_tracing_tpu_torch/probes/bounds.py at
commit e337019: operations and bytes on every live round of the lists a
launch was given, which depend only on the launch's inputs (cand, rays,
tris), not on how far the kernel's guard walks them.  Each FP32 multiply,
add or subtract, compare and reciprocal counts one operation (54 per ray,
lane and live round, plus 6 per loaded tile lane); each input byte the
output depends on is read once (the distinct tiles the lists name, the 7
ray columns the kernels use, the lists), each output byte written once.
"""

from __future__ import annotations

import torch

FP32_OPS_PER_S = 67e12
BYTES_PER_S = 3.35e12
LANES = 128
TILE_BYTES = 9 * LANES * 4
RAY_COLS_USED = 7
MT8_OPS = 54
EDGE_OPS = 6


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / FP32_OPS_PER_S, nbytes / BYTES_PER_S)


def tiles_work(cand, rays, tris) -> tuple[int, int]:
    """(operations, bytes) of a list walk over every live round of
    ``cand`` [lists, maxc] (dummy id tris.shape[0] - 1), each list shared
    by rays.shape[0] / cand.shape[0] rays: 32 for block_tiles, 1 for
    list_tiles."""
    dummy = tris.shape[0] - 1
    live = cand != dummy
    per_list = rays.shape[0] // cand.shape[0]
    ops = int(live.sum()) * LANES * (EDGE_OPS + per_list * MT8_OPS)
    ids = torch.unique(cand)
    tiles = int((ids != dummy).sum()) * TILE_BYTES
    out = rays.shape[0] * LANES * 8                   # at f32 + ar i32
    nbytes = (cand.numel() * cand.element_size()
              + rays.shape[0] * RAY_COLS_USED * rays.element_size()
              + tiles + out)
    return ops, nbytes
