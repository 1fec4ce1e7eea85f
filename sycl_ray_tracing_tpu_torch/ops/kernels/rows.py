"""Row gathers from small tables and their gradient, the row sum by index
(the port's own; the JAX package leaves the gather's transpose to XLA).

``gather_rows(table, idx)`` is ``table[idx.long()]``.  Where a gradient
will flow into a small float32 table (grad mode on, the table requires
grad, at most ROW_SUM_MAX_ROWS rows and ROW_SUM_MAX_COLS columns), it is
an autograd Function whose backward is ``row_sum``: on the card one
launch of csrc/row_scatter.cu (both of its kernels from one call), on the
CPU ``row_sum_plain``.  torch's own backward of the gather is index_put_
with accumulate, which on the card sums each run of equal indices
serially; the material and light tables the bounce reads have 2-4 rows
and up to 262,144 rays.  Any other gather is plain indexing, with no
Function in the graph.

The sums run in a fixed order (csrc/row_scatter.cu): rays in chunks of
ROW_SUM_CHUNK; inside a chunk each row's rays, in ray order, by a pairwise
tree over their rank in the row; then the chunk partials in chunk order.
``row_sum_plain`` repeats that order with torch ops, so the kernel equals
it bit for bit and a run gives the same bits each time.  Each launch
counts under ``COUNTS["row_scatter.fused"]`` (utils/metrics).
"""

from __future__ import annotations

import torch

from sycl_ray_tracing_tpu_torch.ops.kernels.cuda_lib import (
    kernel_info,
    load_cuda_library,
    stream_of,
)
from sycl_ray_tracing_tpu_torch.utils.metrics import tally

ROW_SUM_MAX_ROWS = 4096   # materials are capped at MAX_SLOT_MATERIALS 2048
ROW_SUM_MAX_COLS = 16
ROW_SUM_CHUNK = 2048      # rays a CTA: kChunk in csrc/row_scatter.cu


def row_sum_plain(grad: torch.Tensor, idx: torch.Tensor,
                  rows: int) -> torch.Tensor:
    """out[rows, C] with out[r] the sum of grad[i] over idx[i] == r (a
    negative index counts from the end), in the kernel's order; any
    device.  grad [W, C] float32, idx [W] integer."""
    W, C = grad.shape
    dev = grad.device
    if W == 0:
        return torch.zeros((rows, C), dtype=grad.dtype, device=dev)
    r = idx.long()
    r = torch.where(r < 0, r + rows, r)
    pos = torch.arange(W, device=dev)
    chunks = -(-W // ROW_SUM_CHUNK)
    key, order = torch.sort((pos // ROW_SUM_CHUNK) * rows + r, stable=True)
    v = grad[order]
    seg, counts = torch.unique_consecutive(key, return_counts=True)
    first = torch.cumsum(counts, 0) - counts
    of = torch.repeat_interleave(torch.arange(seg.shape[0], device=dev),
                                 counts)
    rank, length = pos - first[of], counts[of]
    h, longest = 1, int(counts.max())
    while h < longest:
        at = torch.nonzero(((rank & (2 * h - 1)) == 0)
                           & (rank + h < length)).squeeze(1)
        v[at] = v[at] + v[at + h]
        h *= 2
    part = torch.zeros((chunks * rows, C), dtype=grad.dtype, device=dev)
    part[seg] = v[first]
    part = part.view(chunks, rows, C)
    out = part[0]
    for g in range(1, chunks):
        out = out + part[g]
    return out


def _check(grad, idx, rows: int):
    """What the kernel takes; raises on anything else."""
    if grad.dtype != torch.float32 or grad.dim() != 2:
        raise TypeError("row_sum takes a float32 [W, C] gradient")
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1:
        raise TypeError("row_sum takes an int32 or int64 [W] index")
    if idx.shape[0] != grad.shape[0]:
        raise ValueError("row_sum: the index and the gradient differ in W")
    if idx.device != grad.device:
        raise ValueError("row_sum: the index and the gradient must share a "
                         "device")
    if not 1 <= rows <= ROW_SUM_MAX_ROWS:
        raise ValueError(f"row_sum takes 1 to {ROW_SUM_MAX_ROWS} rows, got "
                         f"{rows}")
    if not 1 <= grad.shape[1] <= ROW_SUM_MAX_COLS:
        raise ValueError(f"row_sum takes 1 to {ROW_SUM_MAX_COLS} columns, "
                         f"got {grad.shape[1]}")


def row_sum(grad: torch.Tensor, idx: torch.Tensor, rows: int) -> torch.Tensor:
    """row_sum_plain's result: csrc/row_scatter.cu for CUDA tensors (it
    raises on what the kernel cannot take), row_sum_plain for CPU ones."""
    _check(grad, idx, rows)
    if not grad.is_cuda:
        return row_sum_plain(grad, idx, rows)
    W, C = grad.shape
    grad, idx = grad.contiguous(), idx.contiguous()
    out = torch.empty((rows, C), dtype=torch.float32, device=grad.device)
    if W == 0:
        return out.zero_()
    chunks = -(-W // ROW_SUM_CHUNK)
    part = torch.empty((chunks, rows, C), dtype=torch.float32,
                       device=grad.device) if chunks > 1 else None
    rc = load_cuda_library().srt_row_sum(
        grad.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64), W,
        rows, C, None if part is None else part.data_ptr(), out.data_ptr(),
        stream_of(grad))
    if rc != 0:
        raise RuntimeError(f"row_scatter launch failed: CUDA error {rc}")
    tally("row_scatter.fused")
    return out


def row_sum_info(rows: int, cols: int, idx64: bool = False) -> dict:
    """The built chunk kernel's registers, spill, shared bytes and
    occupancy at ``rows`` x ``cols``."""
    return kernel_info("row_sum", load_cuda_library().srt_row_sum_info,
                       int(idx64), rows, cols)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx.long()]

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        C = grad.shape[-1]
        return row_sum(grad.reshape(-1, C), idx.reshape(-1), ctx.rows), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx.long()]`` for a [R, C] table and an integer index of any
    shape; its gradient by ``row_sum`` where one flows into a table that
    the kernel takes (see the module docstring)."""
    if (torch.is_grad_enabled() and table.requires_grad
            and table.dim() == 2 and table.dtype == torch.float32
            and 1 <= table.shape[0] <= ROW_SUM_MAX_ROWS
            and 1 <= table.shape[1] <= ROW_SUM_MAX_COLS):
        return _GatherRows.apply(table, idx)
    return table[idx.long()]
