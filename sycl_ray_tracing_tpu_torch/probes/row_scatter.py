"""The backward's row sum (csrc/row_scatter.cu) against its plain torch
version, ``row_sum_plain``, on the card:

    python -m sycl_ray_tracing_tpu_torch.probes row_scatter

The shapes of the trainer's gathers on the 512x512 frame: the full width
of 262,144 rays and the compacted widths (1/2, 1/4, 1/8 of it), from the
[4, 8] material table by an int32 index skewed as the bounce's material
ids are, and from the [2, 12] light rows by a uniform int64 pick; and a
[2048, 8] table (the most materials a fused frame takes) by random
indices.  Each case must equal the plain version bit for bit and give the
same bits in 3 runs; one launch is counted a call.  Then a gather's
backward through ``gather_rows`` on the card (one launch, the plain
version's bits), and each case's time: CUDA events a call, at the full
width the profiler's device time of each of the two kernels a launch
(fewer profiler runs: late in a long process it has missed launches),
the bound
(each grad row and index read once, the sums written once), the plain
version's time, and torch's ``index_put_(accumulate=True)`` (the
backward the port no longer calls) as ``library_ms``.
The card tests of ``tests/test_torch_row_scatter.py`` run the same
holds.
"""

from __future__ import annotations

import numpy as np
import torch

from sycl_ray_tracing_tpu_torch.ops.kernels import rows as RW
from sycl_ray_tracing_tpu_torch.probes.hier_build import same_bits

CHUNK_KERNEL = "row_scatter_chunk_kernel"
COMBINE_KERNEL = "row_scatter_combine_kernel"
FULL = 512 * 512
WIDTHS = (FULL, FULL // 2, FULL // 4, FULL // 8)
MATERIAL_P = (0.0, 0.55, 0.40, 0.05)   # debug row, dragon, ground, panel
# (label, width, rows, cols, index dtype, index draw)
CASES = tuple(
    [(f"materials-{w}", w, 4, 8, torch.int32, "materials") for w in WIDTHS]
    + [(f"lights-{w}", w, 2, 12, torch.int64, "uniform") for w in WIDTHS]
    + [(f"table2048-{FULL}", FULL, 2048, 8, torch.int32, "uniform")])


def case_inputs(width: int, rows: int, cols: int, dtype, draw: str,
                device, seed: int = 11):
    """(grad [width, cols] f32, idx [width]) of one case."""
    rng = np.random.default_rng(seed)
    grad = rng.standard_normal((width, cols)).astype(np.float32)
    if draw == "materials":
        idx = rng.choice(rows, size=width, p=MATERIAL_P)
    else:
        idx = rng.integers(0, rows, width)
    return (torch.tensor(grad, device=device),
            torch.tensor(idx, dtype=dtype, device=device))


def work(grad, idx, rows: int) -> tuple[float, float]:
    """(operations, bytes): an add per grad element; each grad row and
    index read once and the [rows, C] sums written once."""
    W, C = grad.shape
    return float(W * C), float(W * (4 * C + idx.element_size())
                               + rows * C * 4)


def run(device, reps: int = 20, log=print) -> dict:
    """Every hold, then every case's times; raises on a difference.
    Returns the full-width material case's numbers and every case's."""
    from sycl_ray_tracing_tpu_torch.probes import frame
    from sycl_ray_tracing_tpu_torch.probes.bounds import bound
    from sycl_ray_tracing_tpu_torch.probes.common import card_line, cuda_ms
    from sycl_ray_tracing_tpu_torch.utils import metrics

    card = card_line()
    for rows, cols in ((4, 8), (2, 12), (2048, 8)):
        for idx64 in (False, True):
            info = RW.row_sum_info(rows, cols, idx64)
            log(f"row_scatter chunk kernel at {rows}x{cols}, "
                f"{'int64' if idx64 else 'int32'} index: "
                f"{info['registers']} registers, {info['local_bytes']} "
                f"spill bytes, {info['threads']} threads, "
                f"{info['shared_bytes']} shared bytes, "
                f"{info['blocks_per_sm']} blocks per SM")
            if info["local_bytes"]:
                raise RuntimeError("row_scatter_chunk_kernel spills")
    info = RW.row_sum_info(4, 8)
    bad = []
    inputs = {}
    for label, width, rows, cols, dtype, draw in CASES:
        grad, idx = case_inputs(width, rows, cols, dtype, draw, device)
        inputs[label] = (grad, idx, rows)
        want = RW.row_sum_plain(grad, idx, rows)
        before = metrics.COUNTS.get("row_scatter.fused", 0)
        runs = [RW.row_sum(grad, idx, rows) for _ in range(3)]
        counted = metrics.COUNTS.get("row_scatter.fused", 0) - before
        same = [same_bits(r, want) for r in runs]
        err = float((runs[0].double() - want.double()).abs().max())
        log(f"row_scatter {label} ({width} rays, {rows}x{cols}, {dtype}): "
            f"bit-identical to plain in runs {same}, launches counted "
            f"{counted}, max |diff| {err:.3g}")
        if not all(same) or counted != 3:
            bad.append(label)

    # a gather's backward on the card: one launch, the plain version's bits
    grad, idx, rows = inputs[f"materials-{FULL}"]
    table = torch.rand((rows, 8), device=device, requires_grad=True)
    before = metrics.COUNTS.get("row_scatter.fused", 0)
    with torch.enable_grad():    # the probes run under no_grad
        (g,) = torch.autograd.grad(RW.gather_rows(table, idx), table, grad)
    counted = metrics.COUNTS.get("row_scatter.fused", 0) - before
    ok = same_bits(g, RW.row_sum_plain(grad, idx, rows)) and counted == 1
    log(f"row_scatter gather_rows backward ({FULL} rays): plain version's "
        f"bits {ok}, launches {counted}")
    if not ok:
        bad.append("gather_rows backward")
    if bad:
        raise RuntimeError(f"the row-sum kernel differs from its plain "
                           f"version: {bad}")

    cases = {}
    for label, (grad, idx, rows) in inputs.items():
        def fused():
            RW.row_sum(grad, idx, rows)

        def plain():
            RW.row_sum_plain(grad, idx, rows)

        def library():
            torch.zeros((rows, grad.shape[1]), device=grad.device).index_put_(
                (idx.long(),), grad, accumulate=True)

        ms = cuda_ms(fused, reps)
        chunk_ms = combine_ms = None
        if grad.shape[0] == FULL:
            chunk_ms = frame.kernel_ms(fused, CHUNK_KERNEL, reps)
            combine_ms = frame.kernel_ms(fused, COMBINE_KERNEL, reps)
        plain_ms = cuda_ms(plain, max(1, reps // 4))
        library_ms = cuda_ms(library, max(1, reps // 4))
        ops_bytes = work(grad, idx, rows)
        bound_ms, by = bound(*ops_bytes)
        cases[label] = dict(ms=ms, device_ms=None if chunk_ms is None
                            else chunk_ms + combine_ms,
                            chunk_ms=chunk_ms, combine_ms=combine_ms,
                            plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=by, work=ops_bytes)
        dev = "" if chunk_ms is None else (
            f", device {chunk_ms:.4f} + {combine_ms:.4f} ms a launch (chunk "
            f"+ combine, profiler)")
        log(f"row_scatter {label}: {ms:.4f} ms a call by events{dev}; "
            f"bound {bound_ms:.5f} ms by {by}; plain "
            f"version {plain_ms:.4f} ms; index_put_(accumulate=True) "
            f"{library_ms:.4f} ms ({card})")
    top = cases[f"materials-{FULL}"]
    return dict(top, cases=cases, info=info)
