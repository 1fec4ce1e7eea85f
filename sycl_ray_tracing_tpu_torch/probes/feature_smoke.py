"""Feature smoke probes on the card (counterparts of scratch/pallas_smoke.py,
scratch/pallas_smoke2.py and scratch/probe_mosaic.py): the primitives the
list tracer's kernels needed, each run on the scripts' own inputs and
checked against the scripts' closed forms where they had one.

    python -m sycl_ray_tracing_tpu_torch.probes feature_smoke
"""

from __future__ import annotations

import numpy as np
import torch

from sycl_ray_tracing_tpu_torch.ops.kernels import probes as pk
from sycl_ray_tracing_tpu_torch.probes import bounds
from sycl_ray_tracing_tpu_torch.probes.common import (
    SEED,
    bound_note,
    cuda_ms,
    plain_line,
)

NB = 8


def gather_inputs(device) -> dict:
    """pallas_smoke.py:50-53: reversed ids, an arange table, unit rays."""
    cid = torch.arange(NB, dtype=torch.int32, device=device).flip(0)
    table = torch.arange(NB * 128, dtype=torch.float32,
                         device=device).reshape(NB, 1, 128)
    rays = torch.ones((NB * pk.SMOKE_RT, 8), dtype=torch.float32,
                      device=device)
    return dict(cid=cid.contiguous(), table=table, rays=rays)


def gather_want(w: dict):
    """pallas_smoke.py:81: block b's table row summed, for each of its 64
    rays, plus 4."""
    rowsum = w["table"][w["cid"].long()].sum(dim=(1, 2))
    return (rowsum.repeat_interleave(pk.SMOKE_RT) + 4)[:, None]


def rank_select_inputs(device) -> dict:
    """pallas_smoke2.py:55-59: a sparse random mask, table rows c = c."""
    rng = np.random.default_rng(SEED)
    mask = (rng.random((8, 128)) < 0.05).astype(np.float32)
    table = rng.random((128, 1, 128)).astype(np.float32) * 0 + np.arange(
        128, dtype=np.float32)[:, None, None]
    return dict(mask=torch.as_tensor(mask, device=device),
                table=torch.as_tensor(table, device=device))


def rank_select_want(w: dict):
    """pallas_smoke2.py:74-75: the table rows of the set columns, summed."""
    cols = torch.nonzero((w["mask"] > 0).any(dim=0)).flatten()
    return w["table"][cols, 0].sum(dim=0, keepdim=True)


def mosaic_inputs(device) -> dict:
    """probe_mosaic.py:55-57."""
    return dict(
        ns=torch.tensor([5], dtype=torch.int32, device=device),
        cand=torch.ones((8, 128), dtype=torch.int32, device=device),
        x=torch.arange(8 * 128, dtype=torch.float32,
                       device=device).reshape(8, 128))


def run(device, reps: int = 20):
    w = gather_inputs(device)
    out = pk.smoke_gather(w["cid"], w["table"], w["rays"])
    want = gather_want(w)
    ok = torch.equal(out, want)
    ms = cuda_ms(lambda: pk.smoke_gather(w["cid"], w["table"], w["rays"],
                                         check_values=False), reps)
    args = (w["cid"], w["table"], w["rays"])
    print(f"smoke_gather: ok={ok} out[0]={float(out[0, 0])} "
          f"want={float(want[0, 0])} ({ms:.4f} ms), "
          f"{bound_note(bounds.smoke_gather_work(*args))}", flush=True)
    plain_line("smoke_gather", lambda: pk.smoke_gather(*args, impl="plain"))
    if not ok:
        raise RuntimeError("smoke_gather disagrees with pallas_smoke.py's "
                           "closed form")

    w = rank_select_inputs(device)
    out = pk.smoke_rank_select(w["mask"], w["table"])
    want = rank_select_want(w)
    ok = torch.equal(out, want)
    ms = cuda_ms(lambda: pk.smoke_rank_select(w["mask"], w["table"]), reps)
    n_cols = int((w["mask"] > 0).any(dim=0).sum())
    args = (w["mask"], w["table"])
    print(f"smoke_rank_select: ok={ok} n_cols={n_cols} "
          f"out0={float(out[0, 0]):.1f} want0={float(want[0, 0]):.1f} "
          f"({ms:.4f} ms), "
          f"{bound_note(bounds.smoke_rank_select_work(*args))}", flush=True)
    plain_line("smoke_rank_select", lambda: pk.smoke_rank_select(
        *args, impl="plain"))
    if not ok:
        raise RuntimeError("smoke_rank_select disagrees with "
                           "pallas_smoke2.py's closed form")

    w = mosaic_inputs(device)
    args = (w["ns"], w["cand"], w["x"])
    for feat in pk.MOSAIC_FEATURES:
        out = pk.mosaic_probe(*args, feat)
        ms = cuda_ms(lambda: pk.mosaic_probe(*args, feat,
                                             check_values=False), reps)
        print(f"{feat}: OK {float(out.double().sum())} ({ms:.4f} ms), "
              f"{bound_note(bounds.mosaic_probe_work(*args, feat))}",
              flush=True)
    plain_line("mosaic_probe all", lambda: pk.mosaic_probe(
        *args, "all", impl="plain"))

