"""Feature smoke probes on the card (counterparts of scratch/pallas_smoke.py,
scratch/pallas_smoke2.py and scratch/probe_mosaic.py): the primitives the
list tracer's kernels needed, each run on the scripts' own inputs and
checked against the scripts' closed forms where they had one, and held bit
for bit against its plain version on seeded random inputs where the order
of the lanes' sum and an early loop stop show.

Each kernel's wrapper call is split three ways beside an empty kernel's
(``pk.null_launch``): (a) CUDA events around queued calls, (b) the host's
microseconds a call with its parts (argument checks, output allocation,
the ctypes launch with the stream lookup), (c) the kernel's device time a
launch by the profiler.  The empty kernel's (c) is the card's floor for
one launch, its (b) the floor of the port's ctypes launch path.

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
    host_us,
    plain_line,
)
from sycl_ray_tracing_tpu_torch.probes.frame import kernel_ms

NB = 8


def gather_inputs(device) -> dict:
    """pallas_smoke.py:50-53: reversed ids, an arange table, unit rays."""
    cid = torch.arange(NB, dtype=torch.int32, device=device).flip(0)
    table = torch.arange(NB * 128, dtype=torch.float32,
                         device=device).reshape(NB, 1, 128)
    rays = torch.ones((NB * pk.SMOKE_RT, 8), dtype=torch.float32,
                      device=device)
    return dict(cid=cid.contiguous(), table=table, rays=rays)


def gather_random_inputs(device, seed: int = SEED) -> dict:
    """Inputs whose sums change with the order of the lanes: a normal
    table and normal rays, and ids that name one row twice."""
    rng = np.random.default_rng(seed)
    cid = rng.permutation(NB).astype(np.int32)
    cid[-1] = cid[0]
    table = rng.normal(size=(NB, 1, 128)).astype(np.float32)
    rays = rng.normal(size=(NB * pk.SMOKE_RT, 8)).astype(np.float32)
    return dict(cid=torch.as_tensor(cid, device=device),
                table=torch.as_tensor(table, device=device),
                rays=torch.as_tensor(rays, device=device))


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


# row 11's order-sensitive masks: the rate of set entries of each
RANK_SELECT_DENSITIES = {"5%": 0.05, "20%": 0.2, "all": 1.0, "none": 0.0}


def rank_select_random_inputs(device, seed: int = SEED,
                              density: float = 0.05) -> dict:
    """Inputs whose sum changes with the order of the adds: a normal table
    and a mask whose entries are set (> 0.5) at rate ``density``.  A
    quarter of the entries sit on the edge of the strict compare: exactly
    0.5 (not set) or the next float above it (set)."""
    rng = np.random.default_rng(seed)
    shape = (8, 128)
    above = np.nextafter(np.float32(0.5), np.float32(1.0))
    hit = rng.random(shape) < density
    mask = np.where(hit,
                    np.maximum(rng.uniform(0.5, 1.0, shape).astype(
                        np.float32), above),
                    rng.uniform(-1.0, 0.5, shape).astype(np.float32))
    edge = rng.random(shape) < 0.25
    mask[edge & hit] = above
    mask[edge & ~hit] = 0.5
    table = rng.normal(size=(128, 1, 128)).astype(np.float32)
    return dict(mask=torch.as_tensor(mask, device=device),
                table=torch.as_tensor(table, device=device))


def set_columns(mask) -> int:
    """The columns of mask that hold a value > 0.5."""
    return int((mask > 0.5).any(dim=0).sum())


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


def mosaic_random_inputs(device, seed: int) -> dict:
    """A random per-row predicate (cand in {-1, 0, 1}), normal x with
    column 2 at -5 (with ds, its max <= -1 stops the while loop after 3
    of ns 7 rounds)."""
    rng = np.random.default_rng(seed)
    cand = rng.integers(-1, 2, (8, 128)).astype(np.int32)
    x = rng.normal(size=(8, 128)).astype(np.float32)
    x[:, 2] = -5.0
    return dict(ns=torch.tensor([7], dtype=torch.int32, device=device),
                cand=torch.as_tensor(cand, device=device),
                x=torch.as_tensor(x, device=device))


def launch_split(call, checks, alloc, launch, kernel: str,
                 reps: int = 20) -> dict:
    """Where a wrapper call's time goes: ``events_ms`` (a), CUDA events
    around ``reps`` queued calls; ``host_us`` (b), host microseconds a
    call, and its parts ``checks_us`` (the argument checks and the
    dispatch), ``alloc_us`` (the output's allocation) and ``launch_us``
    (the stream lookup and the ctypes launch); ``device_ms`` (c), the
    kernel's own time a launch by the profiler.  A part that is None
    takes no time."""
    return dict(events_ms=cuda_ms(call, reps), host_us=host_us(call),
                checks_us=host_us(checks) if checks else 0.0,
                alloc_us=host_us(alloc) if alloc else 0.0,
                launch_us=host_us(launch),
                device_ms=kernel_ms(call, kernel, reps))


def ladder(device, reps: int = 20) -> dict:
    """Device ms a launch (profiler) of each rung of the floor's ladder
    (pk.FLOOR_RUNGS), the index naming the last of NB rows."""
    dev = torch.device(device)
    idx = torch.full((1,), NB - 1, dtype=torch.int32, device=dev)
    src = torch.ones((NB, 128), dtype=torch.float32, device=dev)
    out = torch.empty((128,), dtype=torch.float32, device=dev)
    return {r: kernel_ms(lambda: pk.floor_rung(r, idx, src, out),
                         f"floor_rung_kernel<{r}>", reps)
            for r in pk.FLOOR_RUNGS}


def splits(device, reps: int = 20) -> dict:
    """launch_split of the empty kernel (with ``stream_us``, the stream
    lookup alone) and of each feature smoke kernel on the scripts' inputs
    (mosaic_probe with every feature on), value checks off, as the events
    column times them."""
    dev = torch.device(device)
    out = {"null_launch": launch_split(
        lambda: pk.null_launch(dev), None, None,
        lambda: pk._call("null_launch", dev), "null_launch_kernel", reps)}
    out["null_launch"]["stream_us"] = host_us(
        lambda: torch.cuda.current_stream(dev).cuda_stream)

    cid, table, rays = gather_inputs(dev).values()
    o = torch.empty((cid.shape[0] * pk.SMOKE_RT, 1), dtype=torch.float32,
                    device=dev)
    out["smoke_gather"] = launch_split(
        lambda: pk.smoke_gather(cid, table, rays, check_values=False),
        lambda: pk.smoke_gather_args(cid, table, rays, check_values=False),
        lambda: torch.empty(o.shape, dtype=torch.float32, device=cid.device),
        lambda: pk._call("smoke_gather", cid.device, cid.data_ptr(),
                         table.data_ptr(), rays.data_ptr(), o.data_ptr(),
                         cid.shape[0]),
        "smoke_gather_kernel", reps)

    mask, table = rank_select_inputs(dev).values()
    o = torch.empty((1, 128), dtype=torch.float32, device=dev)
    out["smoke_rank_select"] = launch_split(
        lambda: pk.smoke_rank_select(mask, table),
        lambda: pk.smoke_rank_select_args(mask, table),
        lambda: torch.empty(o.shape, dtype=torch.float32,
                            device=mask.device),
        lambda: pk._call("smoke_rank_select", mask.device, mask.data_ptr(),
                         table.data_ptr(), o.data_ptr()),
        "smoke_rank_select_kernel", reps)

    ns, cand, x = mosaic_inputs(dev).values()
    o = torch.empty_like(x)
    out["mosaic_probe"] = launch_split(
        lambda: pk.mosaic_probe(ns, cand, x, "all", check_values=False),
        lambda: pk.mosaic_probe_args(ns, cand, x, "all",
                                     check_values=False),
        lambda: torch.empty_like(x),
        lambda: pk._call("mosaic_probe", ns.device, ns.data_ptr(),
                         cand.data_ptr(), x.data_ptr(), o.data_ptr(),
                         pk.MOSAIC_FEATURES["all"]),
        "mosaic_probe_kernel", reps)
    return out


def rank_select_by_mask(device, reps: int = 20) -> dict:
    """{mask: (set columns, device ms a launch by the profiler)} of
    smoke_rank_select on each of RANK_SELECT_DENSITIES' masks: how its
    time grows with the set columns."""
    out = {}
    for name, density in RANK_SELECT_DENSITIES.items():
        w = rank_select_random_inputs(device, density=density)
        out[name] = (set_columns(w["mask"]), kernel_ms(
            lambda: pk.smoke_rank_select(w["mask"], w["table"]),
            "smoke_rank_select_kernel", reps))
    return out


def by_mask_note(by_mask: dict, floor: dict) -> str:
    """One line of rank_select_by_mask against the empty kernel's."""
    cells = "; ".join(f"{name} ({n} set columns) {ms * 1e3:.2f} us, "
                      f"{ms / floor['device_ms']:.2f}x"
                      for name, (n, ms) in by_mask.items())
    return ("smoke_rank_select by mask, (c) device a launch by the profiler "
            f"against the empty kernel's: {cells}")


def split_note(s: dict, floor: dict) -> str:
    """One line of launch_split against the empty kernel's."""
    return (f"(a) {s['events_ms']:.4f} ms a call by events; (b) host "
            f"{s['host_us']:.1f} us a call: checks {s['checks_us']:.1f}, "
            f"allocation {s['alloc_us']:.1f}, stream lookup + ctypes launch "
            f"{s['launch_us']:.1f}; (c) device {s['device_ms'] * 1e3:.2f} "
            f"us a launch by the profiler, "
            f"{s['device_ms'] / floor['device_ms']:.2f}x the empty "
            "kernel's")


def hold_random_note() -> str:
    """What hold_random holds, with the set columns of each mask."""
    masks = {name: rank_select_random_inputs("cpu", density=d)["mask"]
             for name, d in RANK_SELECT_DENSITIES.items()}
    cols = ", ".join(f"{name} {set_columns(m)}" for name, m in masks.items())
    return ("smoke_gather (normal table and rays, a row named twice), "
            "smoke_rank_select (normal table; set columns of the masks: "
            f"{cols}; entries at 0.5 and just above it) and "
            "every mosaic_probe feature (ns 7, cand in {-1, 0, 1}, normal x "
            "with column 2 at -5) on seeded random inputs")


def hold_random(device):
    """smoke_gather, smoke_rank_select (on each of RANK_SELECT_DENSITIES'
    masks) and mosaic_probe (every feature, each on the seed the CPU tests
    use) against their plain versions on the random inputs, bit for bit;
    raises where they differ."""
    w = gather_random_inputs(device)
    args = (w["cid"], w["table"], w["rays"])
    if not torch.equal(pk.smoke_gather(*args),
                       pk.smoke_gather(*args, impl="plain")):
        raise RuntimeError("smoke_gather differs from its plain version on "
                           "the random inputs")
    for name, density in RANK_SELECT_DENSITIES.items():
        w = rank_select_random_inputs(device, density=density)
        args = (w["mask"], w["table"])
        if not torch.equal(pk.smoke_rank_select(*args),
                           pk.smoke_rank_select(*args, impl="plain")):
            raise RuntimeError(f"smoke_rank_select differs from its plain "
                               f"version on the random {name} mask")
    for feat in pk.MOSAIC_FEATURES:
        w = mosaic_random_inputs(device, len(feat))
        args = (w["ns"], w["cand"], w["x"])
        if not torch.equal(pk.mosaic_probe(*args, feat),
                           pk.mosaic_probe(*args, feat, impl="plain")):
            raise RuntimeError(f"mosaic_probe {feat} differs from its plain "
                               "version on the random inputs")


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

    hold_random(device)
    print(f"{hold_random_note()}: bit-identical to their plain versions",
          flush=True)
    split = splits(device, reps)
    print(floor_note(split["null_launch"], ladder(device, reps)),
          flush=True)
    for name in ("smoke_gather", "smoke_rank_select", "mosaic_probe"):
        print(f"{name} split: {split_note(split[name], split['null_launch'])}",
              flush=True)
    print(by_mask_note(rank_select_by_mask(device, reps),
                       split["null_launch"]), flush=True)
    return split


def floor_note(floor: dict, rungs: dict) -> str:
    """The empty kernel's split and the ladder's rungs, in one line."""
    steps = "; ".join(f"{pk.FLOOR_RUNGS[r]} {ms * 1e3:.2f}"
                      for r, ms in rungs.items())
    return (f"empty kernel: (a) {floor['events_ms']:.4f} ms a call by "
            f"events; (b) host {floor['host_us']:.1f} us a call, of which "
            f"the stream lookup + ctypes launch {floor['launch_us']:.1f} "
            f"(the stream lookup alone {floor['stream_us']:.1f}); (c) device "
            f"{floor['device_ms'] * 1e3:.2f} us a launch by the profiler: "
            f"the launch floor; the ladder, device us a launch by the "
            f"profiler: {steps}")
