"""Synthetic-round probe on the card (counterparts of scratch/micro_copy.py
and scratch/micro_super.py): where the per-round cost of a list kernel
goes — the tile gather (dyncopy), a static gather (statcopy), the
Möller–Trumbore arithmetic alone (mtonly), both (dynmt) — over 4096
sub-blocks of 8 rays x 16 rounds on random tiles, and the same work at 1,
8 and 32 sub-blocks per CUDA block (dynmt without the t > EPS test, as
micro_super.py ran it).  Reports ms and ns per block-round.

The MT variants' outputs are identically 0, on the TPU too: every output
starts at 0 and takes min(0, t) with t > EPS or 1e30; without the EPS
test t is still >= 0 up to rounding, because the synthetic u, v and t are
all the same plane offset times f, and a hit needs u >= 0.  So a
compiler may remove their arithmetic without changing them.  Two checks
show that nvcc kept the work: ``sass_check`` counts the FP32 multiplies
of each compiled variant (cuobjdump -sass), one MT body for each of the
sub-block's 8 rays (a static count); ``time_check`` asks each MT
variant to take clearly longer than the same round without the MT (a
count of what ran).

    python -m sycl_ray_tracing_tpu_torch.probes micro_round
"""

from __future__ import annotations

import re
import shutil
import subprocess
from pathlib import Path

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

K2, T, RB, R = 1600, 128, pk.ROUND_RB, 16
NB = 4096
SUBBLOCKS = (1, 8, 32)
MT_VARIANTS = ("mtonly", "dynmt", "dynmt_noeps")
# the synthetic MT of one (ray, lane) holds 21 multiplies (h 6, a 3,
# u/v/t 4 each); a variant that kept its work has one MT body per ray of
# the sub-block (the kernel unrolls the loop over its 8 rays)
MIN_MT_FMULS = RB * 21
# each MT variant against the round without its MT, and the least ratio
# of their times: mtonly gathers nothing, so without its MT it is no
# slower than statcopy; dynmt without its MT is dyncopy.  Measured on an
# H100 80GB HBM3 at 700 W (chip_smoke.py phase 5): mtonly 3.1x statcopy,
# dynmt 1.5x dyncopy
MT_TIME_FLOORS = {"mtonly": ("statcopy", 2.0), "dynmt": ("dyncopy", 1.2),
                  "dynmt_noeps": ("dyncopy", 1.2)}


def workload(device, nb: int = NB, rounds: int = R, k2: int = K2) -> dict:
    """cand i32 [nb*8, rounds] random tile ids and tris f32 [k2, 9, 128]
    random normal tiles, drawn as micro_copy.py:53-55 draws them."""
    rng = np.random.default_rng(SEED)
    cand = rng.integers(0, k2, (nb * RB, rounds)).astype(np.int32)
    tris = rng.normal(size=(k2, 9, T)).astype(np.float32)
    return dict(cand=torch.as_tensor(cand, device=device),
                tris=torch.as_tensor(tris, device=device))


def sass_check() -> dict:
    """FMUL count of each round_probe variant in the built library's SASS;
    raises if an MT variant kept fewer than one MT body per ray of the
    sub-block, or if the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise RuntimeError("sass check: the CUDA toolkit has no cuobjdump")
    lib = pk.load_cuda_library()
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts, current = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*round_probe_kernelILi(\d)E", line)
        if m:
            current = pk.ROUND_VARIANTS[int(m.group(1))]
            counts[current] = 0
        elif "Function :" in line:
            current = None
        elif current and re.search(r"\bFMUL\b", line):
            counts[current] += 1
    print(f"sass check: FMUL instructions per round_probe variant {counts}",
          flush=True)
    for v in MT_VARIANTS:
        if counts.get(v, 0) < MIN_MT_FMULS:
            raise RuntimeError(f"round_probe {v}: {counts.get(v, 0)} FMULs in "
                               "its SASS; nvcc removed the MT work")
    return counts


def time_check(times: dict):
    """Raise unless each MT variant takes at least its floor ratio of the
    time of the same round without the MT (MT_TIME_FLOORS): a body that
    ran once per block instead of once per (ray, lane, round) would not."""
    for v, (base, ratio) in MT_TIME_FLOORS.items():
        got = times[v] / times[base]
        print(f"time check: {v} {times[v]:.4f} ms = {got:.2f}x {base} "
              f"{times[base]:.4f} ms (floor {ratio}x)", flush=True)
        if got < ratio:
            raise RuntimeError(f"round_probe {v} took {got:.2f}x {base}'s "
                               f"time, under {ratio}x: its MT work is gone")


def run(device, reps: int = 5, work: dict | None = None):
    work = work or workload(device)
    cand, tris = work["cand"], work["tris"]
    nb = cand.shape[0] // RB
    rounds = cand.shape[1]
    times = {}
    for variant in ("dyncopy", "statcopy", "mtonly", "dynmt"):
        ms = cuda_ms(lambda: pk.round_probe(cand, tris, variant), reps)
        times[variant] = ms
        print(f"{variant}: {ms:.4f} ms  ({ms * 1e6 / nb / rounds:.2f} ns per "
              f"block-round), "
              f"{bound_note(bounds.round_probe_work(cand, tris, variant))}",
              flush=True)
        plain_line(variant, lambda: pk.round_probe(cand, tris, variant,
                                                   impl="plain"))
    for sb in SUBBLOCKS:
        ms = cuda_ms(lambda: pk.round_probe(cand, tris, "dynmt_noeps", sb),
                     reps)
        if sb == 1:
            times["dynmt_noeps"] = ms
        work = bounds.round_probe_work(cand, tris, "dynmt_noeps")
        print(f"sb={sb:2d} grid={nb // sb}: {ms:.4f} ms "
              f"({ms * 1e6 / nb / rounds:.2f} ns/sub-block-round), "
              f"{bound_note(work)}", flush=True)
    plain_line("dynmt_noeps (any sub-blocks)", lambda: pk.round_probe(
        cand, tris, "dynmt_noeps", impl="plain"))
    sass_check()
    time_check(times)
    return times

