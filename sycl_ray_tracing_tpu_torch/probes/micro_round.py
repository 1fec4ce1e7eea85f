"""Synthetic-round probe on the card (counterparts of scratch/micro_copy.py
and scratch/micro_super.py): where the per-round cost of a list kernel
goes — the tile gather (dyncopy), a static gather (statcopy), the
Möller–Trumbore arithmetic alone (mtonly), both (dynmt) — over 4096
sub-blocks of 8 rays x 16 rounds on random tiles, and the same work at 1,
8 and 32 sub-blocks per CUDA block (dynmt without the t > EPS test, as
micro_super.py ran it).  Reports ms and ns per block-round, and for the
copy variants the bytes staged and their rate.

At the probes' initial output 0 the MT variants' outputs are identically
0, on the TPU too: every output takes min(0, t) with t > EPS or 1e30;
without the EPS test t is still >= 0 up to rounding, because the
synthetic u, v and t are all the same plane offset times f, and a hit
needs u >= 0.  So a compiler may remove their arithmetic without changing
them.  Three checks show that the work ran: ``exact_check`` runs every MT
variant at every sub-block count from an initial +inf, where the output
is the least t over lanes and rounds, and holds it bit for bit against
the plain version (a value that needs every (ray, lane, round));
``sass_check`` counts the FP32 multiplies of each compiled variant
(cuobjdump -sass), one MT body for each lane a thread holds (a static
count); ``time_check`` asks mtonly, whose zeroed tile gives 1e30 from any
initial value, to take clearly longer than a round without the MT (a
count of what ran), on device times of calls queued ahead of the card
(``queued_ms``), each turn's ratio printed; ``profiled_times`` prints the
profiler's device time of the same calls beside them, a second witness
that the check does not read.

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
from sycl_ray_tracing_tpu_torch.probes.frame import kernel_ms

K2, T, RB, R = 1600, 128, pk.ROUND_RB, 16
INF = float("inf")
NB = 4096
SUBBLOCKS = (1, 8, 32)
MT_VARIANTS = ("mtonly", "dynmt", "dynmt_noeps")
# the synthetic MT of one (ray, lane) holds 21 multiplies (h 6, a 3,
# u/v/t 4 each); a variant that kept its work has one MT body per lane a
# thread holds (the kernel unrolls the loop over its 4 lanes)
MIN_MT_FMULS = pk.LANES_PER_THREAD * 21
# mtonly against the round without its MT, and the least ratio of their
# times: mtonly gathers nothing, so without its MT it is no slower than
# statcopy.  dynmt and dynmt_noeps overlap their copy with their MT, so
# no ratio to dyncopy bounds them: exact_check holds their work instead
MT_TIME_FLOORS = {"mtonly": ("statcopy", 2.0)}
# the time check's launches per measurement, and its measurements of each
# variant (taken in turns; the median counts)
CHECK_REPS, CHECK_TURNS = 10, 3


def workload(device, nb: int = NB, rounds: int = R, k2: int = K2) -> dict:
    """cand i32 [nb*8, rounds] random tile ids and tris f32 [k2, 9, 128]
    random normal tiles, drawn as micro_copy.py:53-55 draws them."""
    rng = np.random.default_rng(SEED)
    cand = rng.integers(0, k2, (nb * RB, rounds)).astype(np.int32)
    tris = rng.normal(size=(k2, 9, T)).astype(np.float32)
    return dict(cand=torch.as_tensor(cand, device=device),
                tris=torch.as_tensor(tris, device=device))


def staged_bytes(cand) -> int:
    """Bytes of the whole tiles a copy variant stages: one a (ray,
    round), though its output reads plane 0, lane 0 of each."""
    return cand.numel() * bounds.TILE_BYTES


def sass_check() -> dict:
    """FMUL count of each round_probe variant in the built library's SASS;
    raises if an MT variant kept fewer than one MT body per ray of the
    thread's lanes, or if the toolkit has no cuobjdump."""
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


def exact_check(cand, tris):
    """Every MT variant at every sub-block count from an initial +inf,
    held bit for bit against the plain version; raises on a difference.
    The output is then the least synthetic t over the ray's lanes and
    rounds, so a kernel that skipped any of them would differ."""
    for v in MT_VARIANTS:
        want = pk.round_probe(cand, tris, v, impl="plain", init=INF)
        for sb in SUBBLOCKS:
            got = pk.round_probe(cand, tris, v, sb, init=INF)
            same = torch.equal(got, want)
            print(f"exact check: {v} sub-blocks={sb} from +inf: "
                  f"bit-identical={same}, {int(torch.isfinite(got).sum())} "
                  f"finite outputs, min {float(got.min()):.6g}", flush=True)
            if not same:
                raise RuntimeError(f"round_probe {v} at {sb} sub-blocks "
                                   "differs from its plain version")


def queued_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn`` over ``reps`` calls
    queued behind a spin of the card (torch.cuda._sleep), so that the
    host's launch path never leaves the card idle between them: timed
    back to back, a 0.1 ms kernel can read the host's pace instead."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # ~10 ms: the host queues the calls
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _timed_variants() -> list:
    """The variants the time check reads: MT_TIME_FLOORS' and their
    bases."""
    return sorted(set(MT_TIME_FLOORS) | {b for b, _ in
                                         MT_TIME_FLOORS.values()})


def check_times(cand, tris) -> dict:
    """The time check's times: each variant MT_TIME_FLOORS names, queued
    (queued_ms), CHECK_TURNS times in turns, each turn's ratios printed;
    the median of each."""
    runs = {v: [] for v in _timed_variants()}
    for turn in range(CHECK_TURNS):
        for v in runs:
            runs[v].append(queued_ms(
                lambda: pk.round_probe(cand, tris, v), CHECK_REPS))
        for v, (base, _ratio) in MT_TIME_FLOORS.items():
            print(f"time check turn {turn}: {v} {runs[v][-1]:.4f} ms / "
                  f"{base} {runs[base][-1]:.4f} ms = "
                  f"{runs[v][-1] / runs[base][-1]:.3f}x", flush=True)
    return {v: float(np.median(t)) for v, t in runs.items()}


def profiled_times(cand, tris) -> dict:
    """The profiler's device ms per launch of each variant the time
    check reads, over CHECK_REPS back-to-back calls, with the ratios
    printed: a second witness beside check_times, not a check."""
    times = {v: kernel_ms(lambda: pk.round_probe(cand, tris, v),
                          "round_probe_kernel", CHECK_REPS)
             for v in _timed_variants()}
    for v, (base, _ratio) in MT_TIME_FLOORS.items():
        ratio = times[v] / times[base] if times[base] else float("nan")
        print(f"time witness (profiler): {v} {times[v]:.4f} ms / {base} "
              f"{times[base]:.4f} ms = {ratio:.3f}x", flush=True)
    return times


def time_check(times: dict):
    """Raise unless each variant of MT_TIME_FLOORS takes at least its
    floor ratio of the time of the same round without the MT: a body
    that ran once per block instead of once per (ray, lane, round) would
    not."""
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
        staged = "" if variant == "mtonly" else (
            f", {staged_bytes(cand) / 1e9:.3f} GB staged at "
            f"{staged_bytes(cand) / ms / 1e9:.3f} TB/s")
        print(f"{variant}: {ms:.4f} ms  ({ms * 1e6 / nb / rounds:.2f} ns per "
              f"block-round), "
              f"{bound_note(bounds.round_probe_work(cand, tris, variant))}"
              f"{staged}", flush=True)
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
    exact_check(cand, tris)
    sass_check()
    time_check(check_times(cand, tris))
    profiled_times(cand, tris)
    return times

