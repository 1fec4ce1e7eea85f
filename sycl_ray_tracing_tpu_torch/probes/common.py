"""What the probes share: the card line, CUDA-event and host timing, and the
workloads the TPU probe scripts built (a surface wavefront on the dragon
stand-in, packed rays, lists with the dummy id).

The probes measure the card only: ``require_cuda`` raises without one.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from sycl_ray_tracing_tpu_torch.ops.intersect import BIG_T
from sycl_ray_tracing_tpu_torch.utils.device import resolve_device

SEED = 0


def require_cuda(device="cuda") -> torch.device:
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probes time the card: they need a CUDA "
                           "device")
    return dev


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls after one
    warm-up call, by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, n: int = 200) -> float:
    """Host microseconds per call of ``fn`` over ``n`` calls after one
    warm-up call, by the host clock.  No synchronise between calls: where
    the card runs each launch faster than the host issues the next, this
    is the host's launch path."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return t


def surface_wavefront(triangles: np.ndarray, n: int, device,
                      seed: int = SEED):
    """A bounce wavefront as kernel_shape_bench.py:52-58 and
    phase_bench4.py:63-72 build it: origins just inside random triangles'
    centroids, random unit directions, t_lim BIG_T."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, triangles.shape[0] - 4, n)
    o = triangles[idx].mean(axis=1) * 0.999
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    tl = torch.full((n,), BIG_T, dtype=torch.float32, device=device)
    return (torch.as_tensor(o, device=device),
            torch.as_tensor(d, device=device), tl)


def bound_note(work) -> str:
    """The H100 bound of (operations, bytes), for a measurement line."""
    from sycl_ray_tracing_tpu_torch.probes.bounds import bound

    ms, by = bound(*work)
    return f"bound {ms:.4g} ms by {by}"


def plain_line(label: str, fn):
    """Time one call of a kernel's plain version (after a warm-up call)
    and print it: the plain versions repeat the kernels' arithmetic on
    whole tensors and are no yardstick of speed."""
    ms = cuda_ms(fn, 1)
    print(f"{label}: plain version {ms:.3f} ms", flush=True)
    return ms


def pack_rays(o, d, tl):
    """[B, 8] rows o3 d3 t_lim anyhit=0."""
    return torch.cat([o, d, tl[:, None], torch.zeros_like(tl)[:, None]],
                     dim=1).contiguous()


def dummy_lists(cand, k2: int):
    """Candidate lists for the kernels: empty slots (-1) become the dummy
    id k2."""
    return torch.where(cand >= 0, cand, k2).to(torch.int32).contiguous()


def live_rounds_mean(cand_k, k2: int) -> float:
    """Mean number of non-dummy entries per list: the rounds a kernel runs
    (it skips dummy rounds)."""
    return float((cand_k != k2).sum(dim=1).float().mean())
