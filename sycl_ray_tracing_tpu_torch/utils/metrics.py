"""Metrics / profiling / observability (counterpart of
sycl_ray_tracing_tpu/utils/metrics.py).

Replaces the reference's wall-clock print + percent counter
(main.cpp:93,115-116; render_kernel.cpp:191,205-209) with structured
per-phase metrics: rays/s, per-stage timers, and a torch.profiler trace
hook.  PyTorch returns before the card finishes, so every timer here
synchronises the device of the result it waits for.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def sync(x) -> None:
    """Wait until the card has finished the work behind ``x`` (a tensor or
    a nest of them): ``torch.cuda.synchronize`` on its device.  CPU
    tensors are complete when returned."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


@dataclass
class RenderMetrics:
    """Accumulates per-phase timings and ray counts for one render."""

    timers: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timers[name] = (self.timers.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def timed(self, name: str, fn, *args):
        """Run fn, sync its output, record the wall time; returns result."""
        t0 = time.perf_counter()
        out = fn(*args)
        sync(out)
        self.timers[name] = (self.timers.get(name, 0.0)
                             + time.perf_counter() - t0)
        return out

    def count(self, name: str, value: float) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + value

    def rays_per_second(self, rays_key: str = "rays",
                        time_key: str = "render") -> float:
        t = self.timers.get(time_key, 0.0)
        return self.counters.get(rays_key, 0.0) / t if t > 0 else 0.0

    def report(self) -> dict:
        out = {f"time/{k}": round(v, 4) for k, v in self.timers.items()}
        out.update({f"count/{k}": v for k, v in self.counters.items()})
        if "rays" in self.counters and "render" in self.timers:
            out["Mrays_per_s"] = round(self.rays_per_second() / 1e6, 3)
        return out

    def dump(self) -> str:
        return json.dumps(self.report())


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """torch.profiler scope that writes ``log_dir/trace.json`` (a chrome
    trace) on exit and yields the profiler; a no-op yielding None when
    log_dir is None.  Records the host's ops, and the card's when CUDA is
    available."""
    if log_dir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_op_totals(prof) -> Dict[str, tuple]:
    """{op name: (launches, device µs)} of the CUDA activity a finished
    torch.profiler recorded, read from its raw records (no event tree)."""
    tot: Dict[str, tuple] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        n, us = tot.get(e.name(), (0, 0.0))
        tot[e.name()] = (n + 1, us + e.duration_ns() / 1e3)
    return tot


def device_op_times(prof, top: int = 15) -> List[tuple]:
    """The ``top`` device ops of a finished torch.profiler by time, as
    (op, µs) pairs (hlo_op_times' counterpart); empty when the profiler
    saw no CUDA activity."""
    tot = device_op_totals(prof)
    return sorted(((name, us) for name, (_n, us) in tot.items()),
                  key=lambda kv: -kv[1])[:top]
