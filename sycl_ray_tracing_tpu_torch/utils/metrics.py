"""Metrics / profiling / observability (counterpart of
sycl_ray_tracing_tpu/utils/metrics.py).

Replaces the reference's wall-clock print + percent counter
(main.cpp:93,115-116; render_kernel.cpp:191,205-209) with structured
per-phase metrics: rays/s, per-stage timers, and a torch.profiler trace
hook.  PyTorch returns before the card finishes, so every timer here
synchronises the device of the result it waits for.

Spans and counters of the hot path (the port's own; the JAX package has
none):
  * ``span(name, **attrs)`` marks a layer boundary.  Off (the default)
    it is one flag test returning a shared no-op; inside ``tracing()``
    each span appends (name, start_ns, end_ns, span_id, parent_id,
    call_id, thread, attrs) to the list ``tracing()`` yields.  Times are
    ``time.time_ns()``, the clock torch.profiler (kineto) stamps its host
    records on, among them each CUDA launch; ``thread`` is
    ``threading.get_ident()``, whose low 32 bits CUPTI gives a launch
    record as its thread.  Stacks are per thread; a span opened on a
    thread with no open span while a top-level span is open elsewhere
    (autograd's device thread, replaying checkpointed bounces) takes the
    innermost span of the top-level span's thread as its parent.  A span
    with no parent starts a new call_id, which every span under it
    carries.
  * ``COUNTS`` / ``reset_counts()``: counters that are always on, in the
    style of ``listtrace.LAUNCHES``; ``host_read`` counts each blocking
    read of a device value by the host, ``tally`` any other event (the
    candidate builds: "cand_build.fused", "cand_build.plain"; the list
    tracer's passes, main or escalation: "query.passes").
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

# events since the last reset_counts(): "host_syncs" and
# "host_syncs.<site>", one a host_read, and the keys given to tally
COUNTS: Dict[str, int] = {}

_tracing = False
_spans: list = []
_stacks: Dict[int, list] = {}     # thread -> its open spans, innermost last
_root_thread: Optional[int] = None  # thread of the open top-level span
_span_ids = itertools.count(1)
_call_ids = itertools.count(1)
_lock = threading.Lock()


class _NoSpan:
    """The shared span of a tracer that is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "start", "sid", "parent", "call",
                 "thread")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        global _root_thread
        thread = threading.get_ident()
        with _lock:
            stack = _stacks.setdefault(thread, [])
            if stack:
                parent = stack[-1]
            elif _root_thread is not None and _stacks.get(_root_thread):
                # a worker thread runs for the caller that waits on it
                parent = _stacks[_root_thread][-1]
            else:
                parent = None
                _root_thread = thread
            self.sid = next(_span_ids)
            self.parent = None if parent is None else parent.sid
            self.call = next(_call_ids) if parent is None else parent.call
            self.thread = thread
            stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        with _lock:
            stack = _stacks.get(self.thread)
            if stack:
                stack.pop()
            _spans.append((self.name, self.start, end, self.sid,
                           self.parent, self.call, self.thread, self.attrs))
        return False


def span(name: str, **attrs):
    """Context manager marking ``name`` (a layer boundary) with ``attrs``;
    recorded only inside ``tracing()``."""
    if not _tracing:
        return _NO_SPAN
    return _Span(name, attrs)


@contextlib.contextmanager
def tracing():
    """Record spans inside the block; yields the list they are appended
    to as each one closes.  Nothing is written to disk."""
    global _tracing, _spans, _root_thread
    with _lock:
        _spans = []
        _stacks.clear()
        _root_thread = None
        _tracing = True
    try:
        yield _spans
    finally:
        _tracing = False


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


def tally(key: str):
    """Count one event under COUNTS[key]."""
    COUNTS[key] = COUNTS.get(key, 0) + 1


def host_read(site: str, tensor):
    """``tensor.item()``, a read that waits for the device: counted under
    COUNTS["host_syncs"] and COUNTS["host_syncs.<site>"], and inside
    ``tracing()`` recorded as the span ``sync.<site>``."""
    tally("host_syncs")
    tally("host_syncs." + site)
    if not _tracing:
        return tensor.item()
    with _Span("sync." + site, {}):
        return tensor.item()


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
    def phase(self, name: str, result=None):
        """Time the block under ``name``, also recorded as the span
        ``phase.<name>``.  ``result`` is accepted and ignored, as in the
        JAX package."""
        t0 = time.perf_counter()
        try:
            with span("phase." + name):
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
