"""What the traced run reads from the card: CUDA activity under
torch.profiler, the candidate builds' device time, and the list kernels'
inputs for their roofline.

``profiled`` records CUDA activity only and reads the profiler's raw
records, as ``probes/frame.profile`` does (recording the host's ops too
slowed an 870k frame by a third and took ~28-50 s to read).
``build_device_s`` is a frozen copy of ``probes/frame.build_ms`` (commit
e337019): the builds a call makes are recorded, then replayed back to
back under the profiler, so their device time holds no host path.
``KernelInputs`` wraps the list kernels' wrappers from the benchmark's
side and counts each launch's work on its own inputs.  Nothing here is
written to disk.
"""

from __future__ import annotations

import time

import torch

from benchmark import bounds

KERNELS = {"block_tiles": "block_tiles_kernel",
           "list_tiles": "list_tiles_kernel"}
BUILDS = ("candidate_clusters_hier", "candidate_clusters_grouped",
          "candidate_clusters")


def profiled(fns) -> dict:
    """Run each of ``fns`` once under torch.profiler (CUDA activity), each
    ended by a synchronise, and return {"walls": [s], "events": [(start s,
    end s, name)] of every CUDA activity record}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", lambda: False)():
            continue
        events.append((e.start_ns() / 1e9, e.end_ns() / 1e9, e.name()))
    return {"walls": walls, "events": events}


def kernel_seconds(events) -> dict:
    """{kernel: (launches, device seconds)} of the list kernels."""
    out = {}
    for k, sub in KERNELS.items():
        hits = [e - s for s, e, name in events if sub in name]
        out[k] = (len(hits), sum(hits))
    return out


def short(name: str) -> str:
    """A kernel's name without its namespaces, at most 160 letters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "at_cuda_detail::", "binary_internal::"):
        name = name.replace(noise, "")
    return name[:160]


def top_ops(events, n: int = 10) -> list:
    """[[name, device seconds]] of the ``n`` device ops with the most time."""
    tot = {}
    for s, e, name in events:
        tot[name] = tot.get(name, 0.0) + (e - s)
    return [[short(k), v] for k, v in
            sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def build_device_s(call, lt) -> tuple[int, float]:
    """(builds, device seconds) of the candidate builds one ``call()``
    makes through the list tracer's module ``lt``: recorded during the
    call, then replayed back to back under the profiler."""
    orig = {name: getattr(lt, name) for name in BUILDS}
    made = []

    def recorder(name):
        def record(*args, **kw):
            made.append((name, args, kw))
            return orig[name](*args, **kw)
        return record

    for name in BUILDS:
        setattr(lt, name, recorder(name))
    try:
        call()
    finally:
        for name in BUILDS:
            setattr(lt, name, orig[name])
    if not made:
        # every call of a cell builds candidate lists: none seen means the
        # builds run under names this recorder does not wrap
        raise RuntimeError("no candidate build seen through " + ", ".join(
            BUILDS) + " in a call")
    rec = profiled([lambda: [orig[n](*a, **kw) for n, a, kw in made]])
    return len(made), sum(e - s for s, e, _ in rec["events"])


class KernelInputs:
    """Inside ``with``: every block_tiles and list_tiles launch through
    the list tracer's module ``lt`` adds the bound of its work on its own
    inputs to ``bound_s[kernel]`` and one to ``launches[kernel]``."""

    def __init__(self, lt):
        self.lt = lt
        self.bound_s = {k: 0.0 for k in KERNELS}
        self.launches = {k: 0 for k in KERNELS}

    def __enter__(self):
        self.orig = {k: getattr(self.lt, k) for k in KERNELS}

        def wrap(k):
            def launch(cand, ctn, rays, tris, *a, **kw):
                out = self.orig[k](cand, ctn, rays, tris, *a, **kw)
                self.bound_s[k] += bounds.bound_s(
                    *bounds.tiles_work(cand, rays, tris))
                self.launches[k] += 1
                return out
            return launch

        for k in KERNELS:
            setattr(self.lt, k, wrap(k))
        return self

    def __exit__(self, *exc):
        for k, f in self.orig.items():
            setattr(self.lt, k, f)
        return False
