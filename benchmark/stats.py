"""The benchmark's arithmetic: rays a frame, the window's rate, the tail,
the device's busy union and idle share.

The ray count and the timing rule are frozen from
sycl_ray_tracing_tpu_torch/bench.py at commit e337019: a frame is
W*H*spp*bounces rays (its NEE queries are not counted), and a call's
clock stops after ``torch.cuda.synchronize()`` and the copy of its result
to the host.
"""

from __future__ import annotations

import statistics


def rays_per_frame(cfg: dict) -> int:
    return cfg["width"] * cfg["height"] * cfg["samples"] * cfg["bounces"]


def rate(calls: int, per_call: float, window_s: float) -> float:
    """Work a second over the whole window: every call completed in it,
    over its whole length (the last call ends the window)."""
    return calls * per_call / window_s


def p90(values) -> float:
    """The 90th percentile of every value, interpolated between order
    statistics (``statistics.quantiles``' inclusive method)."""
    vals = list(values)
    if len(vals) == 1:
        return vals[0]
    return statistics.quantiles(vals, n=10, method="inclusive")[8]


def union(intervals) -> tuple[float, list]:
    """(seconds covered by the union of (start_s, end_s, name) intervals,
    the gaps between the merged intervals as (seconds, name of the
    interval that ended before the gap))."""
    busy = 0.0
    gaps = []
    end, last = None, None
    start = None
    for s, e, name in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                busy += end - start
                gaps.append((s - end, last))
            start, end, last = s, e, name
        elif e > end:
            end, last = e, name
    if end is not None:
        busy += end - start
    return busy, gaps


def idle_share(busy_s: float, mean_call_s: float, calls: int) -> float:
    """One minus the busy union of ``calls`` profiled calls over the wall
    time the same calls take unprofiled, as a percentage."""
    return 100.0 * (1.0 - busy_s / (mean_call_s * calls))
