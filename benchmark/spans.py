"""The span pass of a traced run: the program's own spans and counters
(``sycl_ray_tracing_tpu_torch.utils.metrics``: ``tracing``, ``COUNTS``)
recorded beside the card's activity on one clock, and the card's device
time and idle time charged to the host span behind them.

``attribute`` is the arithmetic, a pure function of the records:
  * each CUDA kernel, memcpy and memset record goes to its launch, the
    CUDA runtime (or driver) record of the same correlation id, and the
    launch's host time to the innermost program span open then on the
    launching thread, else (a thread with no span of its own open, such
    as autograd's device thread between replays) to the innermost span
    open on any thread (the deepest; the thread that waits on it);
  * the device records are placed on the host's clock by ``replay``
    (the profiler's device timestamps drift against its host records),
    and each idle interval of a call (its window less the union of its
    placed records) is split over the innermost spans open along it;
  * host time outside every span is the render entry's (``(none)``); a
    device record with no launch record stays ``(unmatched)``, counted,
    never dropped.
Spans map to the layers of PERF.md §3 through ``GROUPS``.

``span_pass`` runs the calls under ``metrics.tracing()`` and the same
CUDA-only torch.profiler recording as ``trace.profiled``, but keeps the
runtime records that ``trace.profiled`` drops.  ``reading`` is what the
span metrics' readers call: the loops' traced reading (loops._traced)
holds no program state, so the pass builds the cell anew from the run's
own arguments (``--workload``, ``--seed``) after the check, warms it as
its set-up does, runs it once a run and keeps the result in the record.
A program without spans (no ``metrics.tracing``) reads nothing.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import sys
import time

import torch

from benchmark import trace

NONE = "(none)"                # host time outside every program span
UNMATCHED = "(unmatched)"      # a device record with no launch record
EARLY_NS = 5_000               # slack of a kernel starting before its launch
# CUPTI names a CUDA API record's thread by the low 32 bits of its
# pthread id; the program's spans name theirs by threading.get_ident()
THREAD_MASK = 0xFFFFFFFF

GROUPS = {
    "render": "entry", "render.tile": "entry", "train.step": "entry",
    "train.target": "entry", "train.guess": "entry", NONE: "entry",
    "trace.primary": "shading", "trace.bounce": "shading",
    "bounce.compact": "shading", "rng.draw": "rng",
    "query": "query", "query.pass": "query", "query.build": "query",
    "query.kernel": "query", "query.escalate": "query",
    "train.backward": "backward", UNMATCHED: "unmatched",
}
BACKWARD = "train.backward"


def group(name: str) -> str:
    if name.startswith("sync."):
        return "sync"
    return GROUPS.get(name, "entry")


def records(prof):
    """(device, launches) of a finished torch.profiler: device =
    [(start_ns, end_ns, name, correlation, stream)] of its CUDA activity
    records, launches = {correlation: (start_ns, thread)} of the host's
    CUDA API records."""
    device, launches = [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if getattr(e, "is_user_annotation", lambda: False)():
                continue
            device.append((e.start_ns(), e.end_ns(), e.name(),
                           e.correlation_id(), e.device_resource_id()))
        elif e.correlation_id():
            had = launches.get(e.correlation_id())
            if had is None or e.start_ns() < had[0]:
                launches[e.correlation_id()] = (e.start_ns(),
                                                e.device_resource_id())
    return device, launches


def replay(device, launches) -> list:
    """[(start_ns, end_ns)] of each device record on the host's clock.
    The profiler's device timestamps drift against its host records (on
    the H100 with torch 2.11, kernels read up to ms before their own
    launch, the offset changing within a call), so a record's duration is
    kept but its place is taken from the host: on its stream, in launch
    order, each starts at the later of its launch record's start and the
    end of the one before it.  A record with no launch keeps its own
    times."""
    out = [None] * len(device)
    streams = {}
    for k, rec in enumerate(device):
        if rec[3] in launches:
            streams.setdefault(rec[4], []).append(
                (launches[rec[3]][0], k))
        else:
            out[k] = (rec[0], rec[1])
    for order in streams.values():
        t = None
        for host, k in sorted(order):
            start = host if t is None else max(host, t)
            t = start + device[k][1] - device[k][0]
            out[k] = (start, t)
    return out


def _depths(spans) -> dict:
    parent = {s[3]: s[4] for s in spans}
    depth = {}
    for sid in parent:
        chain = []
        while sid is not None and sid in parent and sid not in depth:
            chain.append(sid)
            sid = parent[sid]
        d = depth.get(sid, -1)
        for x in reversed(chain):
            d += 1
            depth[x] = d
    return depth


def _timeline(spans, depth):
    """(starts, segments): [(start_ns, end_ns, span)] of the innermost
    span open along the time ``spans`` cover (the deepest; of equal depth
    the later started), in order, and their starts."""
    events = [(s[1], 1, i) for i, s in enumerate(spans)]
    events += [(s[2], 0, i) for i, s in enumerate(spans)]
    events.sort(key=lambda e: (e[0], e[1]))
    open_, segs, cur, t0 = set(), [], None, None
    for t, kind, i in events:
        if cur is not None and t > t0:
            if segs and segs[-1][2] is cur and segs[-1][1] == t0:
                segs[-1] = (segs[-1][0], t, cur)
            else:
                segs.append((t0, t, cur))
        if kind:
            open_.add(i)
        else:
            open_.discard(i)
        cur = (spans[max(open_, key=lambda j: (depth[spans[j][3]],
                                               spans[j][1]))]
               if open_ else None)
        t0 = t
    return [s[0] for s in segs], segs


def _at(line, t):
    """The span of the timeline ``line`` open at ``t``, or None."""
    if line is None:
        return None
    starts, segs = line
    k = bisect.bisect_right(starts, t) - 1
    if k >= 0 and segs[k][0] <= t < segs[k][1]:
        return segs[k][2]
    return None


def _split(line, a, b, into: dict):
    """Adds the part of [a, b) each span of ``line`` covers to
    into[span name], the rest to into[NONE]."""
    starts, segs = line
    k = max(0, bisect.bisect_right(starts, a) - 1)
    covered = 0
    while k < len(segs) and segs[k][0] < b:
        lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
        if hi > lo:
            into[segs[k][2][0]] = into.get(segs[k][2][0], 0) + hi - lo
            covered += hi - lo
        k += 1
    if b - a > covered:
        into[NONE] = into.get(NONE, 0) + (b - a) - covered


def _gaps(intervals, c0, c1) -> list:
    """The gaps the union of the sorted (start, end) ``intervals`` leaves
    in [c0, c1)."""
    gaps, t = [], c0
    for s, e in intervals:
        if s >= c1 or e <= c0:
            continue
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if c1 > t:
        gaps.append((t, c1))
    return gaps


def _overlap(intervals, a, b) -> int:
    return sum(max(0, min(b, e) - max(a, s)) for s, e in intervals)


def attribute(spans, device, launches, calls) -> dict:
    """The span pass's arithmetic (see the module docstring).  ``spans``:
    the program's span records; ``device``, ``launches``: as ``records``
    returns them; ``calls``: [(start_ns, end_ns)] of each call on the
    host's clock, a synchronise at its end.  Times in seconds, summed
    over the calls."""
    depth = _depths(spans)
    everywhere = _timeline(spans, depth)
    by_thread = {}
    for s in spans:
        by_thread.setdefault(s[6] & THREAD_MASK, []).append(s)
    by_thread = {th: _timeline(ss, depth) for th, ss in by_thread.items()}
    backward = [(s[1], s[2]) for s in spans if s[0] == BACKWARD]

    dev, ops, n_unmatched, early, own_thread = {}, {}, 0, 0, 0
    backward_dev = 0
    for start, end, op, corr, _stream in device:
        dur = end - start
        launch = launches.get(corr)
        if launch is None:
            dev[UNMATCHED] = dev.get(UNMATCHED, 0) + dur
            n_unmatched += 1
            continue
        host, thread = launch
        if start < host - EARLY_NS:
            early += 1
        span = _at(by_thread.get(thread & THREAD_MASK), host)
        own_thread += span is not None
        if span is None:
            span = _at(everywhere, host)
        name = NONE if span is None else span[0]
        dev[name] = dev.get(name, 0) + dur
        key = (group(name), trace.short(op))
        ops[key] = ops.get(key, 0) + dur
        if any(a <= host < b for a, b in backward):
            backward_dev += dur

    placed = sorted(replay(device, launches))
    raw = sorted((r[0], r[1]) for r in device)
    idle, idle_union, backward_idle, raw_idle = {}, 0, 0, 0
    for c0, c1 in calls:
        for a, b in _gaps(placed, c0, c1):
            idle_union += b - a
            _split(everywhere, a, b, idle)
            backward_idle += _overlap(backward, a, b)
        raw_idle += sum(b - a for a, b in _gaps(raw, c0, c1))

    # the host's clock is the spans': each blocking read's span holds the
    # start of a CUDA API record (its copy or synchronise)
    api = sorted(h for h, _t in launches.values())
    syncs = [sp for sp in spans if sp[0].startswith("sync.")]
    held = sum(bisect.bisect_right(api, sp[2]) > bisect.bisect_left(
        api, sp[1]) for sp in syncs)

    def seconds(d):
        return {k: v / 1e9 for k, v in d.items()}

    def by_group(d):
        out = {}
        for k, v in d.items():
            out[group(k)] = out.get(group(k), 0.0) + v / 1e9
        return out

    total_dev = sum(dev.values())
    matched = total_dev - dev.get(UNMATCHED, 0)
    return {
        "calls": len(calls),
        "wall_s": sum(c1 - c0 for c0, c1 in calls) / 1e9,
        "device_s": total_dev / 1e9,
        "idle_s": idle_union / 1e9,
        "idle_split_s": sum(idle.values()) / 1e9,
        "raw_idle_s": raw_idle / 1e9,
        "device_by_span": seconds(dev), "idle_by_span": seconds(idle),
        "device_by_group": by_group(dev), "idle_by_group": by_group(idle),
        "device_by_op": [[g, op, v / 1e9] for (g, op), v in sorted(
            ops.items(), key=lambda kv: -kv[1])[:10]],
        "backward_device_s": backward_dev / 1e9,
        "backward_idle_s": backward_idle / 1e9,
        "matched_share": matched / total_dev if total_dev else None,
        "unmatched_records": n_unmatched,
        "early_launches": early,
        "own_thread_launches": own_thread,
        "device_records": len(device),
        "sync_spans_holding_api": held / len(syncs) if syncs else None,
    }


def span_pass(call, keys, dev) -> dict:
    """Each ``call(i)`` of ``keys`` under the program's tracing and, on a
    card, torch.profiler's CUDA activity; the program's counters reset
    before each call.  Returns {"spans", "calls" ([(start_ns, end_ns)]),
    "counts" ([{counter: value}] a call), "device", "launches"}."""
    from sycl_ray_tracing_tpu_torch.utils import metrics

    cuda = dev.type == "cuda"
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(dev)
        recorder = profile(activities=[ProfilerActivity.CUDA])
    else:
        recorder = contextlib.nullcontext()
    calls, counts = [], []
    with recorder as prof:
        with metrics.tracing() as spans:
            for i in keys:
                metrics.reset_counts()
                c0 = time.time_ns()
                call(i)
                if cuda:
                    torch.cuda.synchronize(dev)
                calls.append((c0, time.time_ns()))
                counts.append(dict(metrics.COUNTS))
    device, launches = records(prof) if cuda else ([], {})
    return {"spans": list(spans), "calls": calls, "counts": counts,
            "device": device, "launches": launches}


def _top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def _run_args():
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--trace", type=int, default=0)
    args, _ = ap.parse_known_args(sys.argv[1:])
    if args.workload is None or args.seed is None or args.trace != 1:
        return None
    return args


def measure(cell_name: str, seed: int, root, dev) -> dict | None:
    """Builds the cell ``cell_name`` of the benchmark at ``root`` on
    ``dev`` from ``seed`` as its set-up does, warms it, and returns its
    span pass over loops.TRACED_CALLS calls with the attribution, or None
    when the program has no spans."""
    from sycl_ray_tracing_tpu_torch.utils import metrics

    if not hasattr(metrics, "tracing"):
        return None
    from benchmark import inputs, loops, manifest
    from benchmark.reference import rng

    spec = manifest.load(root.parent)
    cell = manifest.cell(spec, cell_name)
    cfg = inputs.load_config(cell["config"], root)
    traffic = manifest.traffic(cell["traffic"], root)
    data = inputs.scene_arrays(cfg)
    if traffic["kind"] == "progressive":
        frames = loops.Frames(data, cfg, dev)
        base = rng.key_of_seed(seed)
        for j in range(traffic["warm_calls"]):
            frames.frame(base, loops.WARM_KEY + j)
        rec = span_pass(lambda i: frames.frame(base, i),
                        range(loops.TRACED_CALLS), dev)
        del frames
    else:
        run = loops.Trainer(data, loops.program_scene(data, dev), cfg,
                            traffic, seed, dev)
        n = traffic["reference_steps"]
        run.first_steps(n)
        rec = span_pass(run.step, range(n, n + loops.TRACED_CALLS), dev)
        del run
    loops.free(dev)
    out = attribute(rec["spans"], rec["device"], rec["launches"],
                    rec["calls"])
    out["spans_a_call"] = len(rec["spans"]) / len(rec["calls"])
    keys = sorted({k for c in rec["counts"] for k in c})
    out["counts_a_call"] = {k: sum(c.get(k, 0) for c in rec["counts"])
                            / len(rec["counts"]) for k in keys}
    return out


def reading(rec: dict, root) -> dict | None:
    """The span pass of this run, made by the first reader that asks (in
    a ``--trace 1`` run) and kept in ``rec``; it also adds idle_by_span,
    device_by_span and the pass's summary to the run's breakdown and
    prints one line on standard error.  None when the program has no
    spans or the run's arguments name no traced cell."""
    if "span_pass" in rec:
        return rec["span_pass"]
    rec["span_pass"] = None
    args = _run_args()
    if args is None:
        return None
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    out = measure(args.workload, args.seed, root, dev)
    if out is None:
        return None
    rec["span_pass"] = out
    summary(rec, out)
    return out


def unprofiled_idle_s(rec: dict) -> float:
    """The idle seconds of an unprofiled call: the window's mean call less
    the profiled pass's busy union a call (device_idle.*'s base)."""
    mean = sum(rec["call_s"]) / len(rec["call_s"])
    return mean - rec["busy_s"] / rec["traced_calls"]


def summary(rec: dict, out: dict):
    """The span pass in the run's breakdown and one line on stderr."""
    n = out["calls"]
    prof_wall = rec["traced_wall_s"] / rec["traced_calls"] \
        if "traced_wall_s" in rec else None
    share = out["matched_share"]
    syncs = out["counts_a_call"].get("host_syncs", 0)
    if "breakdown" in rec:
        rec["breakdown"]["idle_by_span"] = _top(out["idle_by_span"])
        rec["breakdown"]["device_by_span"] = _top(out["device_by_span"])
        rec["breakdown"]["device_ops_by_layer"] = out["device_by_op"]
        rec["breakdown"]["span_pass"] = {
            "calls": n, "wall_s_a_call": out["wall_s"] / n,
            "profiled_wall_s_a_call": prof_wall,
            "spans_a_call": out["spans_a_call"],
            "counts_a_call": out["counts_a_call"],
            "idle_by_layer": out["idle_by_group"],
            "device_by_layer": out["device_by_group"],
            "idle_s": out["idle_s"], "idle_split_s": out["idle_split_s"],
            "raw_idle_s": out["raw_idle_s"],
            "sync_spans_holding_api": out["sync_spans_holding_api"],
            "matched_share": share,
            "unmatched_records": out["unmatched_records"],
            "early_launches": out["early_launches"],
            "own_thread_launches": out["own_thread_launches"],
            "device_records": out["device_records"]}
    print(f"span pass: {out['wall_s'] / n:.4f} s a call with spans under "
          f"the profiler (profiled pass {prof_wall!r} s a call); "
          f"{out['spans_a_call']:.1f} spans and {syncs:.1f} host syncs a "
          f"call; device time matched to a launch {share!r}; "
          f"{out['early_launches']} of {out['device_records']} records "
          f"start before their launch on the profiler's device clock; "
          f"sync spans holding an API record "
          f"{out['sync_spans_holding_api']!r}; idle {out['idle_s']:.6f} s "
          f"placed ({out['raw_idle_s']:.6f} s as recorded), split "
          f"{out['idle_split_s']:.6f} s",
          file=sys.stderr, flush=True)


def _device_read(rec: dict, root):
    """The span pass of a run with device records, else None (a program
    without spans, or no card)."""
    out = reading(rec, root)
    if out is None or not out["device_records"]:
        return None
    return out


def idle_ms(rec: dict, root, groups) -> float | None:
    """The layers ``groups``' share of the span pass's idle time times the
    idle of an unprofiled call, in ms."""
    out = _device_read(rec, root)
    if out is None:
        return None
    part = sum(out["idle_by_group"].get(g, 0.0) for g in groups)
    return 1e3 * part / out["idle_s"] * unprofiled_idle_s(rec)


def device_ms(rec: dict, root, groups) -> float | None:
    """Device ms a call of the records launched from the layers
    ``groups``."""
    out = _device_read(rec, root)
    if out is None:
        return None
    part = sum(out["device_by_group"].get(g, 0.0) for g in groups)
    return 1e3 * part / out["calls"]


def backward_ms(rec: dict, root, what: str) -> float | None:
    """Ms a call while train.backward is open, on any thread: ``what`` is
    "device" (the records launched then) or "idle" (its share of the
    pass's idle time times the idle of an unprofiled call)."""
    out = _device_read(rec, root)
    if out is None:
        return None
    if what == "device":
        return 1e3 * out["backward_device_s"] / out["calls"]
    return 1e3 * out["backward_idle_s"] / out["idle_s"] \
        * unprofiled_idle_s(rec)


def host_syncs(rec: dict, root) -> float | None:
    """The program's blocking reads a call (COUNTS["host_syncs"])."""
    out = reading(rec, root)
    if out is None:
        return None
    return out["counts_a_call"].get("host_syncs", 0.0)
