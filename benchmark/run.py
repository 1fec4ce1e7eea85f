"""One run of one benchmark cell of the port (sycl_ray_tracing_tpu_torch)
on the card it is started on:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

It makes the cell's inputs from its configuration and the seed, sets the
program up and warms it (set-up), drives the cell's closed loop for
``--seconds`` (the window), with ``--trace 1`` reads the per-layer
metrics from profiled calls after the window, then frees the program's
state and checks what the window produced against the plain reference
of the configuration's estimator (benchmark/reference/estimators/).
Its last line on standard output is one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), device, with ``--trace 1`` the
breakdown, the native libraries this run built in its set-up (a
checkout's first run builds them) and last the checks, each number
beside its limit; the checks are also the last lines on standard error.

It exits 2 on a bad argument, or before any set-up where the
configuration's estimator has no reference that the cell's check can
call; 3 without CUDA or with fewer cards than the cell asks for; 4 if
jax, jaxlib, flax or the JAX package was loaded; and prints no result
then.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sycl_ray_tracing_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    FORBIDDEN (sycl_ray_tracing_tpu_torch is not sycl_ray_tracing_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(spec: dict, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, root=None) -> dict:
    """Drive one cell on ``device`` and return its result object."""
    import torch

    from benchmark import inputs, loops, manifest
    from benchmark.reference import estimators

    root = manifest.ROOT if root is None else root
    cell = manifest.cell(spec, name)
    cfg = inputs.load_config(cell["config"], root)
    traffic = manifest.traffic(cell["traffic"], root)
    # a cell whose check has no reference to call fails here, not after
    # its set-up and window as not correct
    estimators.load(cfg["estimator"], root,
                    loops.REFERENCE_NEEDS[traffic["kind"]])
    ctx = loops.Context(cfg, traffic, seed, seconds, trace,
                        torch.device(device), t_start, root)
    record, checks, failed = loops.LOOPS[traffic["kind"]](ctx)
    print(f"setup {record['setup_s']:.3f} s, window {record['window_s']:.3f}"
          f" s, {record['calls']} calls, check "
          f"{time.perf_counter() - record['check_t0']:.3f} s",
          file=sys.stderr, flush=True)
    print("call seconds " + " ".join(f"{t:.4f}" for t in record["call_s"]),
          file=sys.stderr, flush=True)
    print(f"built in set-up: {record['build']['built'] or 'nothing'} in "
          f"{record['build']['seconds']:.3f} s", file=sys.stderr, flush=True)
    metrics = (manifest.per_layer(spec, name) if trace
               else manifest.end_to_end(spec, name))
    dev = torch.device(device)
    result = {
        "correct": (failed == 0 and record["calls"] > 0
                    and all(v <= lim for v, lim in checks.values())),
        "attempted": record["calls"],
        "failed": failed,
        "metrics": manifest.read_metrics(metrics, record, root),
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu"),
            "count": cell["chips"],
            "memory_peak_bytes": record["memory_peak_bytes"],
        },
    }
    if trace:
        result["device"]["busy_s"] = record["busy_s"]
        result["device"]["window_s"] = record["traced_wall_s"]
        result["breakdown"] = record["breakdown"]
    # which native libraries this run built (a checkout's first run
    # does), and the seconds of set-up that took
    result["setup_build"] = record["build"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import manifest

    spec = manifest.load()
    try:
        cell = manifest.cell(spec, args.workload)
    except KeyError as e:
        print(e, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from benchmark.reference import estimators

    try:
        result = run_cell(spec, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", T_START)
    except estimators.Missing as e:
        print(e, file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"loaded in the run's process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
