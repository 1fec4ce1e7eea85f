"""Run the list tracer's cost-law probes on the card:

    python -m sycl_ray_tracing_tpu_torch.probes [probe ...]

with probes from kernel_shape, phase, chunk, micro_round, feature_smoke,
hier_build, row_scatter (all when none is named).  Each prints one line per
measurement; the card's name and power limit come first.  Without a CUDA
device it raises.
"""

from __future__ import annotations

import sys

import torch

PROBES = ("kernel_shape", "phase", "chunk", "micro_round", "feature_smoke",
          "hier_build", "row_scatter")
N_TRIS = 200_000


def run_probes(names, scene, device, reps: int = 5):
    """Run the named probes; ``scene`` is the 200k dragon stand-in with
    sky (the kernel_shape and phase workload)."""
    from sycl_ray_tracing_tpu_torch.probes import (
        chunk,
        feature_smoke,
        hier_build,
        kernel_shape,
        micro_round,
        phase,
        row_scatter,
    )

    for name in names:
        print(f"== probe {name}", flush=True)
        if name == "kernel_shape":
            kernel_shape.run(scene, reps)
        elif name == "phase":
            phase.run(scene, reps)
        elif name == "chunk":
            chunk.run(device, reps)
        elif name == "micro_round":
            micro_round.run(device, reps)
        elif name == "feature_smoke":
            feature_smoke.run(device, 4 * reps)
        elif name == "hier_build":
            hier_build.run(device, 4 * reps)
        elif name == "row_scatter":
            row_scatter.run(device, 4 * reps)


def main(argv=None) -> int:
    from sycl_ray_tracing_tpu_torch.probes.common import (
        card_line,
        require_cuda,
    )
    from sycl_ray_tracing_tpu_torch.utils.procedural import dragon_scene

    names = list(argv if argv is not None else sys.argv[1:]) or list(PROBES)
    bad = [n for n in names if n not in PROBES]
    if bad:
        raise SystemExit(f"unknown probes {bad}; choose from {PROBES}")
    dev = require_cuda()
    print(f"card: {card_line()}", flush=True)
    with torch.no_grad():
        scene = None
        if {"kernel_shape", "phase"} & set(names):
            scene = dragon_scene(N_TRIS, with_sky=True, device=dev)
        run_probes(names, scene, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
