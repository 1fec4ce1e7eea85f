"""The readings the limits of ``correct`` are set from, for one cell on
the card it is started on, every seed in one process:

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--calls N]

For each seed it prints one JSON line with the program's numbers (what
a run's check reads: the cell's own path at the cell's own size, frames
0..N-1, or the trainer's first steps and one of the N steps after them,
drawn from the seed) and the control's: the reference
computed in bfloat16, the nearest precision below the configuration's
float32, put in the program's place.  A limit lies above every program
reading and below every control reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import check
from benchmark import inputs as bench_inputs
from benchmark import loops, manifest
from benchmark.reference import rng


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--calls", type=int, default=4,
                    help="progressive frames, or trainer steps after the "
                    "first ones, a seed (default 4)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    spec = manifest.load()
    cell = manifest.cell(spec, args.workload)
    cfg = bench_inputs.load_config(cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    inputs = bench_inputs.scene_arrays(cfg)
    seeds = [int(s) for s in args.seeds.split(",")]
    if traffic["kind"] == "progressive":
        frames = loops.Frames(inputs, cfg, dev)
    else:
        scene = loops.program_scene(inputs, dev)
    for seed in seeds:
        t0 = time.perf_counter()
        line = {"workload": args.workload, "seed": seed}
        if traffic["kind"] == "progressive":
            base = rng.key_of_seed(seed)
            shots = [frames.frame(base, i) for i in range(args.calls)]
            line["overflow_frames"] = sum(of for _, of in shots)
            images = [img for img, _ in shots]
            line["program"] = {"pixels_off": loops.frame_checks(
                inputs, cfg, traffic, seed, images, dev)}
            line["control_bf16"] = {"pixels_off": loops.frame_checks(
                inputs, cfg, traffic, seed, images, dev, torch.bfloat16)}
        else:
            n = traffic["reference_steps"]
            run = loops.Trainer(inputs, scene, cfg, traffic, seed, dev)
            program = run.first_steps(n)
            for i in range(n, n + args.calls):
                run.step(i)
            window = run.followed(check.window_pick(seed, n, args.calls))
            start = run.start_params()
            del run
            loops.free(dev)
            line["program"] = loops.step_checks(inputs, cfg, traffic, seed,
                                                program, start, window, dev)
            line["control_bf16"] = loops.step_checks(
                inputs, cfg, traffic, seed, program, start, window, dev,
                torch.bfloat16)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
