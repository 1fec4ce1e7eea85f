"""device_ms.shading.render: device ms a frame of the CUDA records launched
while the innermost program span was a shading or RNG span (trace.primary,
trace.bounce, bounce.compact, rng.draw), over the span pass's frames."""

from pathlib import Path

from benchmark import spans

ROOT = Path(__file__).resolve().parents[1]


def read(rec):
    if rec["kind"] != "render":
        return None
    return spans.device_ms(rec, ROOT, ("rng", "shading"))
