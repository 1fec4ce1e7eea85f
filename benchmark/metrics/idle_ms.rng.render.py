"""idle_ms.rng.render: the idle ms of a frame charged to the RNG's draws (span
rng.draw): the layer's share of the span pass's idle time times the idle of
an unprofiled frame (the window's mean frame less the profiled frames' busy
union a frame)."""

from pathlib import Path

from benchmark import spans

ROOT = Path(__file__).resolve().parents[1]


def read(rec):
    if rec["kind"] != "render":
        return None
    return spans.idle_ms(rec, ROOT, ("rng",))
