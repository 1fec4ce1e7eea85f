"""idle_ms.shading.render: the idle ms of a frame charged to shading: the self
time of the spans trace.primary, trace.bounce and bounce.compact (outside
their queries, draws and syncs), as a share of the span pass's idle time
times the idle of an unprofiled frame."""

from pathlib import Path

from benchmark import spans

ROOT = Path(__file__).resolve().parents[1]


def read(rec):
    if rec["kind"] != "render":
        return None
    return spans.idle_ms(rec, ROOT, ("shading",))
