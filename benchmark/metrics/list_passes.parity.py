"""list_passes.parity: the list tracer's passes a frame, main or escalation:
COUNTS["query.passes"] (ops/kernels/listtrace.py ``_run_once``), reset
before each frame of the span pass.  A pass is a root-box cull and a sort;
only one with a live ray builds candidates and launches a list kernel, so
``list_launches.render`` counts no more.  A program without that counter
reads nothing."""

from pathlib import Path

from benchmark import spans

ROOT = Path(__file__).resolve().parents[1]


def read(rec):
    if rec["kind"] != "render":
        return None
    out = spans.reading(rec, ROOT)
    if out is None:
        return None
    return out["counts_a_call"].get("query.passes")
