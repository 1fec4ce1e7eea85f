"""idle_ms.query.render: the idle ms of a frame charged to the list tracer's
host side (spans query, query.pass, query.build, query.kernel,
query.escalate), as a share of the span pass's idle time times the idle of
an unprofiled frame."""

from pathlib import Path

from benchmark import spans

ROOT = Path(__file__).resolve().parents[1]


def read(rec):
    if rec["kind"] != "render":
        return None
    return spans.idle_ms(rec, ROOT, ("query",))
