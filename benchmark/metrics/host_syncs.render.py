"""host_syncs.render: the program's blocking reads of device values a frame,
COUNTS["host_syncs"] (utils.metrics.host_read), reset before each frame of
the span pass."""

from pathlib import Path

from benchmark import spans

ROOT = Path(__file__).resolve().parents[1]


def read(rec):
    if rec["kind"] != "render":
        return None
    return spans.host_syncs(rec, ROOT)
