"""host_syncs.train: the program's blocking reads of device values a step,
COUNTS["host_syncs"] (utils.metrics.host_read), reset before each step of
the span pass."""

from pathlib import Path

from benchmark import spans

ROOT = Path(__file__).resolve().parents[1]


def read(rec):
    if rec["kind"] != "train":
        return None
    return spans.host_syncs(rec, ROOT)
