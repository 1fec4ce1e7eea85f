"""idle_ms.backward.train: the idle ms of a step inside the span
train.backward: its share of the span pass's idle time times the idle of an
unprofiled step (the window's mean step less the profiled steps' busy union
a step)."""

from pathlib import Path

from benchmark import spans

ROOT = Path(__file__).resolve().parents[1]


def read(rec):
    if rec["kind"] != "train":
        return None
    return spans.backward_ms(rec, ROOT, "idle")
