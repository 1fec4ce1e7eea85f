"""device_ms.backward.train: device ms a step of every CUDA record launched
while the span train.backward is open, on any thread (the checkpointed
bounces' replay and the gradient scatters), over the span pass's steps."""

from pathlib import Path

from benchmark import spans

ROOT = Path(__file__).resolve().parents[1]


def read(rec):
    if rec["kind"] != "train":
        return None
    return spans.backward_ms(rec, ROOT, "device")
