"""row_scatters_fused.train: the row-sum kernel's launches a step,
COUNTS["row_scatter.fused"] (ops/kernels/rows.py: one a backward of a
small-table row gather), reset before each step of the span pass.  A
program without that counter reads nothing."""

from pathlib import Path

from benchmark import spans

ROOT = Path(__file__).resolve().parents[1]


def read(rec):
    if rec["kind"] != "train":
        return None
    out = spans.reading(rec, ROOT)
    if out is None:
        return None
    return out["counts_a_call"].get("row_scatter.fused")
