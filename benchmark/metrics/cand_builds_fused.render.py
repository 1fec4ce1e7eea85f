"""cand_builds_fused.render: the fused supercluster build's launches a frame,
COUNTS["cand_build.fused"] (ops/cluster.py), reset before each frame of the
span pass.  A program without that counter reads nothing."""

from pathlib import Path

from benchmark import spans

ROOT = Path(__file__).resolve().parents[1]


def read(rec):
    if rec["kind"] != "render":
        return None
    out = spans.reading(rec, ROOT)
    if out is None:
        return None
    return out["counts_a_call"].get("cand_build.fused")
