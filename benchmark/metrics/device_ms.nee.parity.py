"""device_ms.nee.parity: device ms a frame of the CUDA records launched while
the innermost program span was nee.light or nee.env (the parity
estimator's NEE shading, outside its queries and draws), over the span
pass's frames.  A program without those spans reads nothing."""

from pathlib import Path

from benchmark import spans

ROOT = Path(__file__).resolve().parents[1]
NEE = ("nee.light", "nee.env")


def read(rec):
    if rec["kind"] != "render":
        return None
    out = spans.reading(rec, ROOT)
    if out is None or not out["device_records"]:
        return None
    if not any(n in out["idle_by_span"] or n in out["device_by_span"]
               for n in NEE):
        return None
    part = sum(out["device_by_span"].get(n, 0.0) for n in NEE)
    return 1e3 * part / out["calls"]
