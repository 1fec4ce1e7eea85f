"""idle_ms.nee.parity: the idle ms of a frame charged to the parity
estimator's NEE: the self time of the spans nee.light and nee.env (outside
their queries, draws and syncs), as a share of the span pass's idle time
times the idle of an unprofiled frame, as spans.idle_ms scales a layer.  A
program without those spans reads nothing."""

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
    part = sum(out["idle_by_span"].get(n, 0.0) for n in NEE)
    return 1e3 * part / out["idle_s"] * spans.unprofiled_idle_s(rec)
