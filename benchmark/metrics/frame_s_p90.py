"""frame_s_p90: the 90th percentile of every frame's seconds in the
window, each from its call to its image on the host."""

from benchmark import stats


def read(rec):
    if rec["kind"] != "render":
        return None
    return stats.p90(rec["call_s"])
