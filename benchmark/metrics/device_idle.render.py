"""device_idle.render: one minus the union of CUDA activity over the
profiled frames, over the mean unprofiled wall time of the window's frames
times their count, in percent."""

from benchmark import stats


def read(rec):
    if rec["kind"] != "render" or "busy_s" not in rec:
        return None
    mean = sum(rec["call_s"]) / len(rec["call_s"])
    return stats.idle_share(rec["busy_s"], mean, rec["traced_calls"])
