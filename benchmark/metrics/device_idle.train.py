"""device_idle.train: one minus the union of CUDA activity over the
profiled steps, over the mean unprofiled wall time of the window's steps
times their count, in percent."""

from benchmark import stats


def read(rec):
    if rec["kind"] != "train" or "busy_s" not in rec:
        return None
    mean = sum(rec["call_s"]) / len(rec["call_s"])
    return stats.idle_share(rec["busy_s"], mean, rec["traced_calls"])
