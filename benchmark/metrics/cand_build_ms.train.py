"""cand_build_ms.train: device milliseconds of the list tracer's candidate
builds a step, their calls recorded during a step and replayed back to back
under the profiler (no host path in the time)."""


def read(rec):
    if rec["kind"] != "train" or "build_device_s" not in rec:
        return None
    b = rec["build_device_s"]
    return 1e3 * sum(b) / len(b)
