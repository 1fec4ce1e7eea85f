"""cand_build_ms.render: device milliseconds of the list tracer's candidate
builds a frame, their calls recorded during a frame and replayed back to back
under the profiler (no host path in the time)."""


def read(rec):
    if rec["kind"] != "render" or "build_device_s" not in rec:
        return None
    b = rec["build_device_s"]
    return 1e3 * sum(b) / len(b)
