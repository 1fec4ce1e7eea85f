"""roofline.block_tiles.render: the sum over the profiled frames' block_tiles
launches of the bound of each launch's work on its own inputs
(benchmark/bounds.py), over the sum of their device time by the profiler,
in percent."""


def read(rec):
    if rec["kind"] != "render" or "kernel_device" not in rec:
        return None
    launches, device_s = rec["kernel_device"]["block_tiles"]
    captured = rec["kernel_captured"]["block_tiles"]
    if not device_s and not captured:
        return None
    if launches != captured or not device_s:
        raise RuntimeError(
            "block_tiles: the profiler saw %d launches with %r s of device time, "
            "the wrapper %d launches" % (launches, device_s, captured))
    return 100.0 * rec["kernel_bound_s"]["block_tiles"] / device_s
