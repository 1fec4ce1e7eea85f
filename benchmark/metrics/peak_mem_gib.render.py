"""peak_mem_gib.render: torch.cuda.max_memory_allocated() over the window,
after reset_peak_memory_stats() at its start, in GiB."""


def read(rec):
    if rec["kind"] != "render" or not rec["peak_bytes"]:
        return None
    return rec["peak_bytes"] / 2 ** 30
