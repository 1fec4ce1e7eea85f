"""peak_mem_gib.train: torch.cuda.max_memory_allocated() over the window,
after reset_peak_memory_stats() at its start, in GiB."""


def read(rec):
    if rec["kind"] != "train" or not rec["peak_bytes"]:
        return None
    return rec["peak_bytes"] / 2 ** 30
