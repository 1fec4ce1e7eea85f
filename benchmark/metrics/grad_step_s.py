"""grad_step_s: the window's seconds over its completed trainer steps,
each ending in its loss on the host."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["window_s"] / rec["calls"]
