"""render_mrays: every frame completed in the window, W*H*spp*bounces
rays each, over the window's whole length, in millions a second."""

from benchmark import stats


def read(rec):
    if rec["kind"] != "render":
        return None
    return stats.rate(rec["calls"], rec["work_per_call"],
                      rec["window_s"]) / 1e6
