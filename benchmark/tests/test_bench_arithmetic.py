"""The rate, tail and idle arithmetic on synthetic timelines, and
the frozen work counts against the program's probes/bounds.py."""

from __future__ import annotations

import statistics

import pytest
import torch

from benchmark import bounds, manifest, stats


def _record(call_s, rays=2_097_152, **kw):
    rec = {"kind": "render", "call_s": call_s, "calls": len(call_s),
           "window_s": sum(call_s), "work_per_call": rays, "setup_s": 9.0,
           "launches": [121] * len(call_s), "peak_bytes": 3 * 2 ** 30}
    rec.update(kw)
    return rec


def _read(name, rec):
    return manifest.reader(name)(rec)


def test_rate_and_tail_of_a_steady_window():
    rec = _record([1.25] * 40)
    assert _read("render_mrays", rec) == pytest.approx(2_097_152 / 1.25 / 1e6)
    assert _read("frame_s_p90", rec) == pytest.approx(1.25)
    assert _read("grad_step_s", rec) is None


def test_a_stall_moves_the_rate_and_the_tail():
    steady = _record([1.25] * 40)
    stalled = _record([1.25] * 35 + [2.5] * 5)
    assert _read("render_mrays", stalled) < 0.9 * _read("render_mrays",
                                                        steady)
    assert _read("frame_s_p90", stalled) > 1.1 * _read("frame_s_p90", steady)
    # a single stall is above the 90th percentile of 40 frames: the rate
    # shows it, the tail does not
    one = _record([1.25] * 39 + [6.0])
    assert _read("frame_s_p90", one) == pytest.approx(1.25)
    assert _read("render_mrays", one) < _read("render_mrays", steady)


def test_p90_interpolates_between_order_statistics():
    vals = [float(i) for i in range(1, 11)]
    assert stats.p90(vals) == pytest.approx(
        statistics.quantiles(vals, n=10, method="inclusive")[8])
    assert stats.p90([3.0]) == 3.0


def test_step_time_is_window_over_steps():
    rec = {"kind": "train", "window_s": 30.5, "calls": 14}
    assert _read("grad_step_s", rec) == pytest.approx(30.5 / 14)
    assert _read("render_mrays", dict(rec, call_s=[1.0])) is None


def test_union_and_idle_share():
    # two frames' activity: overlapping intervals count once; the gaps
    # are labelled by the interval that ended before them
    ev = [(0.0, 0.1, "a"), (0.05, 0.2, "b"), (0.5, 0.6, "c"),
          (1.0, 1.1, "d"), (1.05, 1.08, "e")]
    busy, gaps = stats.union(ev)
    assert busy == pytest.approx(0.2 + 0.1 + 0.1)
    assert gaps == [(pytest.approx(0.3), "b"), (pytest.approx(0.4), "c")]
    rec = _record([0.8, 0.8, 0.8], busy_s=busy, traced_calls=2)
    assert _read("device_idle.render", rec) == pytest.approx(
        100 * (1 - 0.4 / 1.6))
    assert _read("device_idle.train", rec) is None


def test_roofline_reader_refuses_missing_launches():
    rec = _record([1.0], kernel_device={"block_tiles": (3, 0.01),
                                        "list_tiles": (0, 0.0)},
                  kernel_captured={"block_tiles": 0, "list_tiles": 0},
                  kernel_bound_s={"block_tiles": 0.0, "list_tiles": 0.0})
    with pytest.raises(RuntimeError):
        _read("roofline.block_tiles.render", rec)
    assert _read("roofline.list_tiles.render", rec) is None
    rec["kernel_captured"]["block_tiles"] = 3
    rec["kernel_bound_s"]["block_tiles"] = 0.002
    assert _read("roofline.block_tiles.render", rec) == pytest.approx(20.0)


@pytest.mark.parametrize("rays_per_list", [32, 1])
def test_frozen_bounds_equal_the_probes(rays_per_list):
    from sycl_ray_tracing_tpu_torch.probes import bounds as probe

    g = torch.Generator().manual_seed(rays_per_list)
    k2, lists, maxc = 40, 6, 16
    cand = torch.randint(0, k2 + 1, (lists, maxc), generator=g,
                         dtype=torch.int32)
    cand[0] = k2                                      # one empty list
    rays = torch.rand((lists * rays_per_list, 8), generator=g)
    tris = torch.rand((k2 + 1, 9, 128), generator=g)
    ops, nbytes = bounds.tiles_work(cand, rays, tris)
    work = (probe.block_tiles_work if rays_per_list > 1
            else probe.list_tiles_work)(cand, rays, tris, stop=None)
    assert (ops, nbytes) == work
    assert bounds.bound_s(ops, nbytes) * 1e3 == pytest.approx(
        probe.bound(ops, nbytes)[0])


def test_build_time_refuses_a_call_with_no_build():
    """A call whose candidate builds run under names the recorder does not
    wrap raises rather than reading 0 ms."""
    from types import SimpleNamespace

    from benchmark import trace

    lt = SimpleNamespace(**{name: (lambda *a: None) for name in trace.BUILDS})
    with pytest.raises(RuntimeError):
        trace.build_device_s(lambda: None, lt)
