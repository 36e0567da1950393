"""The metric arithmetic on hand-made event lists and records."""

from __future__ import annotations

import numpy as np
import pytest

from perfbench import harness
from perfbench import trace as T

US = 1_000  # ns


def ev(name, start, dur, device=0, dev=True, ann=False, corr=0, linked=0):
    """A raw event as trace.raw_events gives it."""
    return (dev, ann, name, start, dur, corr, linked, device)


def test_percentile_and_window_rates():
    ms = [float(x) for x in range(1, 21)]
    assert harness.percentile(ms, 85) == pytest.approx(np.percentile(ms, 85))
    v = harness.end_to_end_values(ms, 0, 10.0, 3.5)
    assert v == {"frame_ms_p85": pytest.approx(17.15), "frames_per_s": 2.0, "setup_s": 3.5}
    assert harness.end_to_end_values(None, 12, 8.0, 1.0) == {"samples_per_s": 1.5,
                                                            "setup_s": 1.0}


def test_busy_union_per_device():
    evs = T.device_events([ev("a", 0, 10), ev("b", 5, 10), ev("c", 20, 5), ev("d", 0, 7, 1),
                           ev("range", 0, 99, ann=True)])
    assert T.busy_intervals(evs, 0) == [(0, 15), (20, 25)]
    assert T.busy_ns(T.busy_intervals(evs, 0)) == 20
    assert T.busy_intervals(evs, 1) == [(0, 7)]


def test_idle_gaps_charged_to_the_innermost_range():
    ranges = T.host_ranges([ev("wave0", 0, 100 * US, dev=False, ann=True),
                            ev("alpha_retrace", 30 * US, 40 * US, dev=False, ann=True)])
    busy = [(0, 10 * US), (20 * US, 35 * US), (90 * US, 95 * US)]
    gaps = dict(T.idle_gaps_by_range(busy, ranges, (0, 120 * US)))
    # 10-20 in wave0; 35-90 starts inside alpha_retrace; 95-120 in wave0
    assert gaps == {"wave0": pytest.approx(35e-6), "alpha_retrace": pytest.approx(55e-6)}


def test_annotation_split_counts_kernels_under_open_ranges():
    events = [ev("wave0", 0, 100, dev=False, ann=True, corr=1),
              ev("mul", 10, 1, dev=False, corr=2), ev("add", 60, 1, dev=False, corr=3),
              ev("k_mul", 20, 4, linked=2), ev("k_add", 70, 6, linked=3),
              ev("alpha_retrace", 50, 30, dev=False, ann=True, corr=4)]
    out = T.annotation_split(events)
    assert out["wave0"] == {"count": 1, "host_ms": pytest.approx(100 / 1e6),
                            "device_ms": pytest.approx(10 / 1e6)}
    assert out["alpha_retrace"]["device_ms"] == pytest.approx(6 / 1e6)


def test_top_device_ops():
    evs = [("a", 0, 5, 0), ("b", 0, 7, 0), ("a", 9, 5, 1)]
    assert T.top_device_ops(evs) == [["a", 10e-9], ["b", 7e-9]]


def ctx(**kw):
    base = {"annotations": {"wave0": {"host_ms": 1.0}}, "samples": 2, "frames": 0,
            "device_events": [], "rays_physical": 0.0, "window_s": 1.0, "busy_s": 0.25,
            "on_card": True, "timings": {}}
    base.update(kw)
    return base


def test_readers():
    read = harness.metric_reader
    k1 = "void (anonymous namespace)::wide_walk<false, true>(float4 const*)"
    k2 = "_ZN12_GLOBAL__N_19wide_walkILb1ELb1EEEvPK6float4"
    events = [(k1, 0, 600_000, 0), (k2, 0, 400_000, 0), ("at::native::mul", 0, 5_000_000, 0)]
    # 1e6 rays x 48 B at 3.35 TB/s = 14.33 us over 1 ms of K1 + K2
    roof = read("traversal_roofline.rate")(ctx(device_events=events, rays_physical=1e6))
    assert roof == pytest.approx(100 * 48e6 / 3.35e12 / 1e-3)
    assert read("traversal_roofline.rate")(ctx(device_events=events[2:], rays_physical=1e6)) \
        is None
    assert read("device_idle_share.rate")(ctx()) == pytest.approx(75.0)
    assert read("device_idle_share.frame")(ctx(on_card=False)) is None
    assert read("device_ops.rate")(ctx(device_events=events)) == 1.5
    assert read("device_ops.frame")(ctx(device_events=events, frames=3)) == 1.0
    ann = {"wave0": {"host_ms": 9.0}, "alpha_retrace": {"host_ms": 30.0},
           "occl_recheck": {"host_ms": 10.0}}
    assert read("alpha_loop_ms.rate")(ctx(annotations=ann)) == 20.0
    assert read("alpha_loop_ms.rate")(ctx()) == 0.0
    assert read("alpha_loop_ms.frame")(ctx(annotations={}, frames=2)) is None
    assert read("scene_load_s")(ctx(timings={"cache_load_s": 0.5})) == 0.5
    assert read("scene_load_s")(ctx(timings={"gltf_load_s": 1.0, "sah_s": 0.5})) == 1.5
