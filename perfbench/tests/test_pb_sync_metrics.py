"""host_syncs.* and sync_wait_ms.* on hand-made annotation splits: the
`sync.*` ranges summed over sites, per sample or frame; nothing to read
without a wave loop, without sync ranges (a program that opens none) or
without samples or frames."""

from __future__ import annotations

import pytest

from perfbench import harness

NAMES = ("host_syncs.rate", "host_syncs.frame", "sync_wait_ms.rate", "sync_wait_ms.frame")


def ctx(annotations, samples=0, frames=0):
    return {"annotations": annotations, "samples": samples, "frames": frames,
            "device_events": [], "rays_physical": 0.0, "window_s": 1.0, "busy_s": 0.1,
            "on_card": True, "timings": {}}


def split(**sites):
    """wave0 and an alpha loop, plus one `sync.<site>` entry a keyword:
    site=(count, host ms)."""
    out = {"wave0": {"count": 1, "host_ms": 50.0, "device_ms": 1.0},
           "alpha_retrace": {"count": 3, "host_ms": 20.0, "device_ms": 0.5}}
    for site, (n, ms) in sites.items():
        out["sync." + site] = {"count": n, "host_ms": ms, "device_ms": 0.0}
    return out


def test_rates_sum_every_site_per_sample():
    ann = split(live_lanes=(8, 2.0), alpha_any=(30, 6.5), pacer=(2, 1.5))
    c = ctx(ann, samples=2)
    assert harness.metric_reader("host_syncs.rate")(c) == 20.0
    assert harness.metric_reader("sync_wait_ms.rate")(c) == pytest.approx(5.0)


def test_frames_divide_by_frames():
    ann = split(frame_to_host=(8, 40.0), scalar_h2d=(800, 8.0))
    c = ctx(ann, samples=8, frames=8)
    assert harness.metric_reader("host_syncs.frame")(c) == 101.0
    assert harness.metric_reader("sync_wait_ms.frame")(c) == pytest.approx(6.0)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name):
    read = harness.metric_reader(name)
    # no wave loop in the trace
    assert read(ctx({"sync.live_lanes": {"count": 1, "host_ms": 1.0}}, 1, 1)) is None
    # a program without sync ranges (the benchmark's parent commits)
    assert read(ctx(split(), 1, 1)) is None
    # no sample or frame in the window
    assert read(ctx(split(live_lanes=(1, 1.0)))) is None


def test_names_like_sync_but_not_sync_ranges_are_not_counted():
    ann = split(live_lanes=(4, 1.0))
    ann["syncing"] = {"count": 100, "host_ms": 100.0, "device_ms": 0.0}
    assert harness.metric_reader("host_syncs.rate")(ctx(ann, samples=1)) == 4.0
