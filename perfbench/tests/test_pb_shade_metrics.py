"""shade_ms.* on hand-made annotation splits: the shading block's host ms
per sample or frame, read through the PyTorch block's ranges (a parent
commit) or the two kernels' ranges; nothing to read without a wave loop
or without samples or frames."""

from __future__ import annotations

import pytest

from perfbench import harness

NAMES = ("shade_ms.rate", "shade_ms.frame")
OLD = {"shade_attrs": 3.0, "textures": 5.0, "nee_sample": 6.0, "bounce": 7.0,
       "mis_weights": 9.0, "shadow_spheres": 1.5, "shadow_payload": 2.5}
NEW = {"shade_sample": 0.75, "shade_mis": 0.25}


def ctx(annotations, samples=0, frames=0):
    return {"annotations": annotations, "samples": samples, "frames": frames,
            "device_events": [], "rays_physical": 0.0, "window_s": 1.0, "busy_s": 0.1,
            "on_card": True, "timings": {}}


def split(ranges):
    """wave0, the shadow trace and a sync range, which are not counted,
    plus one entry a range: name -> host ms."""
    out = {"wave0": {"count": 1, "host_ms": 50.0, "device_ms": 1.0},
           "trace_shadow": {"count": 8, "host_ms": 40.0, "device_ms": 2.0},
           "sync.scalar_h2d": {"count": 600, "host_ms": 20.0, "device_ms": 0.0}}
    for name, ms in ranges.items():
        out[name] = {"count": 8, "host_ms": ms, "device_ms": 0.1}
    return out


@pytest.mark.parametrize("ranges,total", [(OLD, 34.0), (NEW, 1.0)], ids=["plain", "kernels"])
def test_rate_sums_the_block_per_sample(ranges, total):
    read = harness.metric_reader("shade_ms.rate")
    assert read(ctx(split(ranges), samples=2)) == pytest.approx(total / 2)


@pytest.mark.parametrize("ranges,total", [(OLD, 34.0), (NEW, 1.0)], ids=["plain", "kernels"])
def test_frame_divides_by_frames(ranges, total):
    read = harness.metric_reader("shade_ms.frame")
    assert read(ctx(split(ranges), samples=8, frames=4)) == pytest.approx(total / 4)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name):
    read = harness.metric_reader(name)
    # no wave loop in the trace
    assert read(ctx({"shade_sample": {"count": 1, "host_ms": 1.0}}, 1, 1)) is None
    # no sample or frame in the window
    assert read(ctx(split(NEW))) is None


def test_a_wave_loop_without_the_ranges_reads_zero():
    assert harness.metric_reader("shade_ms.rate")(ctx(split({}), samples=1)) == 0.0
