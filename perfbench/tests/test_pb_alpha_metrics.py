"""alpha_passes.frame and alpha_capped.frame on hand-made annotation
splits: the `alpha_retrace.pass` and `occl_recheck.pass` ranges, and the
`alpha_cap` ranges, over the profiled frames; nothing to read without a
wave loop, from a program that opens no pass range, or without frames;
0 caps where no loop reached its cap."""

from __future__ import annotations

import pytest

from perfbench import harness

NAMES = ("alpha_passes.frame", "alpha_capped.frame")


def ctx(annotations, frames=0):
    return {"annotations": annotations, "samples": frames, "frames": frames,
            "device_events": [], "rays_physical": 0.0, "window_s": 1.0, "busy_s": 0.1,
            "on_card": True, "timings": {}}


def split(**ranges):
    """wave0 and both alpha loops, plus one entry a keyword: name=count
    (`retrace` and `recheck` name the loops' pass ranges)."""
    out = {"wave0": {"count": 7, "host_ms": 50.0, "device_ms": 1.0},
           "alpha_retrace": {"count": 7, "host_ms": 20.0, "device_ms": 0.5},
           "occl_recheck": {"count": 7, "host_ms": 10.0, "device_ms": 0.2}}
    for name, n in ranges.items():
        name = {"retrace": "alpha_retrace.pass", "recheck": "occl_recheck.pass"}.get(name, name)
        out[name] = {"count": n, "host_ms": 0.1 * n, "device_ms": 0.0}
    return out


def test_passes_and_caps_a_frame():
    c = ctx(split(retrace=60, recheck=36, alpha_cap=4, **{"sync.alpha_cap": 6}), frames=8)
    assert harness.metric_reader("alpha_passes.frame")(c) == 12.0
    assert harness.metric_reader("alpha_capped.frame")(c) == 0.5


@pytest.mark.parametrize("loop", ["retrace", "recheck"])
def test_one_loop_s_passes_alone(loop):
    c = ctx(split(**{loop: 40}), frames=8)
    assert harness.metric_reader("alpha_passes.frame")(c) == 5.0
    assert harness.metric_reader("alpha_capped.frame")(c) == 0.0


def test_no_cap_reads_zero():
    c = ctx(split(retrace=24, recheck=16), frames=8)
    assert harness.metric_reader("alpha_passes.frame")(c) == 5.0
    assert harness.metric_reader("alpha_capped.frame")(c) == 0.0


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("case", ["no_wave_loop", "no_pass_range", "no_frames"])
def test_nothing_to_read(name, case):
    ann = split(retrace=8, recheck=4, alpha_cap=1)
    frames = 8
    if case == "no_wave_loop":
        del ann["wave0"]
    elif case == "no_pass_range":  # a program without the spans: the loops alone
        del ann["alpha_retrace.pass"], ann["occl_recheck.pass"], ann["alpha_cap"]
    else:
        frames = 0
    assert harness.metric_reader(name)(ctx(ann, frames)) is None
