"""The port's tracing on the CPU: with no profiler running, `annotate` and
`host_sync` open no range; under torch.profiler a sample of the box and
of the alpha-tested mini Sponza opens one `sync.<site>` range at each
point where the host waits for the device, in the counts the wave loop
implies (one `live_lanes` a wave, two `ray_count` a wave that traced,
`alpha_any` once a pass plus the last test, or the cap), every sync of a
`Renderer.step` inside its `launch` range; the radiance is bit-equal
with and without the profiler. The card's cross-check (every sync
PyTorch's sync debug mode reports lies in a `sync.*` range, one a range)
is marked `cuda` and skips without a card:

    python -m pytest --noconftest tests/test_torch_tracing.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from tpurt_torch import film
from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.integrator import wavefront
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.procedural import write_box_scene, write_sponza_like_scene
from tpurt_torch.utils import profiling
from tpurt_torch.utils.profiling import annotate, host_sync

POSE = ([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
BOX_LIGHT = SphereLight((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)
MINI_SPONZA = dict(columns=1, foliage=8, stacks=1, segments=8, rings=6)
SPONZA_POSE = ([0.0, -4.0, 0.0], 0.7, -0.1)
SPONZA_LIGHT = SphereLight((0.0, -7.5, 0.0), 0.5, (0.9, 0.9, 0.7), 1000.0)


def _box(tmp_path, width, height, device="cpu"):
    path = write_box_scene(str(tmp_path / "box.gltf"))
    return Renderer.from_gltf(path, config=RenderConfig(width=width, height=height),
                              camera=Camera.from_angles(*POSE), lights=[BOX_LIGHT],
                              device=device, cache=False)


def _mini_sponza(tmp_path):
    path = write_sponza_like_scene(str(tmp_path / "mini.gltf"), **MINI_SPONZA)
    return Renderer.from_gltf(path, config=RenderConfig(width=16, height=12),
                              camera=Camera.from_angles(*SPONZA_POSE), lights=[SPONZA_LIGHT],
                              device="cpu", cache=False)


def _ranges(prof):
    """(start, end, name) of every annotation range of a finished profile."""
    return sorted((start, start + dur, name)
                  for dev, ann, name, start, dur, _, linked in profiling._raw_events(prof)
                  if not dev and ann and linked == 0)


def _inside(ranges, outer):
    a, b, _ = outer
    return [r for r in ranges if a <= r[0] and r[1] <= b and r != outer]


def _count(ranges, name):
    return sum(1 for r in ranges if r[2] == name)


def _traced(r, monkeypatch):
    """One step of `r` under the profiler, inside a `test.step` range, then
    the 8-bit frame outside it; each alpha re-trace pass marked by a
    `test.pass` range. Returns (ranges, accumulation)."""
    retrace_tmin = wavefront._retrace_tmin

    def marked(t):
        with torch.profiler.record_function("test.pass"):
            return retrace_tmin(t)

    monkeypatch.setattr(wavefront, "_retrace_tmin", marked)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.step"):
            accum = r.step().clone()
        film.to_srgb8(r.tonemapped())
    return _ranges(prof), accum


@pytest.fixture(scope="module")
def box_trace(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("box")
    r = _box(tmp, 16, 12)
    plain = r.step().clone()
    r.reset()
    with pytest.MonkeyPatch.context() as mp:
        ranges, accum = _traced(r, mp)
    return r, ranges, plain, accum


@pytest.fixture(scope="module")
def sponza_trace(tmp_path_factory):
    r = _mini_sponza(tmp_path_factory.mktemp("sponza"))
    assert r.has_alpha
    plain = r.step().clone()
    r.reset()
    with pytest.MonkeyPatch.context() as mp:
        ranges, accum = _traced(r, mp)
    return r, ranges, plain, accum


def test_no_range_opens_without_a_profiler(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)

    @annotate("decorated")
    def f():
        return 3

    with annotate("a"):
        with host_sync("b"):
            assert f() == 3
    r = _box(tmp_path, 8, 6)
    r.step()
    r.drain()
    film.to_srgb8(r.tonemapped())


def test_host_sync_names_its_range():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with host_sync("site"):
            torch.ones(4).sum()
    assert [r[2] for r in _ranges(prof)] == ["sync.site"]


@pytest.mark.parametrize("scene", ["box", "sponza"])
def test_sync_ranges_follow_the_wave_loop(scene, box_trace, sponza_trace):
    _, ranges, _, _ = box_trace if scene == "box" else sponza_trace
    waves = [r for r in ranges if r[2].startswith("wave")]
    traced = _count(ranges, "trace_closest")
    assert len(waves) >= 2 and traced == len(waves) - 1
    assert _count(ranges, "sync.live_lanes") == len(waves)
    assert _count(ranges, "sync.ray_count") == 2 * traced
    assert _count(ranges, "sync.shade_lanes") == traced
    for w in waves:
        assert _count(_inside(ranges, w), "sync.live_lanes") == 1
    # sync ranges are leaves
    for r in ranges:
        if r[2].startswith("sync."):
            assert _inside(ranges, r) == []


def test_alpha_any_once_a_pass_and_once_more(sponza_trace):
    r, ranges, _, _ = sponza_trace
    cap = r.config.max_alpha_skips
    loops = [x for x in ranges if x[2] in ("alpha_retrace", "occl_recheck")]
    assert loops
    passes_seen = 0
    for loop in loops:
        inner = _inside(ranges, loop)
        passes = _count(inner, "test.pass")
        tests = _count(inner, "sync.alpha_any")
        assert tests == (cap if passes == cap else passes + 1), (loop[2], passes, tests)
        passes_seen += passes
    assert passes_seen > 0
    assert _count(ranges, "sync.alpha_any") == sum(
        _count(_inside(ranges, x), "sync.alpha_any") for x in loops)


@pytest.mark.parametrize("scene", ["box", "sponza"])
def test_every_sync_of_a_step_lies_in_its_launch(scene, box_trace, sponza_trace):
    _, ranges, _, _ = box_trace if scene == "box" else sponza_trace
    (step,) = [r for r in ranges if r[2] == "test.step"]
    in_step = _inside(ranges, step)
    (launch,) = [r for r in in_step if r[2] == "launch"]
    syncs = [r for r in in_step if r[2].startswith("sync.")]
    assert syncs and all(r in _inside(ranges, launch) for r in syncs)
    assert {"accumulate", "camera_rays"} <= {r[2] for r in _inside(ranges, launch)}
    # the frame's copy to the host and the tonemap lie outside the step
    outside = [r for r in ranges if not (step[0] <= r[0] and r[1] <= step[1])]
    assert {r[2] for r in outside} == {"tonemap", "sync.frame_to_host"}


@pytest.mark.parametrize("scene", ["box", "sponza"])
def test_radiance_is_bit_equal_under_the_profiler(scene, box_trace, sponza_trace):
    _, _, plain, traced = box_trace if scene == "box" else sponza_trace
    assert torch.equal(plain, traced)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_every_card_sync_lies_in_a_sync_range(tmp_path, card):
    """One frame of the box at 128x96 on the card (the camera set, one
    launch over the wide tables with the ray sort, the tonemap, the 8-bit
    frame, the drain) under sync debug mode: no sync outside a `sync.*`
    range, one in each, none at the pacer's event wait."""
    r = _box(tmp_path, 128, 96, device=card)
    r.step()
    r.drain()
    torch.cuda.synchronize()
    with profiling.audit_syncs() as audit:
        r.set_camera(Camera.from_angles(*POSE))
        r.step()
        film.to_srgb8(r.tonemapped())
        r.drain()
    assert audit["outside"] == []
    assert {"sync.live_lanes", "sync.root_bounds", "sync.frame_to_host",
            "sync.pacer", "sync.error_word"} <= set(audit["ranges"])
    for name, per_range in audit["ranges"].items():
        assert set(per_range) == {0 if name == "sync.pacer" else 1}, name
