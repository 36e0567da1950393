"""The alpha loops' spans on the CPU, on the alpha-tested mini Sponza:
under torch.profiler each re-trace pass of `alpha_retrace` (closest
hits) and `occl_recheck` (shadow rays) opens one `<loop>.pass` range
inside its loop's range, and a loop that ends at `max_alpha_skips`
passes with hits still rejected opens one empty `alpha_cap` range after
its one `sync.alpha_cap` test; with a cap no loop reaches there is
none, and a loop that stops before its cap makes no such test. The
radiance is bit-equal with and without the profiler."""

import pytest
import torch

from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.integrator import wavefront
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.procedural import write_sponza_like_scene
from tpurt_torch.utils import profiling

MINI_SPONZA = dict(columns=1, foliage=40, stacks=1, segments=8, rings=6)
POSE = ([0.0, -4.0, 0.0], 0.7, -0.1)
LIGHT = SphereLight((0.0, -7.5, 0.0), 0.5, (0.9, 0.9, 0.7), 1000.0)
LOOPS = ("alpha_retrace", "occl_recheck")


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    return write_sponza_like_scene(str(tmp_path_factory.mktemp("mini") / "mini.gltf"),
                                   **MINI_SPONZA)


def _ranges(prof):
    return sorted((start, start + dur, name)
                  for dev, ann, name, start, dur, _, linked in profiling._raw_events(prof)
                  if not dev and ann and linked == 0)


def _inside(ranges, outer):
    a, b, _ = outer
    return [r for r in ranges if a <= r[0] and r[1] <= b and r != outer]


def _names(ranges, name):
    return [r for r in ranges if r[2] == name]


def _render(path, skips):
    """One sample at 16x12 with `skips` passes at most, then the same
    sample again under the profiler, each pass marked by a `test.pass`
    range at its re-trace t_min. Returns (plain, traced, ranges)."""
    r = Renderer.from_gltf(path, config=RenderConfig(width=16, height=12,
                                                     max_alpha_skips=skips),
                           camera=Camera.from_angles(*POSE), lights=[LIGHT], device="cpu",
                           cache=False)
    plain = r.step().clone()
    r.reset()
    retrace_tmin = wavefront._retrace_tmin

    def marked(t):
        with torch.profiler.record_function("test.pass"):
            return retrace_tmin(t)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wavefront, "_retrace_tmin", marked)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            traced = r.step().clone()
    return plain, traced, _ranges(prof)


@pytest.fixture(scope="module", params=[1, 64], ids=lambda k: f"skips{k}")
def run(request, scene_path):
    return (request.param,) + _render(scene_path, request.param)


def test_one_pass_range_a_retrace_pass_in_both_loops(run):
    skips, _, _, ranges = run
    for name in LOOPS:
        loops = _names(ranges, name)
        passes = [_names(_inside(ranges, x), name + ".pass") for x in loops]
        assert sum(map(len, passes)) > 0, name
        for loop, ps in zip(loops, passes):
            assert len(ps) <= skips
            assert len(ps) == len(_names(_inside(ranges, loop), "test.pass"))
            for p in ps:
                assert len(_names(_inside(ranges, p), "test.pass")) == 1
    assert sum(len(_names(ranges, x + ".pass")) for x in LOOPS) == len(
        _names(ranges, "test.pass"))


def test_alpha_cap_where_a_loop_ends_at_its_cap(run):
    skips, _, _, ranges = run
    caps = _names(ranges, "alpha_cap")
    if skips == 1:
        assert caps
    if skips == 64:
        assert not caps
    for cap in caps:
        assert _inside(ranges, cap) == []
        (loop,) = [x for x in ranges if x[2] in LOOPS and cap in _inside(ranges, x)]
        assert len(_names(_inside(ranges, loop), loop[2] + ".pass")) == skips
    for loop in [x for x in ranges if x[2] in LOOPS]:
        inner = _inside(ranges, loop)
        full = len(_names(inner, loop[2] + ".pass")) == skips
        assert len(_names(inner, "sync.alpha_cap")) == full
        assert len(_names(inner, "alpha_cap")) <= full


def test_radiance_is_bit_equal_under_the_profiler(run):
    _, plain, traced, _ = run
    assert torch.equal(plain, traced)
