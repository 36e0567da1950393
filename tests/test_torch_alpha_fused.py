"""K1/K2's alpha re-trace in plain PyTorch (`wide.alpha_walk_plain`, the
full-width masked walk the Alpha kernels are held to on the card)
against the integrator's host loops on the CPU, on the alpha-tested mini
Sponza: every closest-hit trace (`_trace`'s `alpha_retrace`) and shadow
trace (`_shadow_blocked`'s `occl_recheck`) of a sample, ray by ray and bit
for bit, with and without the tables' mask columns, with a cap the loops
reach and one they do not; its counters are the loop's passes and cap.
Then the ranges the wave loop opens from a fused launch's counters: the
same `<loop>.pass` and `alpha_cap` ranges the host loop opens."""

import dataclasses

import pytest
import torch

from tpurt_torch.bvh.traverse import closest_hit, occlusion_hit
from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.integrator import wavefront as W
from tpurt_torch.kernels import wide
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.procedural import write_sponza_like_scene
from tpurt_torch.utils import profiling

MINI_SPONZA = dict(columns=1, foliage=40, stacks=1, segments=8, rings=6)
POSE = ([0.0, -4.0, 0.0], 0.7, -0.1)
LIGHT = SphereLight((0.0, -7.5, 0.0), 0.5, (0.9, 0.9, 0.7), 1000.0)
RANGES = ("alpha_retrace", "occl_recheck", "alpha_retrace.pass", "occl_recheck.pass",
          "alpha_cap")


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    return write_sponza_like_scene(str(tmp_path_factory.mktemp("mini") / "mini.gltf"),
                                   **MINI_SPONZA)


def _renderer(path, skips, mask_columns=True):
    r = Renderer.from_gltf(path, config=RenderConfig(width=12, height=9, max_alpha_skips=skips),
                           camera=Camera.from_angles(*POSE), lights=[LIGHT], device="cpu",
                           cache=False)
    assert r.has_alpha and r.bvh.use_masks
    if not mask_columns:  # the same tree, tables without mask columns
        kb = r.bvh
        r.bvh = wide.make_wide_kernel_bvh(kb.tribvh, kb.tri_pos, device="cpu")
        assert not r.bvh.use_masks
    return r


def _loop_calls(r):
    """One sample with the host loops, keeping each trace's inputs, its
    result, the passes its loop ran and whether it ended at the cap with
    hits rejected."""
    calls = []
    seen = {}
    trace, shadow = W._trace, W._shadow_blocked
    retrace_tmin = W._retrace_tmin

    def count(t):
        seen["passes"] += 1
        return retrace_tmin(t)

    def cap(rej):
        seen["cap"] = bool(rej.any())

    def keep(kind, fn):
        def run(*args, **kw):
            seen.update(passes=0, cap=False)
            out = fn(*args, **kw)
            calls.append((kind, args, kw, out, seen["passes"], seen["cap"]))
            return out
        return run

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(W, "_trace", keep("closest", trace))
        mp.setattr(W, "_shadow_blocked", keep("shadow", shadow))
        mp.setattr(W, "_retrace_tmin", count)
        mp.setattr(W, "_mark_cap", cap)
        r.step()
    return calls


def _alpha(r):
    at = W._alpha_test(r.device_scene, r.config)
    return dataclasses.replace(at, counters=torch.zeros(2, dtype=torch.int32))


def _same(a, b, what):
    bits = (lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x)
    bad = int((bits(a) != bits(b)).sum())
    assert bad == 0, f"{what}: {bad} of {a.numel()} rays differ"


@pytest.fixture(scope="module", params=[(1, True), (4, True), (1, False)],
                ids=["cap1", "cap4", "cap1_no_mask_columns"])
def loop_run(request, scene_path):
    skips, mask_columns = request.param
    r = _renderer(scene_path, skips, mask_columns)
    return skips, r, _loop_calls(r)


def test_plain_walk_equals_the_host_loop_on_every_trace(loop_run):
    skips, r, calls = loop_run
    cfg = r.config
    passes, caps = {"closest": 0, "shadow": 0}, 0
    for kind, args, kw, out, n_pass, capped in calls:
        at = _alpha(r)
        if kind == "closest":
            scene, bvh, o, d, t_min0, active, spheres = args[:7]
            hit, counters = closest_hit(bvh, scene.lights, o, d, t_min0, cfg.t_max,
                                        include_spheres=spheres, active=active,
                                        sort_rays=kw.get("sort_rays", True),
                                        policy=cfg.kernel, alpha=at)
            for field in hit._fields:
                _same(getattr(hit, field), getattr(out, field), f"closest {field}")
        else:
            scene, bvh, o, d, t_min0, t_limit, active = args[:7]
            blocked, _, counters = occlusion_hit(bvh, o, d, t_min0, t_limit, active, True,
                                                 ray_class=kw.get("ray_class"),
                                                 policy=cfg.kernel, alpha=at)
            _same(blocked, out, "shadow blocked")
        assert counters is at.counters
        assert counters.tolist() == [n_pass, int(capped)], kind
        passes[kind] += n_pass
        caps += capped
    assert passes["closest"] > 0 and passes["shadow"] > 0
    assert (caps > 0) == (skips == 1)


def test_plain_walk_without_counters_returns_none(loop_run):
    _, r, calls = loop_run
    kind, args, kw, out, _, _ = next(c for c in calls if c[0] == "closest")
    scene, bvh, o, d, t_min0, active, spheres = args[:7]
    at = W._alpha_test(scene, r.config)  # no profiler: no counters
    assert at.counters is None
    hit, counters = closest_hit(bvh, scene.lights, o, d, t_min0, r.config.t_max,
                                include_spheres=spheres, active=active, policy=r.config.kernel,
                                alpha=at)
    assert counters is None
    _same(hit.t, out.t, "closest t")


def _ranges(prof):
    return sorted((start, start + dur, name)
                  for dev, ann, name, start, dur, _, linked in profiling._raw_events(prof)
                  if not dev and ann and linked == 0)


def _inside(ranges, outer):
    a, b, _ = outer
    return [x for x in ranges if a <= x[0] and x[1] <= b and x != outer]


@pytest.mark.parametrize("passes,capped", [(0, 0), (1, 0), (3, 1), (2, 1)])
@pytest.mark.parametrize("loop", ["alpha_retrace", "occl_recheck"])
def test_ranges_from_given_counters(loop, passes, capped):
    """One `sync.alpha_passes`, then the loop's range holding one
    `<loop>.pass` a pass and an `alpha_cap` where a ray was capped."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        W._mark_passes(loop, torch.tensor([passes, capped], dtype=torch.int32))
    ranges = _ranges(prof)
    names = [x[2] for x in ranges]
    assert names.count("sync.alpha_passes") == 1 and names.count(loop) == 1
    (outer,) = [x for x in ranges if x[2] == loop]
    inner = [x[2] for x in _inside(ranges, outer)]
    assert inner.count(loop + ".pass") == passes == names.count(loop + ".pass")
    assert inner.count("alpha_cap") == capped == names.count("alpha_cap")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        W._mark_passes(loop, None)
    assert not {x[2] for x in _ranges(prof)} & {"sync.alpha_passes", loop}


class _Recorder:
    """Stands in for torch.profiler.record_function while the ranges of a
    sample are recorded: each range's name and the names of the ranges
    open around it."""

    def __init__(self):
        self.stack, self.ranges = [], []

    def __call__(self, name):
        rec = self

        class Range:
            def __enter__(self):
                rec.ranges.append((name, tuple(rec.stack)))
                rec.stack.append(name)

            def __exit__(self, *exc):
                rec.stack.pop()
                return False

        return Range()


def test_a_fused_sample_opens_the_host_loops_ranges(loop_run):
    """A sample through the fused route (alpha_packets, here its plain
    walk) and through the host loop, both as while a profiler runs: the
    same image bit for bit, the same loop, pass and cap ranges, each pass
    and cap inside its loop, one `sync.alpha_passes` a loop and no sync of
    the host loop's."""
    skips, r, _ = loop_run

    def sample(fused):
        r.reset()
        rec = _Recorder()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.autograd, "_profiler_enabled", lambda: True)
            mp.setattr(profiling, "_profiler_enabled", lambda: True)
            mp.setattr(torch.profiler, "record_function", rec)
            if fused:
                mp.setattr(W, "_alpha_in_kernel", lambda bvh, o, octet: not octet)
            accum = r.step().clone()
        counts = {}
        for name, around in rec.ranges:
            counts[name] = counts.get(name, 0) + 1
            if name.endswith(".pass"):
                assert around[-1] == name[:-len(".pass")]
            if name == "alpha_cap":
                assert around[-1] in ("alpha_retrace", "occl_recheck")
        return accum, counts

    fused, f = sample(True)
    loop, h = sample(False)
    assert torch.equal(fused.view(torch.int32), loop.view(torch.int32))
    for k in RANGES:
        assert f.get(k, 0) == h.get(k, 0), k
    assert f.get("alpha_retrace.pass", 0) > 0 and f.get("occl_recheck.pass", 0) > 0
    assert (f.get("alpha_cap", 0) > 0) == (skips == 1)
    assert f["sync.alpha_passes"] == f["alpha_retrace"] + f["occl_recheck"]
    assert not {"sync.alpha_any", "sync.alpha_lanes", "sync.alpha_cap"} & set(f)
    assert h.get("sync.alpha_any", 0) > 0 and "sync.alpha_passes" not in h
