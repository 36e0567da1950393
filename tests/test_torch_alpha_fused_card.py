"""K1/K2 with the alpha re-trace inside the walk (the Alpha instantiations
of csrc/wide_traverse.cu) against the host loops they replace on the card
(integrator/wavefront.py: `_trace`'s `alpha_retrace`, `_shadow_blocked`'s
`occl_recheck`, which still run on CPU tensors) and against
`wide.alpha_walk_plain`. These need an NVIDIA card: they are marked
`cuda` and skip without one.

    python -m pytest --noconftest tests/test_torch_alpha_fused_card.py -m cuda -q

Every closest-hit and shadow trace of a sample of the alpha-tested mini
Sponza (with its mask columns, and over tables without them), and of a
stack of crossed alpha cards deeper than the cap, is run three ways on
the same inputs: the fused launch, the host loop and the plain walk. t,
prim, u, v and kind (closest hits) and blocked (shadow rays) are held bit
for bit, and the fused launch's counters to the loop's passes and its
cap. A sphere light is in view of the bounce waves and of rays aimed
through the cards at it; `max_alpha_skips` 2 makes rays reach the cap.
The sample's image, its pass and cap ranges under the profiler, and the
sync audit of a traced frame follow."""

import dataclasses

import numpy as np
import pytest
import torch

from tpurt_torch import film
from tpurt_torch.bvh.traverse import closest_hit, occlusion_hit
from tpurt_torch.camera import Camera
from tpurt_torch.config import KernelPolicy, RenderConfig, SphereLight
from tpurt_torch.integrator import wavefront as W
from tpurt_torch.kernels import wide
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.procedural import GLTFBuilder, _quad_mesh, quirk_rotation
from tpurt_torch.scene.procedural import write_sponza_like_scene
from tpurt_torch.utils import profiling

pytestmark = pytest.mark.cuda

MINI_SPONZA = dict(columns=2, foliage=40, stacks=1, segments=8, rings=6)
POSE = ([0.0, -4.0, 0.0], 0.7, -0.1)
LIGHT = SphereLight((0.0, -7.5, 0.0), 0.5, (0.9, 0.9, 0.7), 1000.0)
STACK_CARDS = 12
STACK_LIGHT = SphereLight((0.0, -1.5, 6.0), 0.4, (1.0, 0.9, 0.8), 200.0)
SCENES = ("sponza", "sponza_no_masks", "stack")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def write_card_stack(path, cards=STACK_CARDS):
    """`cards` alpha-MASK quads crossed through the y axis at the origin
    (rotations k pi / cards), their texture opaque only on a two-texel
    rim, over an opaque floor: a ray through the axis crosses every card
    in holes."""
    b = GLTFBuilder()
    qp, qn, quv, qidx = _quad_mesh()
    rim = np.zeros((16, 16, 4), np.uint8)
    rim[[0, 1, 14, 15], :] = [60, 150, 60, 255]
    rim[:, [0, 1, 14, 15]] = [60, 150, 60, 255]
    leaf = b.add_material(base_color_texture=b.add_texture(rim), alpha_mode="MASK",
                          alpha_cutoff=0.5)
    floor = b.add_material(base_color=(0.6, 0.6, 0.6, 1.0))
    mesh_leaf = b.add_mesh(qp, qn, quv, qidx.astype(np.uint32), material=leaf)
    mesh_floor = b.add_mesh(qp, qn, quv, qidx, material=floor)
    for k in range(cards):
        ang = np.pi * k / cards
        b.add_node(mesh=mesh_leaf, translation=[0.0, 1.5, 0.0], scale=[3.0, 3.0, 3.0],
                   rotation=quirk_rotation(0.0, float(np.sin(ang / 2)), 0.0,
                                           float(np.cos(ang / 2))))
    b.add_node(mesh=mesh_floor, rotation=quirk_rotation(-0.7071068, 0, 0, 0.7071068),
               scale=[20, 20, 1])
    return b.write(path)


def renderer(name, skips, dev, tmp, cell_masks=True):
    cfg = RenderConfig(width=64, height=48, max_alpha_skips=skips, seed=2 ** 31 + 7,
                       kernel=KernelPolicy(cell_masks_closest=cell_masks))
    if name == "stack":
        path = write_card_stack(str(tmp / "stack.gltf"))
        cam = Camera.from_angles([0.0, -1.5, -6.0], 0.0, 0.0)
        return Renderer.from_gltf(path, config=cfg, camera=cam, lights=[STACK_LIGHT],
                                  device=dev, cache=False)
    path = write_sponza_like_scene(str(tmp / "mini.gltf"), **MINI_SPONZA)
    r = Renderer.from_gltf(path, config=cfg, camera=Camera.from_angles(*POSE), lights=[LIGHT],
                           device=dev, cache=False)
    assert r.has_alpha and r.bvh.use_masks
    if name == "sponza_no_masks":  # the same tree, tables without mask columns
        kb = r.bvh
        r.bvh = wide.make_wide_kernel_bvh(kb.tribvh, kb.tri_pos, device=dev)
        assert not r.bvh.use_masks
    return r


def captured(r):
    """One step of `r` with the fused path, keeping the inputs of every
    closest-hit (`_trace`) and shadow (`_shadow_blocked`) trace."""
    calls = []
    trace, shadow = W._trace, W._shadow_blocked

    def keep_trace(scene, bvh, o, d, t_min0, active, spheres, cfg, has_alpha, sort_rays=True):
        calls.append(("closest", (o.clone(), d.clone(), t_min0.clone(), active.clone(), spheres,
                                  sort_rays)))
        return trace(scene, bvh, o, d, t_min0, active, spheres, cfg, has_alpha, sort_rays)

    def keep_shadow(scene, bvh, o, d, t_min0, t_limit, active, cfg, has_alpha, ray_class=None):
        calls.append(("shadow", (o.clone(), d.clone(), t_min0.clone(), t_limit.clone(),
                                 active.clone(), None if ray_class is None else ray_class.clone())))
        return shadow(scene, bvh, o, d, t_min0, t_limit, active, cfg, has_alpha, ray_class)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(W, "_trace", keep_trace)
        mp.setattr(W, "_shadow_blocked", keep_shadow)
        r.step()
    torch.cuda.synchronize()
    return calls


def host_loop(fn, *args):
    """`fn` (_trace or _shadow_blocked) with the host loop on the card:
    (result, passes, whether it ended at the cap with hits rejected)."""
    seen = {"passes": 0, "cap": False}
    retrace_tmin, mark_cap = W._retrace_tmin, W._mark_cap

    def count(t):
        seen["passes"] += 1
        return retrace_tmin(t)

    def cap(rej):
        seen["cap"] = bool(rej.any())

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(W, "_alpha_in_kernel", lambda bvh, o, octet: False)
        mp.setattr(W, "_retrace_tmin", count)
        mp.setattr(W, "_mark_cap", cap)
        out = fn(*args)
    return out, seen["passes"], seen["cap"]


def bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_same(a, b, what):
    bad = int((bits(a) != bits(b)).sum())
    assert bad == 0, f"{what}: {bad} of {a.numel()} rays differ"


def alpha_test(r, counters=True):
    at = W._alpha_test(r.device_scene, r.config)
    return dataclasses.replace(at, counters=torch.zeros(2, dtype=torch.int32, device=r.device)
                               if counters else None)


def check_closest(r, o, d, t_min0, active, spheres, sort_rays):
    """Fused, host loop and plain walk on one closest-hit trace. Returns
    the loop's (passes, capped)."""
    scene, cfg = r.device_scene, r.config
    at = alpha_test(r)
    fused, counters = closest_hit(r.bvh, scene.lights, o, d, t_min0, cfg.t_max,
                                  include_spheres=spheres, active=active, sort_rays=sort_rays,
                                  policy=cfg.kernel, alpha=at)
    loop, passes, capped = host_loop(W._trace, scene, r.bvh, o, d, t_min0, active, spheres, cfg,
                                     True, sort_rays)
    limit = torch.full_like(t_min0, float(np.float32(cfg.t_max)))
    plain = wide.alpha_walk_plain(r.bvh, o, d, t_min0, wide._t_limit(limit, active), active,
                                  alpha_test(r), occlusion=False,
                                  cell_masks=cfg.kernel.cell_masks_closest, spheres=spheres,
                                  t_max=cfg.t_max)
    for field in ("t", "prim", "u", "v", "kind"):
        assert_same(getattr(fused, field), getattr(loop, field), f"fused/loop {field}")
        assert_same(getattr(fused, field), getattr(plain, field), f"fused/plain {field}")
    assert counters.tolist() == [passes, int(capped)] == plain.counters.tolist()
    return passes, capped


def check_shadow(r, o, d, t_min0, t_limit, active, ray_class):
    scene, cfg = r.device_scene, r.config
    at = alpha_test(r)
    blocked, hit, counters = occlusion_hit(r.bvh, o, d, t_min0, t_limit, active, True,
                                           ray_class=ray_class, policy=cfg.kernel, alpha=at)
    loop, passes, capped = host_loop(W._shadow_blocked, scene, r.bvh, o, d, t_min0, t_limit,
                                     active, cfg, True, ray_class)
    plain = wide.alpha_walk_plain(r.bvh, o, d, t_min0, wide._t_limit(t_limit, active), active,
                                  alpha_test(r), occlusion=True)
    assert_same(blocked, loop, "fused/loop blocked")
    assert_same(blocked, plain.flag > 0.0, "fused/plain blocked")
    for field in ("t", "prim", "u", "v", "kind"):
        assert_same(getattr(hit, field), getattr(plain, field), f"fused/plain {field}")
    assert counters.tolist() == [passes, int(capped)] == plain.counters.tolist()
    return passes, capped


@pytest.mark.parametrize("skips", [2, 8])
@pytest.mark.parametrize("name", SCENES)
def test_every_trace_of_a_sample_matches_the_host_loop(dev, tmp_path, name, skips):
    r = renderer(name, skips, dev, tmp_path)
    calls = captured(r)
    kinds = [c[0] for c in calls]
    assert "closest" in kinds and "shadow" in kinds
    total, caps = 0, 0
    for kind, args in calls:
        check = check_closest if kind == "closest" else check_shadow
        passes, capped = check(r, *args)
        total += passes
        caps += capped
    assert total > 0
    if skips == 2:
        assert caps > 0  # rays reach the cap


@pytest.mark.parametrize("cell_masks", [True, False], ids=["cell_masks", "no_cell_masks"])
def test_mini_sponza_closest_hits_without_cell_tests(dev, tmp_path, cell_masks):
    """Closest hits with K1's cell tests off (pending from DeviceScene.tri_alpha)."""
    r = renderer("sponza", 8, dev, tmp_path, cell_masks=cell_masks)
    for kind, args in captured(r):
        if kind == "closest":
            check_closest(r, *args)


def stack_rays(n, dev):
    """Rays across the stack at its height: the first half from a circle of
    radius 4 around the axis to the opposite side, passing within 0.2 of
    the axis (each card crossed once, in a hole, away from the axis: more
    crossings than the cap); the rest from beside the stack at the light,
    which they reach without crossing a card. t_limit: the far point."""
    g = torch.Generator().manual_seed(5)
    h = n // 2
    ang = torch.rand(h, generator=g) * 2 * np.pi
    ring = torch.stack([torch.sin(ang), torch.zeros(h), torch.cos(ang)], dim=1)
    side = torch.stack([torch.cos(ang), torch.zeros(h), -torch.sin(ang)], dim=1)
    y = torch.tensor([0.0, -1.5, 0.0]) + 0.6 * (torch.rand(h, 1, generator=g) - 0.5) * \
        torch.tensor([0.0, 1.0, 0.0])
    jitter = 0.4 * (torch.rand(h, 1, generator=g) - 0.5)
    o1 = 4.0 * ring + y
    far1 = -4.0 * ring + y + jitter * side
    light = torch.tensor(STACK_LIGHT.position)
    o2 = torch.stack([4.0 * (torch.rand(n - h, generator=g) - 0.5),
                      -1.5 + torch.rand(n - h, generator=g) - 0.5,
                      2.0 + torch.rand(n - h, generator=g)], dim=1)
    far2 = light + 0.2 * (torch.rand(n - h, 3, generator=g) - 0.5)
    o, far = torch.cat([o1, o2]), torch.cat([far1, far2])
    d = far - o
    t_limit = d.norm(dim=1)
    d = d / t_limit[:, None]
    return (o.to(dev).contiguous(), d.to(dev).contiguous(),
            t_limit.to(torch.float32).to(dev).contiguous())


@pytest.mark.parametrize("skips", [2, 8])
def test_rays_across_the_card_stack_and_at_its_light(dev, tmp_path, skips):
    """Closest hits and shadow rays of stack_rays, every 13th inactive:
    rays reach the cap of 2 and of 8 (the loop runs all its passes and
    ends with hits rejected), and the sphere light ends the rays aimed at
    it."""
    r = renderer("stack", skips, dev, tmp_path)
    o, d, t_limit = stack_rays(4096, dev)
    n = o.shape[0]
    zeros = torch.zeros(n, dtype=torch.float32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    active[::13] = False
    assert check_closest(r, o, d, zeros, active, True, True) == (skips, True)
    assert check_shadow(r, o, d, zeros, t_limit, active, None) == (skips, True)
    fused, _ = closest_hit(r.bvh, r.device_scene.lights, o, d, zeros, r.config.t_max,
                           include_spheres=True, active=active, policy=r.config.kernel,
                           alpha=alpha_test(r, counters=False))
    assert int((fused.kind[n // 2:] == 2).sum()) > n // 4  # the light wins


@pytest.mark.parametrize("name", SCENES)
def test_sample_and_its_ranges_equal_the_host_loop(dev, tmp_path, name):
    """A sample with the fused path and with the host loop: the same image
    bit for bit; under the profiler the same `alpha_retrace.pass`,
    `occl_recheck.pass` and `alpha_cap` ranges, one `sync.alpha_passes` a
    loop and no other alpha sync."""
    r = renderer(name, 2, dev, tmp_path)

    def traced(loop):
        r.reset()
        with pytest.MonkeyPatch.context() as mp:
            if loop:
                mp.setattr(W, "_alpha_in_kernel", lambda bvh, o, octet: False)
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                accum = r.step().clone()
            torch.cuda.synchronize()
        names = [name for dev_, ann, name, _, _, _, linked in profiling._raw_events(prof)
                 if not dev_ and ann and linked == 0]
        return accum, {k: names.count(k) for k in set(names)}

    fused, f = traced(False)
    loop, h = traced(True)
    assert torch.equal(fused.view(torch.int32), loop.view(torch.int32))
    for k in ("alpha_retrace.pass", "occl_recheck.pass", "alpha_cap", "alpha_retrace",
              "occl_recheck"):
        assert f.get(k, 0) == h.get(k, 0), k
    assert f.get("alpha_retrace.pass", 0) + f.get("occl_recheck.pass", 0) > 0
    assert f["sync.alpha_passes"] == f["alpha_retrace"] + f["occl_recheck"]
    assert not {"sync.alpha_any", "sync.alpha_lanes", "sync.alpha_cap"} & set(f)


def test_alpha_syncs_of_a_traced_frame_lie_in_their_ranges(dev, tmp_path):
    """A frame of the mini Sponza under sync debug mode: every sync in a
    `sync.*` range, one in each, `sync.alpha_passes` among them."""
    r = renderer("sponza", 8, dev, tmp_path)
    r.step()
    r.drain()
    torch.cuda.synchronize()
    with profiling.audit_syncs() as audit:
        r.step()
        film.to_srgb8(r.tonemapped())
        r.drain()
    assert audit["outside"] == []
    assert "sync.alpha_passes" in audit["ranges"]
    for name, per_range in audit["ranges"].items():
        assert set(per_range) == {0 if name == "sync.pacer" else 1}, name
