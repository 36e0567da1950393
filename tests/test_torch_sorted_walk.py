"""The ray sort around a wide traversal (`bvh/traverse.py::_sorted_walk`)
on the CPU, with and without the alpha re-trace: on the alpha-tested mini
Sponza, at SORT_MIN_RAYS rays (never sorted) and one ray more (sorted
once), each of the four trace kinds -- closest hit, closest hit with
`alpha=`, occlusion, occlusion with `alpha=` -- gives with `sort_rays`
the result it gives without, bit for bit, the alpha counters included."""

import dataclasses

import numpy as np
import pytest
import torch

from tpurt_torch.bvh import traverse as traverse_mod
from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.integrator import wavefront as W
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.procedural import write_sponza_like_scene

MINI_SPONZA = dict(columns=1, foliage=40, stacks=1, segments=8, rings=6)
POSE = ([0.0, -4.0, 0.0], 0.7, -0.1)
LIGHT = SphereLight((0.0, -7.5, 0.0), 0.5, (0.9, 0.9, 0.7), 1000.0)
KINDS = ("closest", "closest_alpha", "occlusion", "occlusion_alpha")


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """The renderer over the mini Sponza (max_alpha_skips 2) and rays from
    the camera aimed at random triangles, a tenth of them inactive, each
    with a shadow distance short of its target."""
    path = write_sponza_like_scene(str(tmp_path_factory.mktemp("mini") / "mini.gltf"),
                                   **MINI_SPONZA)
    r = Renderer.from_gltf(path, config=RenderConfig(width=12, height=9, max_alpha_skips=2),
                           camera=Camera.from_angles(*POSE), lights=[LIGHT], device="cpu",
                           cache=False)
    assert r.has_alpha and r.bvh.use_masks
    n = traverse_mod.SORT_MIN_RAYS + 1
    gen = np.random.default_rng(23)
    tri = r.device_scene.tri_pos.numpy()
    target = tri[gen.integers(0, tri.shape[0], n)].mean(axis=1)
    o = np.asarray(POSE[0], np.float32) + gen.normal(0.0, 0.3, (n, 3)).astype(np.float32)
    d = target - o
    dist = np.linalg.norm(d, axis=1)
    rays = dict(o=torch.from_numpy(o), d=torch.from_numpy(d / dist[:, None]),
                dist=torch.from_numpy(dist * gen.uniform(0.5, 1.1, n)).float(),
                active=torch.from_numpy(gen.uniform(size=n) > 0.1))
    return r, rays


def _trace(r, rays, n, kind, sort_rays):
    """One trace of `kind` over the first `n` rays: its outputs by name."""
    o, d, active = rays["o"][:n], rays["d"][:n], rays["active"][:n]
    t_min = torch.zeros(n, dtype=torch.float32)
    cfg, scene = r.config, r.device_scene
    alpha = None
    if kind.endswith("_alpha"):
        alpha = dataclasses.replace(W._alpha_test(scene, cfg),
                                    counters=torch.zeros(2, dtype=torch.int32))
    if kind.startswith("closest"):
        out = traverse_mod.closest_hit(r.bvh, scene.lights, o, d, t_min, cfg.t_max,
                                       active=active, sort_rays=sort_rays,
                                       return_pending=alpha is None, policy=cfg.kernel,
                                       alpha=alpha)
        hit, extra = out
        got = hit._asdict()
        got["pending" if alpha is None else "counters"] = extra
        return got
    ray_class = (torch.arange(n) >= n // 2).to(torch.int32)
    out = traverse_mod.occlusion_hit(r.bvh, o, d, t_min, rays["dist"][:n], active, True,
                                     sort_rays=sort_rays, ray_class=ray_class,
                                     policy=cfg.kernel, alpha=alpha)
    got = dict(blocked=out[0], **out[1]._asdict())
    if alpha is not None:
        got["counters"] = out[2]
    return got


@pytest.mark.parametrize("above", [False, True], ids=["at_threshold", "above_threshold"])
@pytest.mark.parametrize("kind", KINDS)
def test_sorted_trace_equals_the_unsorted_one(mini, monkeypatch, kind, above):
    r, rays = mini
    n = traverse_mod.SORT_MIN_RAYS + int(above)
    plain = _trace(r, rays, n, kind, sort_rays=False)
    sorts = []
    sort = traverse_mod._sort_rays

    def counted(key, cols):
        sorts.append(int(key.shape[0]))
        return sort(key, cols)

    monkeypatch.setattr(traverse_mod, "_sort_rays", counted)
    got = _trace(r, rays, n, kind, sort_rays=True)
    assert sorts == ([n] if above else [])
    assert got.keys() == plain.keys()
    for name, x in plain.items():
        y = got[name]
        if x is None:
            assert y is None, name
            continue
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        bad = int((x != y).sum())
        assert bad == 0, f"{kind} {name}: {bad} of {x.numel()} rays differ"
    if "counters" in plain:  # the scene takes the alpha re-trace
        assert plain["counters"][0] > 0
    if kind.startswith("occlusion"):
        assert 0 < int(plain["blocked"].sum()) < int(rays["active"][:n].sum())
    else:
        assert bool((plain["prim"] >= 0).any())
