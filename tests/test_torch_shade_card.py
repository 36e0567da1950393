"""S1 and S2, the shading kernels of csrc/shade_wave.cu, against the plain
PyTorch block they fuse (integrator/wavefront.py::shade_nee_plain and the
functions it calls), run on the same CUDA inputs: whole waves of the
benchmark's two scenes at the CPU tests' tiny sizes (the helmet: every
texture kind; Sponza: three lights, alpha-tested foliage, no emissive
texture) and of the box with no light and no texture, folded and not.
These need an NVIDIA card: they are marked `cuda` and skip without one.

    python -m pytest --noconftest tests/test_torch_shade_card.py -m cuda -q

The kernels are built with --fmad=false and repeat the plain version's
operation order, and call the libdevice functions PyTorch's kernels call,
so every output is held bit for bit: the RNG states, roulette, picks,
sphere hits and miss counts exactly, floats by their bits (NaN equal to
NaN)."""

import dataclasses
import os
import tempfile

import pytest
import torch

from perfbench import harness
from perfbench.tests import tiny
from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.integrator import wavefront as W
from tpurt_torch.kernels import shade
from tpurt_torch.kernels.intersect import intersect_spheres
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.procedural import write_box_scene

pytestmark = pytest.mark.cuda

SCENES = ("helmet", "sponza", "box")


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def cache():
    with tempfile.TemporaryDirectory() as d:
        yield d


def renderer(name, fold, dev, cache):
    """A tiny renderer of a benchmark scene (its cell's camera and lights)
    or of the box without lights."""
    if name == "box":
        path = write_box_scene(os.path.join(cache, "box.gltf"))
        return Renderer.from_gltf(path, config=RenderConfig(width=64, height=48, seed=2 ** 31 + 5,
                                                            fold_bsdf_mis=fold),
                                  device=dev, cache=False)
    cell = {"helmet": "helmet.offline_512", "sponza": "sponza.interactive_640x480"}[name]
    s = tiny.spec(cell, cache)
    config = s["config"]
    gltf, _ = harness.scene_files(config, cache)
    cfg = dataclasses.replace(harness.render_config(s, 2 ** 31 + 5), fold_bsdf_mis=fold)
    lights = [SphereLight(tuple(l["position"]), l["radius"], tuple(l["color"]), l["intensity"])
              for l in config["lights"]]
    cam = config["camera"]
    return Renderer.from_gltf(gltf, config=cfg, lights=lights, device=dev, cache=False,
                              camera=Camera.from_angles(cam["position"], cam["phi"], cam["theta"]))


def captured_waves(r):
    """One step of `r`, keeping each wave's inputs to the shading block
    (the card path runs, so the waves are the card's own)."""
    waves = []
    card = W.shade_nee

    def keep(*args):
        o, d, state, thr, hit, si = args[5:]
        waves.append((o.clone(), d.clone(), state.clone(), thr.clone(),
                      W.Hit(*(x.clone() for x in hit)), si.clone()))
        return card(*args)

    W.shade_nee = keep
    try:
        for k in shade.LAUNCHES:
            shade.LAUNCHES[k] = 0
        r.step()
        torch.cuda.synchronize()
    finally:
        W.shade_nee = card
    return waves


def same(a, b):
    """Per lane: every element equal, floats by their bits (NaN = NaN)."""
    a, b = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
    if a.dtype == torch.float32:
        eq = (a.view(torch.int32) == b.view(torch.int32)) | (torch.isnan(a) & torch.isnan(b))
    else:
        eq = a == b
    return eq.all(dim=1)


@pytest.mark.parametrize("fold", [True, False], ids=["fold", "exact"])
@pytest.mark.parametrize("name", SCENES)
def test_block_matches_plain(dev, cache, name, fold):
    """S1 + shadow trace + S2 against shade_nee_plain on every wave of a
    sample: all nine full-width outputs bit-equal; one S1 and one S2
    launch a wave with shaded lanes."""
    r = renderer(name, fold, dev, cache)
    waves = captured_waves(r)
    shaded = sum(1 for w in waves if w[-1].numel())
    assert shaded >= 2
    assert shade.LAUNCHES == {"shade_sample": shaded, "shade_mis": shaded}
    for o, d, state, thr, hit, si in waves:
        common = (r.device_scene, r.bvh, r.config, r.tex_flags, r.has_alpha, o, d, state, thr, hit, si)
        k = W.shade_nee_card(*common)
        p = W.shade_nee_plain(*common)
        for field in p._fields:
            a, b = getattr(k, field), getattr(p, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            bad = int((~same(a, b)).sum())
            assert bad == 0, f"{name} {field}: {bad} of {si.numel()} lanes differ"


@pytest.mark.parametrize("fold", [True, False], ids=["fold", "exact"])
@pytest.mark.parametrize("name", SCENES)
def test_shadow_rays_match_plain(dev, cache, name, fold):
    """S1's shadow rays, picks and sphere hits against shade_hit,
    nee_directions and intersect_spheres on the first wave's lanes."""
    r = renderer(name, fold, dev, cache)
    o, d, state, thr, hit, si = captured_waves(r)[0]
    scene, cfg = r.device_scene, r.config
    consts = shade.shade_constants(cfg, scene.lights.shape[0])
    s1 = shade.shade_sample(scene, cfg, r.tex_flags, o, d, state, thr, hit, si, consts)
    sp = W.shade_hit(scene, cfg, r.tex_flags, o[si], d[si], W.Hit(*(x[si] for x in hit)))
    _, nee_o, dir1, dir2, pick_env, _, _, _ = W.nee_directions(scene, cfg, state[si], sp, d[si])
    m = si.numel()
    sh = s1.shadow
    dirs = dir1 if fold else torch.cat([dir1, dir2])
    origins = nee_o if fold else torch.cat([nee_o, nee_o])
    cls = pick_env.to(torch.int32) if fold else (torch.arange(2 * m, device=dev) >= m).to(torch.int32)
    assert bool(same(sh.o, origins).all()) and bool(same(sh.d, dirs).all())
    assert torch.equal(sh.ray_class, cls)
    assert torch.equal(s1.light >= scene.lights.shape[0], pick_env)
    t_max = float(cfg.t_max)
    if scene.lights.shape[0]:
        s_hit, s_t, s_id = intersect_spheres(origins, dirs, scene.lights,
                                             torch.zeros_like(sh.t_min), t_max)
        assert torch.equal(sh.s_hit, s_hit) and torch.equal(sh.s_id, s_id)
        assert bool(same(sh.t_limit, torch.where(s_hit, s_t, torch.full_like(s_t, t_max))).all())
    else:
        assert not bool(sh.s_hit.any())
    assert bool(sh.active.all()) and not bool(sh.t_min.any())


def test_no_shaded_lane_launches_nothing(dev, cache):
    """An empty wave: S1 and S2 return the zero outputs and the state
    without launching."""
    r = renderer("box", True, dev, cache)
    o, d, state, thr, hit, si = captured_waves(r)[0]
    for k in shade.LAUNCHES:
        shade.LAUNCHES[k] = 0
    empty = si[:0]
    out = W.shade_nee_card(r.device_scene, r.bvh, r.config, r.tex_flags, r.has_alpha,
                           o, d, state, thr, hit, empty)
    assert shade.LAUNCHES == {"shade_sample": 0, "shade_mis": 0}
    assert torch.equal(out.state, state)
    assert not bool(out.local_l.any()) and not bool(out.killed.any())
