"""utils/debug.py and utils/profiling.py of the port against tpurt's, on the
CPU: validate_scene's problem lists and nan_report's strings equal
tpurt's on the same inputs; with_checks stops a render at a non-finite
sample; KernelTimer; render_stats's keys and ray counts equal tpurt's on
the box at 32x24; trace writes a Chrome trace, and the integrator's
annotations (tpurt's scope names and one range per wave) appear in a
profile of one sample."""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from tpurt_torch import utils
from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.device import build_device_scene
from tpurt_torch.scene.gltf import load_gltf
from tpurt_torch.scene.procedural import write_box_scene, write_sponza_like_scene
from tpurt_torch.utils import debug, profiling

POSE = ([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
LIGHT = ((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)
MINI_SPONZA = dict(columns=1, foliage=8, stacks=1, segments=8, rings=6)


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    return write_box_scene(str(tmp_path_factory.mktemp("box") / "box.gltf"))


def _scenes(path, lights):
    """The port's and tpurt's DeviceScene of the same file and lights."""
    from tpurt.config import SphereLight as JSphereLight
    from tpurt.scene import build_device_scene as j_build
    from tpurt.scene.gltf import load_gltf as j_load

    mine = build_device_scene(load_gltf(path), lights=[SphereLight(*x) for x in lights],
                              device="cpu")
    theirs = j_build(j_load(path), lights=[JSphereLight(*x) for x in lights])
    return mine, theirs


def _corrupt(kind, scene, xp):
    """The same fault in either package's scene (`xp` its array module)."""
    if kind == "clean":
        return scene
    if kind == "material_index":
        return scene._replace(tri_mat=scene.tri_mat + 5)
    if kind == "non_finite":
        pos = np.array(scene.tri_pos)
        pos[3, 1, 2] = np.nan
        return scene._replace(tri_pos=xp(pos))
    if kind == "attribute_length":
        return scene._replace(tri_uv=scene.tri_uv[:-1])
    if kind == "texture_region":
        table = np.array(scene.tex_table)
        table[0, 0] = scene.atlas.shape[1] + 1
        return scene._replace(tex_table=xp(table))
    raise ValueError(kind)


@pytest.mark.parametrize("kind,lights,expect", [
    ("clean", [LIGHT], []),
    ("clean", [(LIGHT[0], 0.0, LIGHT[2], LIGHT[3])], ["non-positive light radius"]),
    ("clean", [LIGHT, (LIGHT[0], -1.0, LIGHT[2], LIGHT[3])], ["non-positive light radius"]),
    ("material_index", [LIGHT], ["material index out of range"]),
    ("non_finite", [LIGHT], ["non-finite triangle positions"]),
    ("attribute_length", [LIGHT], ["triangle attribute arrays disagree in length"]),
    ("texture_region", [LIGHT], ["texture 0 region outside atlas"]),
])
def test_validate_scene_matches_tpurt(box, kind, lights, expect):
    import jax.numpy as jnp

    from tpurt.utils.debug import validate_scene as j_validate

    mine, theirs = _scenes(box, lights)
    got = debug.validate_scene(_corrupt(kind, mine, torch.from_numpy))
    assert got == j_validate(_corrupt(kind, theirs, jnp.asarray))
    assert got == expect


def _image(kind):
    img = np.random.RandomState(4).rand(6, 8, 4).astype(np.float32)
    if kind in ("nan", "both"):
        img[2, 5, 1] = np.nan
    if kind in ("inf", "both"):
        img[1, 7, 0] = np.inf
        img[4, 0, 3] = -np.inf
    return img


@pytest.mark.parametrize("kind", ["clean", "nan", "inf", "both"])
def test_nan_report_matches_tpurt(kind):
    from tpurt.utils.debug import nan_report as j_report

    img = _image(kind)
    want = j_report(img)
    assert debug.nan_report(img) == want
    assert debug.nan_report(torch.from_numpy(img)) == want


def test_with_checks_stops_at_a_non_finite_sample(box, monkeypatch):
    import tpurt_torch.renderer as renderer_mod

    cfg = RenderConfig(width=16, height=12, max_samples=4)
    r = Renderer.from_gltf(box, config=cfg, camera=Camera.from_angles(*POSE),
                           lights=[SphereLight(*LIGHT)], device="cpu")
    stats = renderer_mod.render_sample_stats

    def poisoned(*args, **kw):
        img, st = stats(*args, **kw)
        if args[3] == 1:  # the second sample
            img = img.clone()
            img[3, 9, 2] = float("nan")
        return img, st

    monkeypatch.setattr(renderer_mod, "render_sample_stats", poisoned)
    assert not debug.checks_enabled()
    with utils.with_checks():
        assert debug.checks_enabled()
        r.step()
        with pytest.raises(FloatingPointError) as e:
            r.step()
    assert not debug.checks_enabled()
    assert str(e.value).startswith("sample 1: 1 non-finite pixels; first at (y=3, x=9)")
    assert r.sample_count == 1
    # without the scope the film paints the pixel red, as tpurt's does
    r.step()
    assert r.accum[3, 9].tolist() == [1.0, 0.0, 0.0, 1.0]


def test_kernel_timer():
    timer = utils.KernelTimer()
    x = torch.ones(4)
    for _ in range(3):
        with timer.phase("intersect", block_on=(x, {"y": [x]})):
            pass
    with timer.phase("shade"):
        pass
    st = timer.stats["intersect"]
    assert st.calls == 3 and st.seconds >= 0.0
    lines = timer.report().splitlines()
    assert len(lines) == 2 and "over 3 calls" in timer.report()
    assert timer.mrays_per_sec("missing", 1e6) == 0.0
    timer.stats["shade"].seconds = 0.5
    assert timer.mrays_per_sec("shade", 2e6) == pytest.approx(4.0)


def test_render_stats_matches_tpurt(box):
    from tpurt.camera import Camera as JCamera
    from tpurt.config import RenderConfig as JRenderConfig
    from tpurt.config import SphereLight as JSphereLight
    from tpurt.renderer import Renderer as JRenderer
    from tpurt.utils.profiling import render_stats as j_render_stats

    r = Renderer.from_gltf(box, config=RenderConfig(width=32, height=24),
                           camera=Camera.from_angles(*POSE), lights=[SphereLight(*LIGHT)],
                           device="cpu")
    jr = JRenderer.from_gltf(box, config=JRenderConfig(width=32, height=24),
                             camera=JCamera.from_angles(*POSE),
                             lights=[JSphereLight(*LIGHT)], cache=False)
    for s in (0, 3):
        mine, theirs = profiling.render_stats(r, s), j_render_stats(jr, s)
        assert sorted(mine) == sorted(theirs)
        for k in ("rays_logical", "rays_physical", "fold_efficiency"):
            assert mine[k] == theirs[k], k
        assert mine["seconds"] > 0 and mine["mrays_per_sec"] > 0
    # outside the renderer's accumulation
    assert r.sample_count == 0


def test_utils_exports_tpurts_names():
    from tpurt import utils as jutils

    assert sorted(utils.__all__) == sorted(jutils.__all__)
    for name in utils.__all__:
        assert callable(getattr(utils, name))


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    with utils.trace(log_dir):
        with utils.annotate("outer_scope"):
            torch.ones(64).sum()
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "outer_scope" for e in events)


WAVE_SCOPES = {"trace_closest", "shade_attrs", "textures", "nee_sample", "bounce",
               "trace_shadow", "shadow_spheres", "shadow_payload", "mis_weights",
               "bounce_resolve"}


def test_annotations_split_a_sample(tmp_path):
    """One sample of the mini Sponza (alpha-tested foliage) under trace:
    every scope of the wave loop appears, the alpha re-trace and the
    occlusion recheck included, with one range per wave; host time sums
    over the ranges."""
    path = write_sponza_like_scene(str(tmp_path / "mini.gltf"), **MINI_SPONZA)
    r = Renderer.from_gltf(path, config=RenderConfig(width=16, height=12),
                           camera=Camera.from_angles([0.0, -4.0, 0.0], 0.7, -0.1),
                           lights=[SphereLight((0.0, -7.5, 0.0), 0.5, (0.9, 0.9, 0.7), 1000.0)],
                           device="cpu")
    assert r.has_alpha
    with utils.trace(str(tmp_path / "trace")) as prof:
        r.step()
    shutil.rmtree(tmp_path / "trace")  # ~1M host events: a few hundred MB
    split = profiling.annotation_split(prof)
    assert WAVE_SCOPES | {"alpha_retrace", "occl_recheck"} <= set(split)
    waves = sorted(int(k[4:]) for k in split if k.startswith("wave"))
    assert waves == list(range(len(waves))) and len(waves) >= 2
    assert all(split[f"wave{k}"]["count"] == 1 for k in waves)
    assert split["trace_closest"]["count"] == len(waves) - 1 or \
        split["trace_closest"]["count"] == len(waves)
    assert all(v["host_ms"] > 0 and v["device_ms"] == 0 for v in split.values())
    total = sum(split[f"wave{k}"]["host_ms"] for k in waves)
    assert split["shade_attrs"]["host_ms"] < total
