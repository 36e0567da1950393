"""Whole-slice check: the port's Renderer on the CPU (camera, scene,
wide tables, plain K1/K2 traversal, integrator, film) against the
checked-in goldens that tpurt renders, within tests/test_goldens.py's
bound of film.rmse < 1e-5. The scenes come from the port's writers, which
write tpurt's bytes (tests/test_torch_samples.py)."""

import os

import numpy as np
import pytest

from tpurt_torch import film
from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene import procedural as proc

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
CFG = RenderConfig(width=64, height=48, max_samples=8)


def _compare(name, r, spp):
    img = r.render(spp).numpy()
    assert np.isfinite(img).all() and img.shape == (r.config.height, r.config.width, 4)
    golden = np.load(os.path.join(GOLDEN_DIR, name))["accum"]
    err = film.rmse(img, golden)
    assert err < 1e-5, f"golden mismatch for {name}: RMSE={err}"


def test_box_golden(tmp_path):
    from tpurt_torch.scene.procedural import write_box_scene

    path = write_box_scene(str(tmp_path / "box.gltf"))
    cam = Camera.from_angles([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
    r = Renderer.from_gltf(path, config=CFG, camera=cam, device="cpu",
                           lights=[SphereLight((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)])
    _compare("box_64x48_8spp.npz", r, 8)


def test_box_golden_in_row_bands(tmp_path):
    """chunk_rows only changes how the frame is cut into launches."""
    from tpurt_torch.scene.procedural import write_box_scene

    path = write_box_scene(str(tmp_path / "box.gltf"))
    cam = Camera.from_angles([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
    cfg = RenderConfig(width=64, height=48, max_samples=8, chunk_rows=16)
    r = Renderer.from_gltf(path, config=cfg, camera=cam, device="cpu",
                           lights=[SphereLight((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)])
    _compare("box_64x48_8spp.npz", r, 8)


@pytest.mark.slow
def test_helmet_golden(tmp_path):
    path = proc.write_helmet_like_scene(str(tmp_path / "helmet.gltf"))
    _compare("helmet_64x48_8spp.npz", Renderer.from_gltf(path, config=CFG, device="cpu"), 8)


@pytest.mark.slow
def test_lantern_golden(tmp_path):
    cfg = RenderConfig(width=64, height=48, max_samples=4)
    cam = Camera.from_angles([4.0, -2.0, 6.0], float(np.arctan2(-4.0, -6.0)), 0.1)
    r = Renderer.from_gltf(proc.write_lantern_like_scene(str(tmp_path / "l.gltf")),
                           config=cfg, camera=cam, device="cpu")
    _compare("lantern_64x48_4spp.npz", r, 4)


@pytest.mark.slow
def test_sponza_golden(tmp_path):
    from tpurt_torch.scene.procedural import write_sponza_like_scene

    cfg = RenderConfig(width=64, height=48, max_samples=4)
    cam = Camera.from_angles([0.0, -4.0, 0.0], 0.7, -0.1)
    lights = [SphereLight((-8.0, -5.0, -2.0), 0.1, (0.8, 0.6, 0.6), 500.0)]
    r = Renderer.from_gltf(write_sponza_like_scene(str(tmp_path / "s.gltf"), columns=2,
                                                   foliage=6),
                           config=cfg, camera=cam, lights=lights, device="cpu")
    _compare("sponza_64x48_4spp.npz", r, 4)


def test_box_fold_off_matches_tpurt(tmp_path):
    """fold_bsdf_mis=False traces two shadow rays per hit (light sample and
    BSDF sample) instead of folding the second into the bounce ray: the
    port's image against tpurt's on the same scene, camera and seed."""
    from tpurt.camera import Camera as JCamera
    from tpurt.config import RenderConfig as JRenderConfig
    from tpurt.config import SphereLight as JSphereLight
    from tpurt.renderer import Renderer as JRenderer
    from tpurt_torch.scene.procedural import write_box_scene

    path = write_box_scene(str(tmp_path / "box.gltf"))
    pose = ([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
    light = ((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)
    kw = dict(width=32, height=24, max_samples=4, fold_bsdf_mis=False)
    r = Renderer.from_gltf(path, config=RenderConfig(**kw), camera=Camera.from_angles(*pose),
                           lights=[SphereLight(*light)], device="cpu")
    img = r.render(4).numpy()
    jr = JRenderer.from_gltf(path, config=JRenderConfig(**kw),
                             camera=JCamera.from_angles(*pose), lights=[JSphereLight(*light)])
    ref = np.asarray(jr.render(4))
    assert np.isfinite(img).all() and img.shape == ref.shape
    assert r.rays.physical > 0 and float(ref[..., :3].mean()) > 0.0
    err = film.rmse(img, ref)
    assert err < 1e-5, f"fold_bsdf_mis=False: RMSE={err} against tpurt"
