"""Checkpoints and camera paths of the port against tpurt's, on the CPU:
film.Checkpoint / save_checkpoint / load_checkpoint (tpurt's `.npz` keys
and dtypes, so either package resumes the other's files),
Renderer.save_checkpoint / load_checkpoint (exact resume, the seed and
spp_per_launch refusals), and orbit_path / fly_path."""

import numpy as np
import pytest
import torch

from tpurt_torch import film
from tpurt_torch.camera import Camera, fly_path, orbit_path
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.procedural import write_box_scene

POSE = ([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
LIGHT = ((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)
CFG = RenderConfig(width=32, height=24, max_samples=4)
KEYS = {"accum": np.float32, "sample_count": np.int64, "seed": np.int64,
        "spp_per_launch": np.int64, "camera_position": np.float32,
        "camera_direction": np.float32, "camera_right": np.float32}


@pytest.fixture(scope="module")
def box(tmp_path_factory):
    return write_box_scene(str(tmp_path_factory.mktemp("box") / "box.gltf"))


def _renderer(box, cfg=CFG):
    return Renderer.from_gltf(box, config=cfg, camera=Camera.from_angles(*POSE),
                              lights=[SphereLight(*LIGHT)], device="cpu")


def _accum(seed=0):
    return np.random.RandomState(seed).rand(24, 32, 4).astype(np.float32)


def test_resume_is_bit_equal_to_an_uninterrupted_render(box, tmp_path):
    whole = _renderer(box).render(4).numpy()
    r = _renderer(box)
    r.render(2)
    path = str(tmp_path / "ck.npz")
    r.save_checkpoint(path)
    fresh = _renderer(box)
    fresh.load_checkpoint(path)
    assert fresh.sample_count == 2 and fresh.accum.device == torch.device("cpu")
    assert np.array_equal(fresh.camera.position.numpy(), r.camera.position.numpy())
    resumed = fresh.render(4).numpy()
    assert resumed.tobytes() == whole.tobytes()


def test_checkpoint_file_has_tpurt_keys_and_dtypes(box, tmp_path):
    r = _renderer(box)
    r.render(1)
    path = str(tmp_path / "ck.npz")
    r.save_checkpoint(path)
    data = np.load(path)
    assert set(data.files) == set(KEYS)
    for k, dt in KEYS.items():
        assert data[k].dtype == dt, k
    assert data["accum"].shape == (24, 32, 4) and data["camera_right"].shape == (3,)
    assert int(data["sample_count"]) == 1 and int(data["spp_per_launch"]) == 1


def test_tpurt_checkpoint_loads_in_the_port(tmp_path):
    from tpurt import film as jfilm
    from tpurt.camera import Camera as JCamera

    path = str(tmp_path / "j.npz")
    jcam = JCamera.from_angles(*POSE)
    acc = _accum(1)
    jfilm.save_checkpoint(path, acc, 6, 3, jcam, spp_per_launch=2)
    ck = film.load_checkpoint(path)
    assert (ck.sample_count, ck.seed, ck.spp_per_launch) == (6, 3, 2)
    assert ck.accum.dtype == np.float32 and ck.accum.tobytes() == acc.tobytes()
    cam = ck.camera("cpu")
    assert isinstance(cam, Camera)
    for mine, theirs in zip(cam, jcam):
        assert mine.dtype == torch.float32
        assert mine.numpy().tobytes() == np.asarray(theirs).tobytes()


def test_port_checkpoint_loads_in_tpurt(tmp_path):
    from tpurt import film as jfilm

    path = str(tmp_path / "p.npz")
    cam = Camera.from_angles(*POSE)
    acc = _accum(2)
    film.save_checkpoint(path, torch.from_numpy(acc), 5, 7, cam, spp_per_launch=1)
    ck = jfilm.load_checkpoint(path)
    assert (ck.sample_count, ck.seed, ck.spp_per_launch) == (5, 7, 1)
    assert ck.accum.tobytes() == acc.tobytes()
    for name, mine in zip(("position", "direction", "right"), cam):
        theirs = getattr(ck, f"camera_{name}")
        assert theirs.dtype == np.float32 and theirs.tobytes() == mine.numpy().tobytes()
    jcam = ck.camera()
    assert np.asarray(jcam.direction).tobytes() == cam.direction.numpy().tobytes()


def test_renderer_checkpoints_cross_packages(box, tmp_path):
    """A port renderer's checkpoint resumes in tpurt's Renderer, and
    tpurt's in the port's, with the same accumulation and count."""
    from tpurt.camera import Camera as JCamera
    from tpurt.config import RenderConfig as JRenderConfig
    from tpurt.config import SphereLight as JSphereLight
    from tpurt.renderer import Renderer as JRenderer

    r = _renderer(box)
    r.render(1)
    path = str(tmp_path / "p.npz")
    r.save_checkpoint(path)
    jr = JRenderer.from_gltf(box, config=JRenderConfig(width=32, height=24, max_samples=4),
                             camera=JCamera.from_angles(*POSE),
                             lights=[JSphereLight(*LIGHT)], cache=False)
    jr.load_checkpoint(path)
    assert jr.sample_count == 1
    assert np.asarray(jr.accum).tobytes() == r.image().tobytes()
    jpath = str(tmp_path / "j.npz")
    jr.save_checkpoint(jpath)
    fresh = _renderer(box)
    fresh.load_checkpoint(jpath)
    assert fresh.sample_count == 1 and fresh.image().tobytes() == r.image().tobytes()


def _refusal(renderer, path):
    with pytest.raises(ValueError) as e:
        renderer.load_checkpoint(path)
    return str(e.value)


@pytest.mark.parametrize("field,value", [("seed", 9), ("spp_per_launch", 2)])
def test_mismatch_refusals_match_tpurt(box, tmp_path, field, value):
    """A checkpoint of another seed or spp_per_launch is refused with
    tpurt's ValueError, word for word."""
    from tpurt import film as jfilm
    from tpurt.camera import Camera as JCamera
    from tpurt.config import RenderConfig as JRenderConfig
    from tpurt.config import SphereLight as JSphereLight
    from tpurt.renderer import Renderer as JRenderer

    path = str(tmp_path / "ck.npz")
    kw = dict(seed=0, spp_per_launch=1)
    kw[field] = value
    jfilm.save_checkpoint(path, _accum(), 2, kw["seed"], JCamera.from_angles(*POSE),
                          spp_per_launch=kw["spp_per_launch"])
    jr = JRenderer.from_gltf(box, config=JRenderConfig(width=32, height=24),
                             camera=JCamera.from_angles(*POSE),
                             lights=[JSphereLight(*LIGHT)], cache=False)
    mine = _refusal(_renderer(box), path)
    assert mine == _refusal(jr, path)
    assert field in mine


def test_checkpoint_of_another_size_is_refused(box, tmp_path):
    path = str(tmp_path / "ck.npz")
    film.save_checkpoint(path, np.zeros((8, 8, 4), np.float32), 1, 0,
                         Camera.from_angles(*POSE), spp_per_launch=1)
    with pytest.raises(AssertionError):
        _renderer(box).load_checkpoint(path)


def _same_cameras(mine, theirs):
    assert len(mine) == len(theirs) and mine
    for cam, jcam in zip(mine, theirs):
        assert isinstance(cam, Camera) and cam.position.device == torch.device("cpu")
        for a, b in zip(cam, jcam):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)


@pytest.mark.parametrize("args", [([0.0, 0.0, 0.0], 5.0, 2.0, 8),
                                  ([0.0, -4.0, 0.0], 3.0, 0.5, 2),
                                  ([1.0, 2.0, -3.0], 0.5, -1.0, 5)])
def test_orbit_path_matches_tpurt(args):
    from tpurt.camera import orbit_path as j_orbit

    _same_cameras(orbit_path(*args), j_orbit(*args))


@pytest.mark.parametrize("args", [([[4, 0, 0], [0, 0, 4]], [0, 0, 0], 2),
                                  ([[-3, -4, 1], [0, -4, 2], [3, -5, 1]], [0, -4, 0], 4)])
def test_fly_path_matches_tpurt(args):
    from tpurt.camera import fly_path as j_fly

    _same_cameras(fly_path(*args), j_fly(*args))


def test_set_camera_moves_a_path_camera_to_the_device(box):
    r = _renderer(box)
    r.render(1)
    r.set_camera(orbit_path([0.0, 0.0, 0.0], 4.0, 1.0, 3)[1])
    assert r.sample_count == 0 and r.camera.position.device == r.device
