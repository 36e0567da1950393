"""Scene ingestion of the port against tpurt: glTF loading field by field,
the device scene field by field (exact: both are numpy on the host, fed
through the same native gather), the PNG codec against Pillow, and the
port's procedural writers against tpurt's."""

import base64
import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

from tpurt.scene import procedural as jproc
from tpurt.scene.device import DeviceScene as JDeviceScene
from tpurt.scene.device import build_device_scene as j_build
from tpurt.scene.gltf import load_gltf as j_load
from tpurt_torch.scene import procedural as tproc
from tpurt_torch.scene.device import DeviceScene, Materials, build_device_scene
from tpurt_torch.scene.gltf import camera_for_render, load_gltf
from tpurt_torch.utils import png

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
LIGHTS = []


def _scene_paths(tmp_path, name):
    if name == "box":
        return [jproc.write_box_scene(str(tmp_path / "box.gltf"))]
    if name == "sponza":
        return [jproc.write_sponza_like_scene(str(tmp_path / "s.gltf"), columns=2, foliage=8)]
    if name == "helmet":
        return [jproc.write_helmet_like_scene(str(tmp_path / "h.gltf"))]
    if name == "adv_multi":
        return [os.path.join(FIX, "adv_multi_a.glb"), os.path.join(FIX, "adv_multi_b.gltf")]
    return [os.path.join(FIX, name)]


SCENES = ["adv_multi_a.glb", "adv_multi_b.gltf", "adv_multi", "lamp.gltf", "lamp.glb",
          "box", "sponza", "helmet"]


def _eq(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b, what


@pytest.mark.parametrize("name", SCENES)
def test_load_gltf_matches_tpurt(tmp_path, name):
    paths = _scene_paths(tmp_path, name)
    ref = j_load(paths)
    got = load_gltf(paths)
    for f in ("positions", "normals", "tangents", "uvs", "indices",
              "model_bounds_min", "model_bounds_max"):
        _eq(getattr(got, f), getattr(ref, f), f)
    assert len(got.geometries) == len(ref.geometries)
    for g1, g2 in zip(got.geometries, ref.geometries):
        for k, v in vars(g2).items():
            _eq(getattr(g1, k), v, f"geometry.{k}")
    assert [vars(m) for m in got.materials] == [vars(m) for m in ref.materials]
    assert [vars(t) for t in got.textures] == [vars(t) for t in ref.textures]
    assert len(got.images) == len(ref.images)
    for i1, i2 in zip(got.images, ref.images):
        _eq(i1.data, i2.data, "image")
        assert i1.srgb == i2.srgb
    for k, v in vars(ref.camera).items():
        _eq(getattr(got.camera, k), v, f"camera.{k}")
    cam = camera_for_render(got.camera)
    assert all(x.dtype == torch.float32 for x in cam)


@pytest.mark.parametrize("name", SCENES)
def test_build_device_scene_matches_tpurt(tmp_path, name):
    from tpurt.config import SphereLight as JLight
    from tpurt_torch.config import SphereLight

    paths = _scene_paths(tmp_path, name)
    lights = [((1.0, -2.0, 3.0), 0.25, (0.9, 0.8, 0.7), 50.0)]
    ref = j_build(j_load(paths), lights=[JLight(*x) for x in lights])
    got = build_device_scene(load_gltf(paths), lights=[SphereLight(*x) for x in lights],
                             device="cpu")
    assert DeviceScene._fields == JDeviceScene._fields
    for f in DeviceScene._fields:
        if f == "materials":
            for m in Materials._fields:
                _eq(getattr(got.materials, m).numpy(), np.asarray(getattr(ref.materials, m)),
                    f"materials.{m}")
        else:
            _eq(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)


def _pil_png(arr, mode):
    buf = io.BytesIO()
    Image.fromarray(arr).convert(mode).save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "LA", "P"])
def test_png_decode_matches_pillow(mode):
    r = np.random.RandomState(len(mode))
    # smooth gradients + noise: Pillow's encoder then picks every filter type
    yy, xx = np.mgrid[0:37, 0:29]
    arr = np.stack([xx * 7, yy * 5, (xx + yy) * 3, 255 - xx * 4], -1) + r.randint(0, 9, (37, 29, 4))
    arr = (arr % 256).astype(np.uint8)
    blob = _pil_png(arr, mode)
    with Image.open(io.BytesIO(blob)) as img:
        expect = np.asarray(img.convert("RGBA"))
    np.testing.assert_array_equal(png.decode_png(blob), expect)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_encode_round_trips_through_pillow(channels):
    arr = np.random.RandomState(channels).randint(0, 256, (13, 21, channels)).astype(np.uint8)
    blob = png.encode_png(arr)
    with Image.open(io.BytesIO(blob)) as img:
        np.testing.assert_array_equal(np.asarray(img), arr)
    out = png.decode_png(blob)
    np.testing.assert_array_equal(out[..., :channels], arr)


def test_png_decodes_procedural_textures_as_pillow(tmp_path):
    """Every embedded texture of tpurt's procedural scenes (written by
    Pillow) decodes to Pillow's own RGBA."""
    import json

    paths = [jproc.write_sponza_like_scene(str(tmp_path / "s.gltf"), columns=2, foliage=4),
             jproc.write_helmet_like_scene(str(tmp_path / "h.gltf"))]
    n = 0
    for p in paths:
        with open(p) as f:
            doc = json.load(f)
        for im in doc.get("images", []):
            blob = base64.b64decode(im["uri"].split(",", 1)[1])
            with Image.open(io.BytesIO(blob)) as img:
                expect = np.asarray(img.convert("RGBA"))
            np.testing.assert_array_equal(png.decode_png(blob), expect)
            n += 1
    assert n >= 5


@pytest.mark.parametrize("which", ["box", "sponza"])
def test_port_procedural_writers_match_tpurt(tmp_path, which):
    """The port's writers (no Pillow) give the same loaded scene as tpurt's."""
    if which == "box":
        a = j_load(jproc.write_box_scene(str(tmp_path / "a.gltf")))
        b = load_gltf(tproc.write_box_scene(str(tmp_path / "b.gltf")))
    else:
        kw = dict(columns=3, foliage=5, stacks=2, segments=8, rings=6)
        a = j_load(jproc.write_sponza_like_scene(str(tmp_path / "a.gltf"), **kw))
        b = load_gltf(tproc.write_sponza_like_scene(str(tmp_path / "b.gltf"), **kw))
    for f in ("positions", "normals", "uvs", "indices"):
        _eq(getattr(b, f), getattr(a, f), f)
    assert [vars(m) for m in a.materials] == [vars(m) for m in b.materials]
    for i1, i2 in zip(a.images, b.images):
        _eq(i2.data, i1.data, "image")
    assert len(a.geometries) == len(b.geometries)
