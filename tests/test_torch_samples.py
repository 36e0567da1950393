"""The port's scene writers (tpurt_torch/scene/procedural.py and
scene/samples.py) against tpurt's: the same arguments give the same
bytes (.gltf, .bin and .glb, textures included, since utils/png.py
writes Pillow's PNG bytes), and load_gltf of each file gives equal
SceneData arrays in both packages."""

import os

import numpy as np
import pytest

from tpurt.scene import procedural as jproc
from tpurt.scene import samples as jsamples
from tpurt.scene.gltf import load_gltf as j_load
from tpurt_torch.scene import procedural as tproc
from tpurt_torch.scene import samples as tsamples
from tpurt_torch.scene.gltf import load_gltf

REPEAT = {"wrapS": 10497, "wrapT": 33648, "magFilter": 9728}


def _glb(mod, path):
    """One builder of each kind of content: a textured, tangent-carrying
    sphere and a u8-indexed box, written as GLB."""
    b = mod.GLTFBuilder()
    p, n, uv, idx = mod._uv_sphere(8, 6, 0.5)
    tangents = np.tile(np.array([[1.0, 0.0, 0.0, 1.0]], np.float32), (p.shape[0], 1))
    tex = b.add_texture((np.arange(8 * 8 * 4) % 251).astype(np.uint8).reshape(8, 8, 4),
                        sampler=REPEAT)
    mat = b.add_material(base_color_texture=tex, metallic=0.3, roughness=0.6)
    b.add_node(mesh=b.add_mesh(p, n, uv, idx, tangents=tangents, material=mat),
               translation=[0.0, 1.0, 0.0])
    bp, bn, buv, bidx = mod._box_mesh()
    b.add_node(mesh=b.add_mesh(bp, bn, buv, bidx.astype(np.uint8),
                               material=b.add_material(emissive=(1.0, 0.5, 0.25))))
    b.add_node(camera=b.add_camera(), translation=[0.0, 0.0, -3.0])
    return b.write_glb(path)


WRITERS = {
    "box": lambda m, p: m.write_box_scene(p + ".gltf"),
    "textured_quad": lambda m, p: m.write_textured_quad_scene(p + ".gltf"),
    "textured_quad_sampler": lambda m, p: m.write_textured_quad_scene(
        p + ".gltf", tex_size=8, checker=2, sampler=REPEAT),
    "helmet": lambda m, p: m.write_helmet_like_scene(p + ".gltf"),
    "lantern": lambda m, p: m.write_lantern_like_scene(p + ".gltf"),
    "sponza": lambda m, p: m.write_sponza_like_scene(p + ".gltf", columns=2, foliage=4,
                                                     stacks=2, segments=8, rings=6),
    "glb": lambda m, p: _glb(m, p + ".glb"),
}


def _write(name, tmp_path):
    os.makedirs(tmp_path / "j", exist_ok=True)
    os.makedirs(tmp_path / "t", exist_ok=True)
    if name == "khronos_box":
        return (jsamples.write_khronos_box(str(tmp_path / "j" / "Box.gltf")),
                tsamples.write_khronos_box(str(tmp_path / "t" / "Box.gltf")))
    return (WRITERS[name](jproc, str(tmp_path / "j" / name)),
            WRITERS[name](tproc, str(tmp_path / "t" / name)))


def _eq(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("name", [*WRITERS, "khronos_box"])
def test_writers_write_tpurts_bytes_and_load_equal(tmp_path, name):
    jpath, tpath = _write(name, tmp_path)
    assert os.path.basename(jpath) == os.path.basename(tpath)
    # every file the writer wrote: the document and any sidecar (.bin)
    jfiles, tfiles = sorted(os.listdir(tmp_path / "j")), sorted(os.listdir(tmp_path / "t"))
    assert jfiles == tfiles and len(jfiles) == (2 if name == "khronos_box" else 1)
    for f in jfiles:
        with open(tmp_path / "j" / f, "rb") as a, open(tmp_path / "t" / f, "rb") as b:
            assert a.read() == b.read(), f

    ref, got = j_load(jpath), load_gltf(tpath)
    for f in ("positions", "normals", "tangents", "uvs", "indices",
              "model_bounds_min", "model_bounds_max"):
        _eq(getattr(got, f), getattr(ref, f), f)
    assert len(got.geometries) == len(ref.geometries) > 0
    for g1, g2 in zip(got.geometries, ref.geometries):
        for k, v in vars(g2).items():
            _eq(getattr(g1, k), v, f"geometry.{k}")
    assert [vars(m) for m in got.materials] == [vars(m) for m in ref.materials]
    assert [vars(t) for t in got.textures] == [vars(t) for t in ref.textures]
    assert len(got.images) == len(ref.images)
    for i1, i2 in zip(got.images, ref.images):
        _eq(i1.data, i2.data, "image")
    for k, v in vars(ref.camera).items():
        _eq(getattr(got.camera, k), v, f"camera.{k}")
