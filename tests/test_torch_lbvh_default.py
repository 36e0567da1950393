"""The port's host triangle BVH built without a leaf group size equals
tpurt's: both default to G=4 (tpurt/bvh/lbvh.py:259), so a call that
leaves the size out builds the same leaves, the same tri_order and the
same LBVH arrays, bit for bit, on the box scene and on two fixture
scenes."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from tpurt.bvh import build_triangle_bvh as j_build_bvh
from tpurt.scene import procedural as jproc
from tpurt.scene.device import build_device_scene as j_device_scene
from tpurt.scene.gltf import load_gltf as j_load
from tpurt_torch.bvh.lbvh import build_triangle_bvh
from tpurt_torch.scene.device import build_device_scene
from tpurt_torch.scene.gltf import load_gltf

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def _path(tmp_path, name):
    if name == "box":
        return jproc.write_box_scene(str(tmp_path / "box.gltf"))
    return os.path.join(FIX, name)


@pytest.mark.parametrize("name", ["box", "lamp.gltf", "adv_multi_b.gltf"])
def test_default_group_build_equals_tpurt(tmp_path, name):
    path = _path(tmp_path, name)
    ref_tri = np.asarray(j_device_scene(j_load(path)).tri_pos)
    tri = build_device_scene(load_gltf(path), device="cpu").tri_pos.numpy()
    np.testing.assert_array_equal(tri, ref_tri)
    ref = j_build_bvh(jnp.asarray(ref_tri))
    got = build_triangle_bvh(tri)
    assert got.group_size == ref.group_size == 4
    for name_, a, b in [("tri_order", got.tri_order, ref.tri_order)] + [
            (f, getattr(got.bvh, f), getattr(ref.bvh, f)) for f in got.bvh._fields]:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name_
        assert a.tobytes() == b.tobytes(), name_
