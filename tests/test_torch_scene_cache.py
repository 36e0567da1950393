"""The port's scene-artifact cache (tpurt_torch/scene/cache.py), with
tests/test_scene_cache.py's four cases on the port: a warm start is
bit-identical to the cold one, the key tracks the scene bytes (sidecars
too), the lights, the arity and the backend, the caller's camera is not
baked in, a corrupt file falls back to a cold build. Then the shared
file format, both ways: tpurt's artifacts load in the port, and the
port's in tpurt, with every array equal."""

import os

import numpy as np
import pytest
import torch

from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene import cache as scache
from tpurt_torch.scene.procedural import write_box_scene, write_sponza_like_scene
from tpurt_torch.scene.samples import write_khronos_box

_LIGHT = ((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)
_LIGHTS = [SphereLight(*_LIGHT)]
_MINI = dict(columns=1, foliage=8, stacks=1, segments=8, rings=6)


def _cfg():
    return RenderConfig(width=32, height=24, max_samples=2)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def _leaves(prefix, x):
    """(name, array) of every tensor or array field, recursively."""
    if hasattr(x, "_fields"):
        for k in x._fields:
            yield from _leaves(f"{prefix}.{k}", getattr(x, k))
    elif hasattr(x, "__dataclass_fields__"):
        for k in x.__dataclass_fields__:
            yield from _leaves(f"{prefix}.{k}", getattr(x, k))
    elif isinstance(x, (torch.Tensor, np.ndarray)):
        yield prefix, x
    else:
        yield prefix, np.asarray(x)


def test_warm_start_bit_identical(tmp_path, monkeypatch):
    monkeypatch.setenv("TPURT_SCENE_CACHE_DIR", str(tmp_path / "cache"))
    path = write_box_scene(str(tmp_path / "box.gltf"))
    cold = Renderer.from_gltf(path, config=_cfg(), lights=_LIGHTS, device="cpu")
    files = os.listdir(str(tmp_path / "cache"))
    assert len(files) == 1 and files[0].endswith(".npz")
    assert {"gltf_load_s", "sah_s", "pack_s", "cache_save_s"} <= set(cold.timings)

    warm = Renderer.from_gltf(path, config=_cfg(), lights=_LIGHTS, device="cpu")
    assert set(warm.timings) == {"cache_load_s"}
    # every device-scene array, every BVH array (card tables and bounds
    # included) and the default camera are the cold build's
    for (na, a), (nb, b) in zip(_leaves("ds", cold.device_scene),
                                _leaves("ds", warm.device_scene)):
        assert na == nb
        _eq(a, b, na)
    cold_bvh, warm_bvh = list(_leaves("bvh", cold.bvh)), list(_leaves("bvh", warm.bvh))
    assert [n for n, _ in cold_bvh] == [n for n, _ in warm_bvh]
    assert "bvh.card.nodes" in dict(cold_bvh) and "bvh.stack_bound" in dict(cold_bvh)
    for (na, a), (_, b) in zip(cold_bvh, warm_bvh):
        _eq(a, b, na)
    for a, b in zip(cold.camera, warm.camera):
        _eq(a, b, "camera")
    assert cold.has_alpha == warm.has_alpha
    assert cold.tex_flags == warm.tex_flags

    cold.render(2)
    warm.render(2)
    assert torch.equal(cold.accum, warm.accum)


def test_cache_key_tracks_scene_sidecar_lights_arity_and_backend(tmp_path):
    from tpurt.scene import cache as jcache

    p1 = write_box_scene(str(tmp_path / "a.gltf"))
    k1 = scache.scene_cache_key([p1], _LIGHTS, 16, "torch-cpu")
    # same bytes, another path: the same key
    p2 = str(tmp_path / "b.gltf")
    with open(p1, "rb") as f:
        data = f.read()
    with open(p2, "wb") as f:
        f.write(data)
    assert scache.scene_cache_key([p2], _LIGHTS, 16, "torch-cpu") == k1
    # other lights, arity, backend or bytes: other keys
    other = [SphereLight((0.0, 1.0, 0.0), 0.1, (1.0, 1.0, 1.0), 10.0)]
    assert scache.scene_cache_key([p1], other, 16, "torch-cpu") != k1
    assert scache.scene_cache_key([p1], _LIGHTS, 8, "torch-cpu") != k1
    assert scache.scene_cache_key([p1], _LIGHTS, 16, "torch-cuda") != k1
    with open(p2, "ab") as f:
        f.write(b" ")
    assert scache.scene_cache_key([p2], _LIGHTS, 16, "torch-cpu") != k1
    # a sidecar buffer named by URI is part of the key
    box = write_khronos_box(str(tmp_path / "Box.gltf"))
    kb = scache.scene_cache_key([box], _LIGHTS, 16, "torch-cpu")
    with open(tmp_path / "Box0.bin", "r+b") as f:
        f.seek(0)
        f.write(b"\x01")
    assert scache.scene_cache_key([box], _LIGHTS, 16, "torch-cpu") != kb
    # the hash is tpurt's; only the backend names keep the packages apart
    from tpurt.config import SphereLight as JSphereLight

    jl = [JSphereLight(*_LIGHT)]
    assert jcache.scene_cache_key([p1], jl, 16, "cpu") == scache.scene_cache_key(
        [p1], _LIGHTS, 16, "cpu")
    assert scache.backend_name("cpu") == "torch-cpu"
    assert jcache.scene_cache_key([p1], jl, 16, "cpu") != k1


def test_user_camera_not_baked_into_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("TPURT_SCENE_CACHE_DIR", str(tmp_path / "cache"))
    path = write_box_scene(str(tmp_path / "box.gltf"))
    custom = Camera.from_angles([9.0, 9.0, 9.0], 1.0, 0.5)
    r1 = Renderer.from_gltf(path, config=_cfg(), camera=custom, device="cpu")
    _eq(r1.camera.position, custom.position, "custom camera")
    # a warm start without a camera resolves the scene's default, not the
    # previous caller's camera
    cold_default = Renderer.from_gltf(path, config=_cfg(), device="cpu", cache=False)
    warm_default = Renderer.from_gltf(path, config=_cfg(), device="cpu")
    assert set(warm_default.timings) == {"cache_load_s"}
    for a, b in zip(warm_default.camera, cold_default.camera):
        _eq(a, b, "default camera")


def test_corrupt_or_partial_cache_falls_back(tmp_path, monkeypatch):
    monkeypatch.setenv("TPURT_SCENE_CACHE_DIR", str(tmp_path / "cache"))
    path = write_box_scene(str(tmp_path / "box.gltf"))
    Renderer.from_gltf(path, config=_cfg(), device="cpu")
    cdir = str(tmp_path / "cache")
    fname = os.path.join(cdir, os.listdir(cdir)[0])
    data = dict(np.load(fname))
    with open(fname, "wb") as f:
        f.write(b"not an npz")
    assert scache.load_artifacts(fname, device="cpu") is None
    r = Renderer.from_gltf(path, config=_cfg(), device="cpu")  # cold rebuild, no raise
    assert r.device_scene.tri_pos.shape[0] > 0 and "sah_s" in r.timings
    del data["bvh/tri_rows"]
    np.savez(fname, **data)
    assert scache.load_artifacts(fname, device="cpu") is None
    assert "sah_s" in Renderer.from_gltf(path, config=_cfg(), device="cpu").timings


# ---- the shared format ------------------------------------------------------

@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The alpha-tested mini Sponza: tpurt's device scene, TriBVH, wide
    BVH and default camera, and the port's renderer of the same file."""
    import jax.numpy as jnp

    from tpurt.bvh import build_triangle_bvh as j_build_bvh
    from tpurt.config import SphereLight as JSphereLight
    from tpurt.kernels import pallas_wide as jw
    from tpurt.scene.device import build_device_scene as j_dev
    from tpurt.scene.gltf import camera_for_render as j_cam
    from tpurt.scene.gltf import load_gltf as j_load

    path = write_sponza_like_scene(str(tmp_path_factory.mktemp("mini") / "s.gltf"), **_MINI)
    sd = j_load(path)
    ds = j_dev(sd, lights=[JSphereLight(*_LIGHT)])
    jtb = j_build_bvh(ds.tri_pos, group_size=jw.pick_group_size_wide(int(ds.tri_pos.shape[0])))
    jkb = jw.make_wide_kernel_bvh(jtb, ds.tri_pos, tri_alpha_mask=ds.tri_alpha_mask,
                                  tri_alpha_opaque=ds.tri_alpha_opaque)
    assert bool(jnp.asarray(ds.tri_alpha).any())
    port = Renderer.from_gltf(path, config=_cfg(), lights=_LIGHTS, device="cpu", cache=False)
    return dict(path=path, ds=ds, tri=jtb, wide=jkb, camera=j_cam(sd.camera), port=port)


def _tribvh_eq(got, want):
    for k in want.bvh._fields:
        _eq(getattr(got.bvh, k), getattr(want.bvh, k), f"tribvh.bvh.{k}")
    _eq(got.tri_order, want.tri_order, "tribvh.tri_order")


def _scene_eq(got, want):
    for k in want._fields:
        if k == "materials":
            for m in want.materials._fields:
                _eq(getattr(got.materials, m), getattr(want.materials, m), f"materials.{m}")
        else:
            _eq(getattr(got, k), getattr(want, k), k)


@pytest.mark.parametrize("kind", ["wide", "tri"])
def test_tpurt_artifact_loads_in_the_port(scenes, tmp_path, kind):
    from tpurt.scene import cache as jcache

    path = str(tmp_path / "a.npz")
    jcache.save_artifacts(path, scenes["ds"], scenes[kind], camera=scenes["camera"])
    ds, bvh, cam = scache.load_artifacts(path, device="cpu")
    _scene_eq(ds, scenes["ds"])
    for a, b in zip(cam, scenes["camera"]):
        _eq(a, b, "camera")
    if kind == "tri":
        _tribvh_eq(bvh, scenes["tri"])
        return
    jkb = scenes["wide"]
    _tribvh_eq(bvh.tribvh, jkb.tribvh)
    for k in ("node_rows", "tri_rows", "tri_pos"):
        _eq(getattr(bvh, k), getattr(jkb, k), k)
    assert bvh.arity == jkb.arity and bvh.card is not None and bvh.use_opaque
    # the derived fields are those of the port's own pack of the same tree
    from tpurt_torch.kernels import wide

    own = wide.make_wide_kernel_bvh(bvh.tribvh, ds.tri_pos, tri_alpha_mask=ds.tri_alpha_mask,
                                    tri_alpha_opaque=ds.tri_alpha_opaque, device="cpu")
    assert (bvh.stack_bound, bvh.depth_bound) == (own.stack_bound, own.depth_bound)
    for k in ("node_rows", "tri_rows"):
        _eq(getattr(bvh, k), getattr(own, k), k)
    for k in ("nodes", "leaves"):
        _eq(getattr(bvh.card, k), getattr(own.card, k), f"card.{k}")


@pytest.mark.parametrize("kind", ["wide", "tri"])
def test_port_artifact_loads_in_tpurt(scenes, tmp_path, kind):
    from tpurt.scene import cache as jcache
    from tpurt_torch.scene.gltf import camera_for_render, load_gltf

    r = scenes["port"]
    bvh = r.bvh if kind == "wide" else r.bvh.tribvh
    default_cam = camera_for_render(load_gltf(scenes["path"]).camera)
    mine, theirs = str(tmp_path / "mine.npz"), str(tmp_path / "theirs.npz")
    scache.save_artifacts(mine, r.device_scene, bvh, camera=default_cam)
    jcache.save_artifacts(theirs, scenes["ds"], scenes[kind], camera=scenes["camera"])
    a, b = np.load(mine), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype and a[k].ndim == b[k].ndim, k
    if kind == "wide":
        for k in ("node_rows", "tri_rows", "tri_pos"):
            _eq(a[f"bvh/{k}"], getattr(r.bvh, k), k)

    ds, jbvh, cam = jcache.load_artifacts(mine)
    _scene_eq(ds, r.device_scene)
    # on the CPU backend tpurt takes the TriBVH a wide artifact carries
    _tribvh_eq(jbvh, r.bvh.tribvh)
    for x, y in zip(cam, default_cam):
        _eq(x, y, "camera")
