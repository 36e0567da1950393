"""The port's rope path against tpurt: rope links and rope tables, the
plain K3/K4 walks, intersect_scene, the brute-force oracle, and renders
through Renderer(bvh=<TriBVH>).

Links and tables are byte-equal. The plain walks are held against tpurt's
Pallas kernels in interpret mode and against tpurt's XLA rope walk, on
trees carried across with convert.py: `prim` agrees except on exact-t
ties and `blocked` agrees; `t` agrees to 1e-5 relative, because XLA's CPU
backend fuses multiply-adds in these in-process runs (tests/test_torch_fma.py
holds the same walk to tpurt bit for bit with the fusion switched off).
The interpret-mode calls with masks are marked slow, as tpurt's are."""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpurt.native as j_native
from test_torch_wide import _assert_hits_agree, _random_rays, _random_tris
from tpurt.bvh import build_triangle_bvh as j_build_bvh
from tpurt.bvh import intersect_brute_force as j_brute
from tpurt.bvh import intersect_scene as j_intersect
from tpurt.bvh.lbvh import LBVH as JLBVH
from tpurt.kernels.experimental import pallas_traverse as jt
from tpurt_torch import film
from tpurt_torch import native as t_native
from tpurt_torch.bvh.lbvh import LBVH, build_triangle_bvh
from tpurt_torch.bvh.traverse import (
    closest_hit,
    intersect_brute_force,
    intersect_scene,
    occlusion_hit,
)
from tpurt_torch.camera import Camera
from tpurt_torch.config import RenderConfig, SphereLight
from tpurt_torch.convert import kernel_bvh_from_tpurt, tribvh_from_tpurt
from tpurt_torch.kernels import wide
from tpurt_torch.kernels.experimental import rope
from tpurt_torch.renderer import Renderer

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN_DIR = os.path.join(HERE, "goldens")
FIX = os.path.join(HERE, "fixtures")
NO_LIGHTS = torch.zeros((0, 8))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _tree_arrays(tb):
    out = {k: np.asarray(getattr(tb.bvh, k)) for k in tb.bvh._fields}
    out["tri_order"] = np.asarray(tb.tri_order)
    return out


def _rope_pair(tris, group, masks=None):
    """tpurt's rope KernelBVH and the port's copy of the same tables."""
    jtb = j_build_bvh(jnp.asarray(tris), group_size=group)
    jkb = jt.make_kernel_bvh(jtb, jnp.asarray(tris),
                             None if masks is None else jnp.asarray(masks))
    arrays = _tree_arrays(jtb)
    arrays.update(node_rows=np.asarray(jkb.node_rows), tri_rows=np.asarray(jkb.tri_rows))
    return jkb, kernel_bvh_from_tpurt(arrays, device="cpu")


@pytest.fixture(scope="module")
def scene_tris(tmp_path_factory):
    """scene name -> (tri_pos, tri_alpha_mask) through tpurt's loader (the
    port's device scene is equal field by field: tests/test_torch_scene.py)."""
    return functools.lru_cache(maxsize=None)(
        functools.partial(_load_scene, tmp_path_factory.mktemp("scenes")))


def _load_scene(tmp, name):
    from tpurt.scene import procedural as jproc
    from tpurt.scene.device import build_device_scene as j_dev
    from tpurt.scene.gltf import load_gltf as j_load

    if name == "box":
        paths = [jproc.write_box_scene(os.path.join(tmp, "box.gltf"))]
    elif name == "sponza":
        paths = [jproc.write_sponza_like_scene(os.path.join(tmp, "s.gltf"), columns=2,
                                               foliage=8)]
    elif name == "adv_multi":
        paths = [os.path.join(FIX, "adv_multi_a.glb"), os.path.join(FIX, "adv_multi_b.gltf")]
    else:
        paths = [os.path.join(FIX, name)]
    ds = j_dev(j_load(paths))
    return np.asarray(ds.tri_pos), np.asarray(ds.tri_alpha_mask)


# ---- rope links and rope tables --------------------------------------------

@pytest.mark.parametrize("scene", ["lamp.gltf", "adv_multi", "box", "sponza"])
@pytest.mark.parametrize("group", [1, 8, 14])
@pytest.mark.parametrize("build", ["sah", "karras"])
def test_rope_links_byte_equal_to_tpurt(monkeypatch, scene_tris, scene, group, build):
    """first/skip (and the rest of the tree) of the port's host build equal
    tpurt's byte for byte, for the SAH build and the Morton + Karras
    fallback it takes when SAH declines."""
    tris, _ = scene_tris(scene)
    if build == "karras":
        monkeypatch.setattr(j_native, "build_sah_tribvh", lambda *a: None)
        monkeypatch.setattr(t_native, "build_sah_tribvh", lambda *a: None)
    ref = _tree_arrays(j_build_bvh(jnp.asarray(tris), group_size=group))
    got = build_triangle_bvh(tris, group_size=group)
    assert got.group_size == group
    for f in LBVH._fields:
        a, b = np.asarray(getattr(got.bvh, f)), ref[f]
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f
    assert np.asarray(got.tri_order).tobytes() == ref["tri_order"].tobytes()


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("group", [8, 14])
def test_rope_tables_byte_equal_to_tpurt(scene_tris, group, masks):
    """pack_scene_for_kernel equals tpurt's; the mask column appears only
    when G*10 <= 128 (at G=8, not at G=14)."""
    tris, alpha_mask = scene_tris("sponza")
    jtb = j_build_bvh(jnp.asarray(tris), group_size=group)
    mk = alpha_mask if masks else None
    jkb = jt.make_kernel_bvh(jtb, jnp.asarray(tris), None if mk is None else jnp.asarray(mk))
    kb = rope.make_kernel_bvh(tribvh_from_tpurt(_tree_arrays(jtb)), tris, mk, device="cpu")
    for f in ("node_rows", "tri_rows"):
        a, b = getattr(kb, f).numpy(), np.asarray(getattr(jkb, f))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert kb.use_masks == (masks and group * 10 <= 128)
    assert rope.kernel_supported(kb.tribvh) == jt.kernel_supported(jtb, jnp.asarray(tris))


def test_pick_group_size_matches_tpurt():
    for n in (10, 5000, 215296, 2_000_000):
        assert rope.pick_group_size(n) == jt.pick_group_size(n)
    assert rope.KERNEL_GROUP == jt.KERNEL_GROUP and rope.PACKET == jt.PACKET


def test_convert_carries_tpurt_trees_and_tables():
    tris = _random_tris(200, seed=41)
    jkb, kb = _rope_pair(tris, 8)
    tb = kb.tribvh
    for f in LBVH._fields:
        np.testing.assert_array_equal(getattr(tb.bvh, f), np.asarray(getattr(jkb.tribvh.bvh, f)))
    np.testing.assert_array_equal(tb.tri_order, np.asarray(jkb.tribvh.tri_order))
    assert tb.group_size == 8 and kb.n_internal == tb.bvh.num_leaves - 1
    np.testing.assert_array_equal(kb.node_rows.numpy(), np.asarray(jkb.node_rows))
    np.testing.assert_array_equal(kb.tri_order.numpy(), np.asarray(jkb.tribvh.tri_order))
    # the port packs the same tables from the carried tree
    own = rope.make_kernel_bvh(tribvh_from_tpurt(_tree_arrays(jkb.tribvh)), tris, device="cpu")
    assert own.tri_rows.numpy().tobytes() == kb.tri_rows.numpy().tobytes()


# ---- plain K3 / K4 against tpurt's interpret-mode kernels -------------------

def test_plain_k3_matches_interpret_kernel():
    """Every fourth ray inactive: inactive rays miss at t_max; active ones
    agree with the interpret-mode kernel, u/v too."""
    tris = _random_tris(300, seed=3)
    jkb, kb = _rope_pair(tris, 14)
    o, d = _random_rays(1024, seed=4)
    active = np.arange(1024) % 4 != 0
    jt_, jp, ju, jv = jt.traverse_packets(jkb, jnp.asarray(o), jnp.asarray(d), jnp.zeros(1024),
                                          1e9, jnp.asarray(active), interpret=True)
    t, p, u, v = rope.traverse_packets(kb, _t(o), _t(d), torch.zeros(1024), 1e9, _t(active))
    assert (p.numpy()[~active] == -1).all() and (t.numpy()[~active] == np.float32(1e9)).all()
    assert (np.asarray(jp) >= 0).sum() > 20
    diff = _assert_hits_agree(t.numpy(), p.numpy(), jt_, jp, tris, o, d)
    same = (np.asarray(jp) >= 0) & ~diff
    np.testing.assert_allclose(u.numpy()[same], np.asarray(ju)[same], atol=1e-5)
    np.testing.assert_allclose(v.numpy()[same], np.asarray(jv)[same], atol=1e-5)


def test_plain_k4_matches_interpret_kernel():
    """No masks, no alpha: every hit in (0, t_limit) blocks."""
    tris = _random_tris(300, seed=11)
    jkb, kb = _rope_pair(tris, 14)
    o, d = _random_rays(1024, seed=12)
    t_limit = (0.3 + 3.0 * np.random.RandomState(13).rand(1024)).astype(np.float32)
    jb, _, jp, _, _ = jt.occlusion_packets(jkb, jnp.asarray(o), jnp.asarray(d),
                                           jnp.zeros(1024), jnp.asarray(t_limit),
                                           jnp.ones(1024, bool), scene_has_alpha=False,
                                           interpret=True)
    b, t, p, _, _ = rope.occlusion_packets(kb, _t(o), _t(d), torch.zeros(1024), _t(t_limit),
                                           torch.ones(1024, dtype=torch.bool), False)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    assert b.numpy().sum() > 10
    ref = j_brute(jnp.asarray(tris), jnp.zeros((0, 8)), jnp.asarray(o), jnp.asarray(d),
                  jnp.zeros(1024), 1e9, include_spheres=False)
    np.testing.assert_array_equal(b.numpy(), (np.asarray(ref.kind) == 1)
                                  & (np.asarray(ref.t) < t_limit))
    assert (p.numpy()[~b.numpy()] == -1).all()


def _one_octant_rays(n, seed):
    """Rays with all-positive directions: each ray's octant is the packet's,
    so the port's walk and tpurt's visit nodes in the same order."""
    o, d = _random_rays(n, seed=seed)
    return o, np.abs(d)


@pytest.mark.slow
def test_plain_k3_masks_match_interpret_kernel():
    """G=8 with the mask column: hits in transparent cells are skipped."""
    tris = _random_tris(300, seed=31)
    r = np.random.RandomState(32)
    masks = ((r.rand(300) < 0.5).astype(np.int32) << 16) | r.randint(0, 1 << 16, 300)
    jkb, kb = _rope_pair(tris, 8, masks.astype(np.int32))
    assert kb.use_masks
    o, d = _random_rays(1024, seed=33)
    ones = np.ones(1024, bool)
    jt_, jp, _, _ = jt.traverse_packets(jkb, jnp.asarray(o), jnp.asarray(d), jnp.zeros(1024),
                                        1e9, jnp.asarray(ones), interpret=True)
    t, p, _, _ = rope.traverse_packets(kb, _t(o), _t(d), torch.zeros(1024), 1e9, _t(ones))
    _assert_hits_agree(t.numpy(), p.numpy(), jt_, jp, tris, o, d)
    _, p0, _, _ = rope.traverse_packets(
        rope.make_kernel_bvh(kb.tribvh, tris, device="cpu"), _t(o), _t(d),
        torch.zeros(1024), 1e9, _t(ones))
    assert (p0.numpy() != p.numpy()).any()  # the masks did reject hits


@pytest.mark.slow
def test_plain_k4_mixed_definite_matches_interpret_kernel():
    """Mixed definite / alpha-testable triangles with transparent cells, on
    one-octant rays: the same blocked set, and an unblocked ray's
    uncertain hit is the same triangle."""
    tris = _random_tris(300, seed=34)
    r = np.random.RandomState(35)
    masks = ((r.rand(300) < 0.5).astype(np.int32) << 16) | (r.randint(0, 1 << 16, 300) & 0x0F0F)
    jkb, kb = _rope_pair(tris, 8, masks.astype(np.int32))
    o, d = _one_octant_rays(1024, seed=36)
    lim = np.full(1024, 1e9, np.float32)
    jb, jt_, jp, _, _ = jt.occlusion_packets(jkb, jnp.asarray(o), jnp.asarray(d),
                                             jnp.zeros(1024), jnp.asarray(lim),
                                             jnp.ones(1024, bool), scene_has_alpha=True,
                                             interpret=True)
    b, t, p, _, _ = rope.occlusion_packets(kb, _t(o), _t(d), torch.zeros(1024), _t(lim),
                                           torch.ones(1024, dtype=torch.bool), True)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    free = ~b.numpy()
    assert b.numpy().sum() > 10 and (p.numpy()[free] >= 0).sum() > 10
    _assert_hits_agree(t.numpy()[free], p.numpy()[free], np.asarray(jt_)[free],
                       np.asarray(jp)[free], tris, o[free], d[free])


def test_plain_walk_caps_a_broken_rope():
    """A skip link that points back at the root loops; the walk stops at
    its 4*M step cap and raises instead of spinning."""
    tris = _random_tris(100, seed=7)
    kb = rope.make_kernel_bvh(build_triangle_bvh(tris, 4), tris, device="cpu")
    rows = kb.node_rows.clone()
    rows[:, kb.n_internal:, 7] = 0.0  # every leaf's miss link -> root
    o, d = _random_rays(64, seed=8)
    with pytest.raises(RuntimeError, match="step cap"):
        rope.traverse_plain(rows, kb.tri_rows, _t(o), _t(d), torch.zeros(64),
                            torch.full((64,), 1e9), torch.ones(64, dtype=torch.bool),
                            n_internal=kb.n_internal, group=4, occlusion=False,
                            all_definite=False)


# ---- intersect_scene / brute force against tpurt -----------------------------

def _scene_rays(tris, kind, n=2048, seed=51):
    """Camera-like rays (a pinhole fan from outside the scene) or bounce
    rays (from the camera rays' hits, random directions on the front side),
    as numpy."""
    r = np.random.RandomState(seed)
    lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    centre = 0.5 * (lo + hi)
    eye = centre + np.array([0.1, 0.2, 1.5]) * (hi - lo) + 0.3
    target = lo + r.rand(n, 3) * (hi - lo)
    d = target - eye
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.repeat(eye[None], n, axis=0).astype(np.float32)
    if kind == "camera":
        return o, d
    h = intersect_scene(build_triangle_bvh(tris, 8), tris, NO_LIGHTS, _t(o), _t(d),
                        torch.zeros(n), 1e9)
    hit = h.prim.numpy() >= 0
    p = o + np.where(hit, h.t.numpy(), 0.0)[:, None] * d - 1e-3 * d
    nd = r.randn(n, 3)
    nd = nd / np.linalg.norm(nd, axis=1, keepdims=True)
    nd = np.where((nd * d).sum(1, keepdims=True) > 0, -nd, nd)
    return p.astype(np.float32), nd.astype(np.float32)


@pytest.mark.parametrize("kind", ["camera", "bounce"])
def test_intersect_scene_matches_tpurt(scene_tris, kind):
    """The port's rope walk against tpurt's XLA walk on the same tree, with
    a sphere light in the scene."""
    tris, _ = scene_tris("sponza")
    jtb = j_build_bvh(jnp.asarray(tris), group_size=8)
    tb = tribvh_from_tpurt(_tree_arrays(jtb))
    o, d = _scene_rays(tris, kind)
    # a sphere light on the first ray's path, so some rays end on it
    at = o[0] + 0.2 * d[0] * np.linalg.norm(tris.reshape(-1, 3).max(0) - o[0])
    lights = np.array([[*at, 0.8, 1.0, 0.9, 0.8, 50.0]], np.float32)
    n = o.shape[0]
    active = np.arange(n) % 7 != 0
    ref = j_intersect(jtb, jnp.asarray(tris), jnp.asarray(lights), jnp.asarray(o),
                      jnp.asarray(d), jnp.zeros(n), 1e9, include_spheres=True,
                      active=jnp.asarray(active))
    got = intersect_scene(tb, tris, _t(lights), _t(o), _t(d), torch.zeros(n), 1e9,
                          include_spheres=True, active=_t(active))
    np.testing.assert_array_equal(got.kind.numpy(), np.asarray(ref.kind))
    tri = np.asarray(ref.kind) == 1
    assert tri.sum() > n // 20 and (np.asarray(ref.kind) == 2).any()
    sph = np.asarray(ref.kind) == 2
    np.testing.assert_array_equal(got.prim.numpy()[sph], np.asarray(ref.prim)[sph])
    np.testing.assert_array_equal(got.t.numpy()[~tri & ~sph], np.float32(1e9))
    # the sphere quadratic's cancellation magnifies the fused multiply-add's
    # rounding to ~2e-5 here; tests/test_torch_fma.py holds it bit for bit
    np.testing.assert_allclose(got.t.numpy()[sph], np.asarray(ref.t)[sph], rtol=1e-4)
    _assert_hits_agree(got.t.numpy()[tri], got.prim.numpy()[tri], np.asarray(ref.t)[tri],
                       np.asarray(ref.prim)[tri], tris, o[tri], d[tri])
    # closest_hit takes the rope path for the rope tables
    kb = rope.make_kernel_bvh(tb, tris, device="cpu")
    h2 = closest_hit(kb, _t(lights), _t(o), _t(d), torch.zeros(n), 1e9, active=_t(active))
    for a, b in zip(got, h2):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_intersect_scene_plain_lbvh_and_single_leaf():
    """A plain LBVH over single triangles (G = 1 through leaf_prim), and
    the one-leaf tree that has no internal node, against tpurt."""
    tris = _random_tris(150, seed=61)
    o, d = _random_rays(1024, seed=62)
    pmin, pmax = tris.min(axis=1), tris.max(axis=1)
    ports = t_native.build_lbvh_native(pmin, pmax)
    jl = JLBVH(*(jnp.asarray(getattr(ports, f)) for f in LBVH._fields))
    one = LBVH(left=np.zeros(0, np.int32), right=np.zeros(0, np.int32),
               node_min=pmin[3:4], node_max=pmax[3:4], leaf_prim=np.array([3], np.int32),
               first=np.zeros((8, 0), np.int32), skip=np.ones((8, 1), np.int32))
    j_one = JLBVH(*(jnp.asarray(getattr(one, f)) for f in LBVH._fields))
    # the single-leaf rays aim near triangle 3, so about half of them hit it
    aim = tris[3].mean(axis=0) + 0.3 * np.random.RandomState(63).randn(1024, 3)
    d_one = (aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
    for bvh, jbvh, dd in ((ports, jl, d), (one, j_one, d_one.astype(np.float32))):
        ref = j_intersect(jbvh, jnp.asarray(tris), jnp.zeros((0, 8)), jnp.asarray(o),
                          jnp.asarray(dd), jnp.zeros(1024), 1e9, include_spheres=False)
        got = intersect_scene(bvh, tris, NO_LIGHTS, _t(o), _t(dd), torch.zeros(1024), 1e9,
                              include_spheres=False)
        assert (np.asarray(ref.prim) >= 0).sum() > 20
        _assert_hits_agree(got.t.numpy(), got.prim.numpy(), ref.t, ref.prim, tris, o, dd)
    np.testing.assert_array_equal(got.prim.numpy() >= 0, np.asarray(ref.prim) == 3)


def test_intersect_brute_force_matches_tpurt():
    tris = _random_tris(120, seed=71)
    o, d = _random_rays(1024, seed=72)
    lights = np.array([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1.0, 10.0]], np.float32)
    ref = j_brute(jnp.asarray(tris), jnp.asarray(lights), jnp.asarray(o), jnp.asarray(d),
                  jnp.zeros(1024), 1e9)
    got = intersect_brute_force(_t(tris), _t(lights), _t(o), _t(d), torch.zeros(1024), 1e9)
    np.testing.assert_array_equal(got.kind.numpy(), np.asarray(ref.kind))
    tri = np.asarray(ref.kind) == 1
    _assert_hits_agree(got.t.numpy()[tri], got.prim.numpy()[tri], np.asarray(ref.t)[tri],
                       np.asarray(ref.prim)[tri], tris, o[tri], d[tri])
    np.testing.assert_array_equal(got.prim.numpy()[~tri], np.asarray(ref.prim)[~tri])


def test_occlusion_hit_takes_the_wide_tables_only():
    tris = _random_tris(50, seed=81)
    kb = rope.make_kernel_bvh(build_triangle_bvh(tris, 8), tris, device="cpu")
    o, d = _random_rays(8, seed=82)
    with pytest.raises(TypeError):
        occlusion_hit(kb, _t(o), _t(d), torch.zeros(8), torch.ones(8),
                      torch.ones(8, dtype=torch.bool), False)


# ---- renders through the rope path --------------------------------------------

BOX_POSE = ([1.5, 1.2, 2.0], float(np.arctan2(-1.5, -2.0)), -0.45)
BOX_LIGHT = ((2.0, 2.0, 2.0), 0.3, (1.0, 0.9, 0.8), 50.0)


def _rope_renderer(path, cfg, camera=None, lights=(), group=8):
    """Renderer(bvh=<TriBVH>) built from the scene's own triangles."""
    from tpurt_torch.scene.device import build_device_scene
    from tpurt_torch.scene.gltf import load_gltf

    scene = load_gltf(path)
    tri = build_device_scene(scene, lights=lights, device="cpu").tri_pos.numpy()
    return Renderer(scene, config=cfg, camera=camera, lights=lights, device="cpu",
                    bvh=build_triangle_bvh(tri, group_size=group))


def _golden(name):
    return np.load(os.path.join(GOLDEN_DIR, name))["accum"]


def test_box_golden_through_rope_path(tmp_path):
    from tpurt_torch.scene.procedural import write_box_scene

    path = write_box_scene(str(tmp_path / "box.gltf"))
    r = _rope_renderer(path, RenderConfig(width=64, height=48, max_samples=8),
                       Camera.from_angles(*BOX_POSE), [SphereLight(*BOX_LIGHT)])
    assert isinstance(r.bvh, rope.KernelBVH) and not r.bvh.use_masks
    img = r.render(8).numpy()
    assert np.isfinite(img).all()
    err = film.rmse(img, _golden("box_64x48_8spp.npz"))
    assert err < 1e-5, f"box golden through the rope path: RMSE={err}"


@pytest.mark.slow
def test_helmet_golden_through_rope_path(tmp_path):
    from tpurt.scene import procedural as jproc

    path = jproc.write_helmet_like_scene(str(tmp_path / "helmet.gltf"))
    r = _rope_renderer(path, RenderConfig(width=64, height=48, max_samples=8))
    err = film.rmse(r.render(8).numpy(), _golden("helmet_64x48_8spp.npz"))
    assert err < 1e-5, f"helmet golden through the rope path: RMSE={err}"


@pytest.mark.slow
def test_lantern_golden_through_rope_path(tmp_path):
    from tpurt.scene import procedural as jproc

    path = jproc.write_lantern_like_scene(str(tmp_path / "l.gltf"))
    cam = Camera.from_angles([4.0, -2.0, 6.0], float(np.arctan2(-4.0, -6.0)), 0.1)
    r = _rope_renderer(path, RenderConfig(width=64, height=48, max_samples=4), cam)
    err = film.rmse(r.render(4).numpy(), _golden("lantern_64x48_4spp.npz"))
    assert err < 1e-5, f"lantern golden through the rope path: RMSE={err}"


def test_rope_render_matches_wide_render(tmp_path):
    """Same scene, camera, seed and sample count through both paths, with
    two shadow rays per hit (fold_bsdf_mis=False): the rope path's full
    trace of shadow rays gives the wide path's occlusion answers."""
    from tpurt_torch.scene.procedural import write_box_scene

    path = write_box_scene(str(tmp_path / "box.gltf"))
    cfg = RenderConfig(width=32, height=24, max_samples=4, fold_bsdf_mis=False, seed=5)
    lights = [SphereLight(*BOX_LIGHT)]
    cam = Camera.from_angles(*BOX_POSE)
    rw = Renderer.from_gltf(path, config=cfg, camera=cam, lights=lights, device="cpu")
    rr = _rope_renderer(path, cfg, cam, lights)
    assert isinstance(rw.bvh, wide.WideKernelBVH) and isinstance(rr.bvh, rope.KernelBVH)
    a, b = rw.render(4).numpy(), rr.render(4).numpy()
    assert float(a[..., :3].mean()) > 0.0
    assert film.rmse(b, a) < 1e-5
    assert rr.rays.physical == rw.rays.physical


def test_renderer_picks_the_rope_path(tmp_path, monkeypatch):
    """bvh=<TriBVH> takes the rope path with that tree; a wide BVH passed
    in is used as it is; without bvh= the rope path is taken when the
    leaves do not fit the wide leaf row (G*10 > 128)."""
    import tpurt_torch.renderer as renderer_mod
    from tpurt_torch.scene.procedural import write_box_scene

    path = write_box_scene(str(tmp_path / "box.gltf"))
    cfg = RenderConfig(width=8, height=6, max_samples=1)
    r = _rope_renderer(path, cfg, group=4)
    assert isinstance(r.bvh, rope.KernelBVH) and r.bvh.group_size == 4
    # cache=False: these starts test which build runs, which a warm start skips
    rw = Renderer.from_gltf(path, config=cfg, device="cpu", cache=False)
    assert isinstance(rw.bvh, wide.WideKernelBVH) and wide.wide_supported(rw.bvh.tribvh)
    assert Renderer.from_gltf(path, config=cfg, device="cpu", bvh=rw.bvh).bvh is rw.bvh
    with pytest.raises(TypeError):
        Renderer.from_gltf(path, config=cfg, device="cpu", bvh=rw.bvh.tribvh.bvh)
    monkeypatch.setattr(renderer_mod, "pick_group_size_wide", lambda n: 13)
    r13 = Renderer.from_gltf(path, config=cfg, device="cpu", cache=False)
    assert not wide.wide_supported(r13.bvh.tribvh)
    assert isinstance(r13.bvh, rope.KernelBVH) and r13.bvh.group_size == 13
    assert np.isfinite(r13.render(1).numpy()).all()
