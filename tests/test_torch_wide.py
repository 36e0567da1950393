"""The port's wide-BVH tables and plain K1/K2 traversal against tpurt.

Tables: node_rows and tri_rows byte-equal to tpurt's make_wide_kernel_bvh
(both build the same native SAH tree). Traversal: the plain version against
tpurt's Pallas kernel in interpret mode (`_wide_packets` through
traverse_packets / occlusion_packets), on tables carried across with
convert.py, run the way tests/test_wide_kernel.py runs it. `prim` agrees
except on exact-t ties. The interpret-mode kernel runs through XLA's CPU backend, which contracts multiply-adds into
FMAs, while the port (and its CUDA kernel, built with --fmad=false) does
not, so the last bits of t can differ: t agrees to 1e-5 relative (a few
ulps). Each interpret-mode call costs ~15 s of tracing, so the fast gate
runs two of them and the rest are marked slow, as tpurt's are."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh import build_triangle_bvh as j_build_bvh
from tpurt.bvh import intersect_brute_force
from tpurt.kernels import pallas_wide as jw
from tpurt_torch.bvh.lbvh import build_triangle_bvh
from tpurt_torch.bvh.traverse import closest_hit, occlusion_hit
from tpurt_torch.convert import scene_from_numpy, wide_bvh_from_numpy
from tpurt_torch.kernels import wide


def _random_tris(n, seed=0, spread=10.0):
    r = np.random.RandomState(seed)
    base = (r.rand(n, 1, 3) - 0.5) * spread
    return (base + (r.rand(n, 3, 3) - 0.5)).astype(np.float32)


def _random_rays(n, seed=1, spread=12.0):
    r = np.random.RandomState(seed)
    o = ((r.rand(n, 3) - 0.5) * spread).astype(np.float32)
    d = r.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def _wide_arrays(kb):
    tb = kb.tribvh
    out = {k: np.asarray(getattr(tb.bvh, k)) for k in tb.bvh._fields}
    out.update(tri_order=np.asarray(tb.tri_order), node_rows=np.asarray(kb.node_rows),
               tri_rows=np.asarray(kb.tri_rows), tri_pos=np.asarray(kb.tri_pos),
               arity=kb.arity)
    return out


def _pair(tris, group=4, masks=None, opaque=None):
    """tpurt's kernel BVH and the port's copy of the same tables."""
    jtb = j_build_bvh(jnp.asarray(tris), group_size=group)
    jkb = jw.make_wide_kernel_bvh(jtb, jnp.asarray(tris),
                                  tri_alpha_mask=None if masks is None else jnp.asarray(masks),
                                  tri_alpha_opaque=None if opaque is None else jnp.asarray(opaque))
    return jkb, wide_bvh_from_numpy(_wide_arrays(jkb), device="cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _hit_t(tris, o, d, prim):
    """Float64 Moller-Trumbore: the t at which each ray hits triangle
    `prim` (NaN where it misses)."""
    v = tris[prim].astype(np.float64)
    o, d = o.astype(np.float64), d.astype(np.float64)
    e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    pv = np.cross(d, e2)
    det = (e1 * pv).sum(-1)
    s = o - v[:, 0]
    u = (s * pv).sum(-1) / det
    q = np.cross(s, e1)
    w = (d * q).sum(-1) / det
    t = (e2 * q).sum(-1) / det
    ok = (np.abs(det) > 1e-12) & (u >= -1e-6) & (w >= -1e-6) & (u + w <= 1 + 1e-6) & (t > 0)
    return np.where(ok, t, np.nan)


def _assert_hits_agree(t_got, p_got, t_ref, p_ref, tris, o, d):
    p_got, p_ref = np.asarray(p_got), np.asarray(p_ref)
    t_got, t_ref = np.asarray(t_got), np.asarray(t_ref)
    np.testing.assert_array_equal(p_got >= 0, p_ref >= 0)
    hit = p_ref >= 0
    np.testing.assert_allclose(t_got[hit], t_ref[hit], rtol=1e-5, atol=0)
    diff = hit & (p_got != p_ref)
    # a differing prim must be a tie: the ray hits both triangles at the
    # same t (to the 1e-5 the two packages' t agree to)
    if diff.any():
        ta = _hit_t(tris, o[diff], d[diff], p_got[diff])
        tb = _hit_t(tris, o[diff], d[diff], p_ref[diff])
        np.testing.assert_allclose(ta, t_ref[diff], rtol=1e-5, atol=0)
        np.testing.assert_allclose(tb, t_ref[diff], rtol=1e-5, atol=0)
    return diff


# ---- tables -------------------------------------------------------------

def _scene_tables(tmp_path, which):
    from tpurt.scene import procedural as jproc
    from tpurt.scene.gltf import load_gltf as j_load
    from tpurt.scene.device import build_device_scene as j_dev
    from tpurt_torch.renderer import Renderer

    if which == "box":
        path = jproc.write_box_scene(str(tmp_path / "box.gltf"))
    else:
        path = jproc.write_sponza_like_scene(str(tmp_path / "s.gltf"), columns=2, foliage=8)
    ds = j_dev(j_load(path))
    has_alpha = bool(np.asarray(ds.tri_alpha).any())
    g = jw.pick_group_size_wide(int(ds.tri_pos.shape[0]))
    jtb = j_build_bvh(ds.tri_pos, group_size=g)
    jkb = jw.make_wide_kernel_bvh(jtb, ds.tri_pos,
                                  tri_alpha_mask=ds.tri_alpha_mask if has_alpha else None,
                                  tri_alpha_opaque=ds.tri_alpha_opaque if has_alpha else None)
    r = Renderer.from_gltf(path, device="cpu")
    return jkb, r.bvh, has_alpha


@pytest.mark.parametrize("which", ["box", "sponza"])
def test_tables_byte_equal_to_tpurt(tmp_path, which):
    jkb, kb, has_alpha = _scene_tables(tmp_path, which)
    assert has_alpha == (which == "sponza")
    np.testing.assert_array_equal(kb.tribvh.tri_order, np.asarray(jkb.tribvh.tri_order))
    for f in ("left", "right", "node_min", "node_max", "leaf_prim"):
        np.testing.assert_array_equal(getattr(kb.tribvh.bvh, f),
                                      np.asarray(getattr(jkb.tribvh.bvh, f)))
    for f in ("node_rows", "tri_rows", "tri_pos"):
        a = getattr(kb, f).numpy()
        b = np.asarray(getattr(jkb, f))
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    assert kb.arity == jkb.arity
    if which == "sponza":
        assert kb.use_masks and kb.use_opaque


def test_collapse_covers_every_leaf():
    tris = _random_tris(333, seed=2)
    tb = build_triangle_bvh(tris, group_size=4)
    child_node, wide_of_binary = wide.collapse_to_wide(tb)
    n_int = tb.bvh.num_internal
    leaf_ids = np.sort(child_node[child_node >= n_int] - n_int)
    np.testing.assert_array_equal(leaf_ids, np.arange(tb.bvh.num_leaves))
    internal = child_node[(child_node >= 0) & (child_node < n_int)]
    assert (wide_of_binary[internal] >= 0).all() and wide_of_binary[0] == 0
    bound = wide._stack_bound(child_node, wide_of_binary, n_int)
    assert 1 < bound <= wide.MAX_STACK


# ---- K1 / K2 plain vs tpurt interpret mode --------------------------------

def test_plain_closest_matches_interpret_kernel():
    """Every fourth ray inactive: inactive rays miss, active ones agree with
    the interpret-mode kernel and with the brute force."""
    tris = _random_tris(300, seed=3)
    jkb, kb = _pair(tris)
    o, d = _random_rays(1024, seed=4)
    active = np.arange(1024) % 4 != 0
    zeros = np.zeros(1024, np.float32)
    jt, jp, ju, jv = jw.traverse_packets(jkb, jnp.asarray(o), jnp.asarray(d),
                                         jnp.asarray(zeros), 1e9, jnp.asarray(active),
                                         interpret=True)
    t, p, u, v = wide.traverse_packets(kb, _t(o), _t(d), _t(zeros), 1e9, _t(active))
    assert (p.numpy()[~active] == -1).all()
    diff = _assert_hits_agree(t.numpy(), p.numpy(), jt, jp, tris, o, d)
    hit = (np.asarray(jp) >= 0) & ~diff
    np.testing.assert_allclose(u.numpy()[hit], np.asarray(ju)[hit], atol=1e-5)
    np.testing.assert_allclose(v.numpy()[hit], np.asarray(jv)[hit], atol=1e-5)
    np.testing.assert_allclose(_hit_t(tris, o[hit], d[hit], p.numpy()[hit]), t.numpy()[hit],
                               rtol=1e-5, atol=0)
    ref = intersect_brute_force(jnp.asarray(tris), jnp.zeros((0, 8)), jnp.asarray(o),
                                jnp.asarray(d), jnp.zeros(1024), 1e9, include_spheres=False)
    np.testing.assert_array_equal(p.numpy() >= 0, (np.asarray(ref.kind) == 1) & active)


def test_plain_closest_respects_tmin():
    tris = _random_tris(300, seed=5, spread=6.0)
    kb = wide.make_wide_kernel_bvh(build_triangle_bvh(tris, 4), tris, device="cpu")
    o, d = _random_rays(1024, seed=6)
    ones = torch.ones(1024, dtype=torch.bool)
    t, p, _, _ = wide.traverse_packets(kb, _t(o), _t(d), torch.zeros(1024), 1e9, ones)
    hit0 = p.numpy() >= 0
    assert hit0.sum() > 50
    tmin = np.where(hit0, t.numpy() * 1.0001, 0.0).astype(np.float32)
    t2, p2, _, _ = wide.traverse_packets(kb, _t(o), _t(d), _t(tmin), 1e9, ones)
    moved = hit0 & (p2.numpy() >= 0)
    assert (t2.numpy()[moved] > t.numpy()[moved]).all()
    assert (p2.numpy()[hit0] != p.numpy()[hit0]).all()


def test_plain_occlusion_matches_interpret_kernel():
    tris = _random_tris(300, seed=11)
    jkb, kb = _pair(tris)
    o, d = _random_rays(1024, seed=12)
    t_limit = (0.3 + 3.0 * np.random.RandomState(13).rand(1024)).astype(np.float32)
    zeros = np.zeros(1024, np.float32)
    jb, jt, jp, _, _ = jw.occlusion_packets(jkb, jnp.asarray(o), jnp.asarray(d),
                                            jnp.asarray(zeros), jnp.asarray(t_limit),
                                            jnp.ones(1024, bool), scene_has_alpha=False,
                                            interpret=True)
    b, t, p, _, _ = wide.occlusion_packets(kb, _t(o), _t(d), _t(zeros), _t(t_limit),
                                           torch.ones(1024, dtype=torch.bool),
                                           scene_has_alpha=False)
    np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    ref = intersect_brute_force(jnp.asarray(tris), jnp.zeros((0, 8)), jnp.asarray(o),
                                jnp.asarray(d), jnp.zeros(1024), 1e9, include_spheres=False)
    expect = (np.asarray(ref.kind) == 1) & (np.asarray(ref.t) < t_limit)
    np.testing.assert_array_equal(b.numpy(), expect)


def _masked_case():
    tris = _random_tris(64, seed=14)
    masks = np.full(64, 1 << 16, np.int32)
    masks[::3] |= 0xFFFF  # every third triangle: all cells transparent
    opaque = np.zeros(64, np.int32)
    opaque[1::3] = 0xFFFF  # the next third: all cells opaque (definite)
    o, d = _random_rays(1024, seed=15)
    return tris, masks, opaque, o, d


def test_plain_closest_cell_masks_pending():
    """With cell masks the closest traversal skips fully transparent
    triangles and marks `pending` exactly on hits of testable triangles in
    undecided cells (checked against a brute force over the visible set)."""
    tris, masks, opaque, o, d = _masked_case()
    kb = wide.make_wide_kernel_bvh(build_triangle_bvh(tris, 4), tris, tri_alpha_mask=masks,
                                   tri_alpha_opaque=opaque, device="cpu")
    t, p, _, _, pend = wide.traverse_packets(kb, _t(o), _t(d), torch.zeros(1024), 1e9,
                                             torch.ones(1024, dtype=torch.bool),
                                             cell_masks=True)
    visible = np.arange(64) % 3 != 0
    ref = intersect_brute_force(jnp.asarray(tris[visible]), jnp.zeros((0, 8)),
                                jnp.asarray(o), jnp.asarray(d), jnp.zeros(1024), 1e9,
                                include_spheres=False)
    ref_prim = np.where(np.asarray(ref.kind) == 1,
                        np.nonzero(visible)[0][np.asarray(ref.prim)], -1)
    np.testing.assert_array_equal(p.numpy() >= 0, ref_prim >= 0)
    hit = p.numpy() >= 0
    assert (p.numpy()[hit] == ref_prim[hit]).mean() > 0.99
    np.testing.assert_array_equal(pend.numpy(), hit & (p.numpy() % 3 == 2))
    # without asking for cell masks, transparent triangles are hits too
    _, p0, _, _ = wide.traverse_packets(kb, _t(o), _t(d), torch.zeros(1024), 1e9,
                                        torch.ones(1024, dtype=torch.bool))
    assert np.isin(p0.numpy(), np.arange(0, 64, 3)).any()


@pytest.mark.slow
def test_plain_closest_cell_masks_match_interpret_kernel():
    tris, masks, opaque, o, d = _masked_case()
    jkb, kb = _pair(tris, masks=masks, opaque=opaque)
    zeros = np.zeros(1024, np.float32)
    jt, jp, _, _, jpend = jw.traverse_packets(jkb, jnp.asarray(o), jnp.asarray(d),
                                              jnp.asarray(zeros), 1e9, jnp.ones(1024, bool),
                                              interpret=True, cell_masks=True)
    t, p, _, _, pend = wide.traverse_packets(kb, _t(o), _t(d), _t(zeros), 1e9,
                                             torch.ones(1024, dtype=torch.bool),
                                             cell_masks=True)
    diff = _assert_hits_agree(t.numpy(), p.numpy(), jt, jp, tris, o, d)
    np.testing.assert_array_equal(pend.numpy()[~diff], np.asarray(jpend)[~diff])


def test_dispatch_sort_keeps_per_ray_results():
    """closest_hit / occlusion_hit above the sort threshold give each ray
    the result it gets unsorted."""
    tris = _random_tris(200, seed=21)
    tb = build_triangle_bvh(tris, group_size=8)
    kb = wide.make_wide_kernel_bvh(tb, tris, device="cpu")
    o, d = _random_rays(3000, seed=22)
    o, d = _t(o), _t(d)
    z = torch.zeros(3000)
    act = torch.ones(3000, dtype=torch.bool)
    lights = torch.zeros((0, 8))
    h1 = closest_hit(kb, lights, o, d, z, 1e9, active=act, sort_rays=True)
    h2 = closest_hit(kb, lights, o, d, z, 1e9, active=act, sort_rays=False)
    for a, b in zip(h1, h2):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    lim = torch.full((3000,), 2.0)
    b1, g1 = occlusion_hit(kb, o, d, z, lim, act, False, sort_rays=True)
    b2, g2 = occlusion_hit(kb, o, d, z, lim, act, False, sort_rays=False)
    np.testing.assert_array_equal(b1.numpy(), b2.numpy())
    np.testing.assert_array_equal(g1.prim.numpy(), g2.prim.numpy())


def test_scene_from_numpy_carries_tpurt_device_scene(tmp_path):
    from tpurt.scene import procedural as jproc
    from tpurt.scene.device import build_device_scene as j_dev
    from tpurt.scene.gltf import load_gltf as j_load

    ds = j_dev(j_load(jproc.write_box_scene(str(tmp_path / "b.gltf"))))
    arrays = {f: np.asarray(getattr(ds, f)) for f in ds._fields if f != "materials"}
    arrays["materials"] = {m: np.asarray(getattr(ds.materials, m))
                           for m in ds.materials._fields}
    ts = scene_from_numpy(arrays, device="cpu")
    for f in ds._fields:
        if f != "materials":
            np.testing.assert_array_equal(getattr(ts, f).numpy(), arrays[f])
    assert ts.materials.tex_albedo.dtype == torch.int32


@pytest.mark.slow
def test_plain_occlusion_alpha_semantics():
    """Alpha-testable triangles surface as uncertain closest hits, not
    definite blocks; transparent cells are skipped (tests/test_wide_kernel.py
    counterpart)."""
    tris = _random_tris(64, seed=14)
    o, d = _random_rays(1024, seed=15)
    zeros = torch.zeros(1024)
    far = torch.full((1024,), 1e9)
    ones = torch.ones(1024, dtype=torch.bool)
    ref = intersect_brute_force(jnp.asarray(tris), jnp.zeros((0, 8)), jnp.asarray(o),
                                jnp.asarray(d), jnp.zeros(1024), 1e9, include_spheres=False)
    _, kb = _pair(tris, masks=np.full(64, 1 << 16, np.int32))
    b, t, p, _, _ = wide.occlusion_packets(kb, _t(o), _t(d), zeros, far, ones, True)
    assert not b.numpy().any()
    np.testing.assert_array_equal(p.numpy() >= 0, np.asarray(ref.kind) == 1)
    _, kb_t = _pair(tris, masks=np.full(64, (1 << 16) | 0xFFFF, np.int32))
    b2, _, p2, _, _ = wide.occlusion_packets(kb_t, _t(o), _t(d), zeros, far, ones, True)
    assert not b2.numpy().any()
    assert (p2.numpy() == -1).all()


@pytest.mark.slow
def test_plain_occlusion_opaque_cells_block():
    """Fully opaque cells of alpha-tested triangles are definite blockers."""
    tris = _random_tris(64, seed=14)
    o, d = _random_rays(1024, seed=15)
    zeros = torch.zeros(1024)
    far = torch.full((1024,), 1e9)
    ones = torch.ones(1024, dtype=torch.bool)
    masks = np.full(64, 1 << 16, np.int32)
    _, kb = _pair(tris, masks=masks, opaque=np.full(64, 0xFFFF, np.int32))
    assert kb.tri_rows.shape[1] == 4 * 12
    b, _, _, _, _ = wide.occlusion_packets(kb, _t(o), _t(d), zeros, far, ones, True)
    ref = intersect_brute_force(jnp.asarray(tris), jnp.zeros((0, 8)), jnp.asarray(o),
                                jnp.asarray(d), jnp.zeros(1024), 1e9, include_spheres=False)
    np.testing.assert_array_equal(b.numpy(), np.asarray(ref.kind) == 1)
    _, kb0 = _pair(tris, masks=masks, opaque=np.zeros(64, np.int32))
    b0, _, _, _, _ = wide.occlusion_packets(kb0, _t(o), _t(d), zeros, far, ones, True)
    assert not b0.numpy().any()


@pytest.mark.slow
def test_plain_occlusion_alpha_matches_interpret_kernel():
    """Occlusion with mixed cell masks against the interpret-mode kernel:
    both finish with the same blocked set, and an unblocked ray's
    uncertain hit is the same triangle."""
    tris = _random_tris(300, seed=31)
    r = np.random.RandomState(32)
    masks = ((r.rand(300) < 0.5).astype(np.int32) << 16) | r.randint(0, 1 << 16, 300)
    opaque = r.randint(0, 1 << 16, 300).astype(np.int32) & ~masks & 0xFFFF
    jkb, kb = _pair(tris, masks=masks.astype(np.int32), opaque=opaque)
    o, d = _random_rays(1024, seed=33)
    zeros = np.zeros(1024, np.float32)
    lim = np.full(1024, 1e9, np.float32)
    jb, jt, jp, _, _ = jw.occlusion_packets(jkb, jnp.asarray(o), jnp.asarray(d),
                                            jnp.asarray(zeros), jnp.asarray(lim),
                                            jnp.ones(1024, bool), scene_has_alpha=True,
                                            interpret=True)
    b, t, p, _, _ = wide.occlusion_packets(kb, _t(o), _t(d), _t(zeros), _t(lim),
                                           torch.ones(1024, dtype=torch.bool), True)
    free = ~np.asarray(jb) & ~b.numpy()
    _assert_hits_agree(t.numpy()[free], p.numpy()[free], np.asarray(jt)[free],
                       np.asarray(jp)[free], tris, o[free], d[free])
