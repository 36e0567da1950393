"""K3/K4's rope card tables and their walk order, on the CPU.

`rope.card_tables` copies tpurt's rope rows into the layout the CUDA
kernels read with 16-byte loads: one box per node (tpurt's rows repeat it
per octant), per-octant [first, skip] links as ints, and triangles as
[v0 mask] [e1] [e2] words. These tests hold the copy to the rows (every
number copied, the edges one f32 subtraction) and to tpurt's own packing,
and check what the host refuses. The kernels cannot run here, so the walk
they do is written out below as a per-ray Python reference over the card
tables in the kernels' loop order: node steps in an inner loop until a
leaf whose box is hit, then that leaf's G triangle tests before the next
node step. It must give `rope.traverse_plain`'s t, prim, u, v, blocked,
node visits and leaf visits bit for bit, closest and occlusion, with
every hit definite and with none, on the box, the lamp and adversarial
fixtures, the mini Sponza with alpha masks and random triangles with
random masks, at G = 1, 8 and 14 (14 leaves no room for a mask column).
Inputs are made with numpy from fixed seeds."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh import build_triangle_bvh as j_build_bvh
from tpurt.kernels.experimental import pallas_traverse as jt
from tpurt_torch.bvh.lbvh import build_triangle_bvh
from tpurt_torch.convert import kernel_bvh_from_tpurt
from tpurt_torch.kernels.experimental import rope
from tpurt_torch.scene.device import build_device_scene
from tpurt_torch.scene.gltf import load_gltf
from tpurt_torch.scene.procedural import write_box_scene, write_sponza_like_scene

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SCENES = ["box", "lamp.gltf", "adv_multi_b.gltf", "sponza", "random"]
GROUPS = [1, 8, 14]
N_RAYS = 128
F = np.float32


def _random_masked(seed=3, n=600):
    r = np.random.RandomState(seed)
    tris = ((r.rand(n, 1, 3) - 0.5) * 10 + (r.rand(n, 3, 3) - 0.5)).astype(np.float32)
    masks = ((r.rand(n) < 0.5).astype(np.int32) << 16) | r.randint(0, 1 << 16, n)
    return tris, masks.astype(np.int32)


@pytest.fixture(scope="module")
def scene_tris(tmp_path_factory):
    """scene name -> (tri_pos, tri_alpha_mask or None) as numpy arrays."""
    tmp = tmp_path_factory.mktemp("rope_card")
    out = {}
    for name in SCENES:
        if name == "random":
            out[name] = _random_masked()
            continue
        if name == "box":
            path = write_box_scene(str(tmp / "box.gltf"))
        elif name == "sponza":
            path = write_sponza_like_scene(str(tmp / "s.gltf"), columns=2, foliage=8)
        else:
            path = os.path.join(FIX, name)
        ds = build_device_scene(load_gltf(path), device="cpu")
        alpha = bool(ds.tri_alpha.any())
        out[name] = (ds.tri_pos.numpy(), ds.tri_alpha_mask.numpy() if alpha else None)
    assert out["sponza"][1] is not None
    return out


_TABLES = {}


def _tables(scene_tris, name, group):
    key = (name, group)
    if key not in _TABLES:
        tris, masks = scene_tris[name]
        _TABLES[key] = rope.make_kernel_bvh(build_triangle_bvh(tris, group), tris, masks,
                                            device="cpu")
    return _TABLES[key]


def _rays(kb, seed, occlusion):
    """Origins in the scene's box, half the rays aimed at the centroid of
    a leaf triangle that is not padding, a few axis-aligned (some -0.0 components); every
    seventh ray inactive, every fifth with t_min > 0 (a re-trace)."""
    r = np.random.RandomState(seed)
    lo = np.asarray(kb.tribvh.bvh.node_min[0], np.float64)
    hi = np.asarray(kb.tribvh.bvh.node_max[0], np.float64)
    ext = np.maximum(hi - lo, 1e-3)
    o = lo - 0.1 * ext + r.rand(N_RAYS, 3) * 1.2 * ext
    d = r.randn(N_RAYS, 3)
    g = kb.group_size
    tri = kb.tri_rows[:, :9 * g].reshape(-1, 3, 3).numpy().astype(np.float64)
    tri = tri[np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=-1) > 0]
    aim = tri[r.randint(0, tri.shape[0], N_RAYS)].mean(axis=1) - o
    half = np.arange(N_RAYS) % 2 == 0
    d[half] = aim[half]
    d[1::16] *= (r.rand(len(d[1::16]), 3) < 0.5)
    d[np.linalg.norm(d, axis=-1) == 0] = (0.0, 0.0, -1.0)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_min = np.where(np.arange(N_RAYS) % 5 == 1, r.rand(N_RAYS) * 0.5 * ext.max(), 0.0)
    if occlusion:
        t_limit = r.rand(N_RAYS) * 1.5 * np.linalg.norm(ext)
    else:
        t_limit = np.full(N_RAYS, 1e9)
    active = np.arange(N_RAYS) % 7 != 3
    return o.astype(F), d.astype(F), t_min.astype(F), t_limit.astype(F), active


def _inv(x):
    return F(1.0 if x >= 0 else -1.0) / max(abs(x), F(1e-20))


def _reference_walk(kb, o, d, t_min, t_limit, active, *, occlusion, all_definite):
    """The kernels' walk, one ray at a time in f32 numpy over the card
    tables. Returns (t, prim, u, v, blocked, node_visits, leaf_visits)."""
    boxes = kb.card.boxes.numpy().view(F)
    links = kb.card.links.numpy()
    tris = kb.card.tris.numpy()
    tf32 = tris.view(F)
    m, n_int, g = links.shape[1], kb.n_internal, kb.group_size
    masks = kb.use_masks
    n = o.shape[0]
    out_t, out_p = np.empty(n, F), np.empty(n, np.int32)
    out_u, out_v, out_b = np.empty(n, F), np.empty(n, F), np.empty(n, F)
    nv = np.zeros(n, np.int64)
    lv = np.zeros(n, np.int64)
    for i in range(n):
        ox, oy, oz = o[i]
        dx, dy, dz = d[i]
        tmin = t_min[i]
        ix, iy, iz = _inv(dx), _inv(dy), _inv(dz)
        octant = (4 if dx < 0 else 0) + (2 if dy < 0 else 0) + (1 if dz < 0 else 0)
        t_best, prim, uu, vv, blocked = t_limit[i], -1, F(0), F(0), False
        node = 0 if active[i] else m
        while node != m:
            # node steps until a leaf whose box is hit, or the end
            leaf = -1
            while node != m:
                nv[i] += 1
                b = boxes[node]
                t0x, t1x = (b[0] - ox) * ix, (b[4] - ox) * ix
                t0y, t1y = (b[1] - oy) * iy, (b[5] - oy) * iy
                t0z, t1z = (b[2] - oz) * iz, (b[6] - oz) * iz
                tn = max(max(min(t0x, t1x), min(t0y, t1y)), max(min(t0z, t1z), tmin))
                tf = min(min(max(t0x, t1x), max(t0y, t1y)), min(max(t0z, t1z), t_best))
                first, skip = links[octant, node]
                hit = tn <= tf
                if hit and node >= n_int:
                    leaf, nxt = node - n_int, skip
                    break
                node = first if hit else skip
            if leaf < 0:
                break
            # the leaf's G triangle tests, before the next node step
            lv[i] += 1
            tri, words = tf32[leaf], tris[leaf]
            v0, e1, e2 = tri[:, 0:3], tri[:, 4:7], tri[:, 8:11]
            px = dy * e2[:, 2] - dz * e2[:, 1]
            py = dz * e2[:, 0] - dx * e2[:, 2]
            pz = dx * e2[:, 1] - dy * e2[:, 0]
            det = e1[:, 0] * px + e1[:, 1] * py + e1[:, 2] * pz
            ok = np.abs(det) > F(1e-12)
            with np.errstate(divide="ignore"):
                inv_det = np.where(ok, F(1.0) / np.where(ok, det, F(1.0)), F(0.0))
            tx, ty, tz = ox - v0[:, 0], oy - v0[:, 1], oz - v0[:, 2]
            u = (tx * px + ty * py + tz * pz) * inv_det
            qx = ty * e1[:, 2] - tz * e1[:, 1]
            qy = tz * e1[:, 0] - tx * e1[:, 2]
            qz = tx * e1[:, 1] - ty * e1[:, 0]
            v = (dx * qx + dy * qy + dz * qz) * inv_det
            t = (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz) * inv_det
            for k in range(g):
                if not (ok[k] and u[k] >= 0 and v[k] >= 0 and u[k] + v[k] <= F(1.0)
                        and t[k] > tmin and t[k] < t_best):
                    continue
                if masks:
                    mk = int(words[k, 3])
                    cu = min(max(int(u[k] * F(4.0)), 0), 3)
                    cv = min(max(int(v[k] * F(4.0)), 0), 3)
                    if (mk >> (cu * 4 + cv)) & 1:
                        continue
                    if occlusion and not (mk >> 16) & 1:
                        blocked = True
                elif occlusion and all_definite:
                    blocked = True
                t_best, prim, uu, vv = t[k], leaf * g + k, u[k], v[k]
            node = nxt
            if occlusion and blocked:
                break
        out_t[i], out_p[i], out_u[i], out_v[i] = t_best, prim, uu, vv
        out_b[i] = F(1.0) if blocked else F(0.0)
    return out_t, out_p, out_u, out_v, out_b, nv, lv


# ---- the tables -------------------------------------------------------------

@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("name", SCENES)
def test_card_tables_round_trip(scene_tris, name, group):
    """Node rows rebuilt from the card tables (the one box under every
    octant's links) equal node_rows byte for byte; v0 and the masks equal
    tri_rows' lanes; e1 and e2 are the f32 differences v1 - v0 and v2 - v0,
    bit for bit; the tables are int32, contiguous and 16-byte aligned."""
    kb = _tables(scene_tris, name, group)
    card = kb.card
    m = kb.node_rows.shape[1]
    bf = card.boxes.view(torch.float32)
    rows = torch.cat([bf[None, :, 0:3].expand(8, m, 3), bf[None, :, 4:7].expand(8, m, 3),
                      card.links.to(torch.float32)], dim=-1)
    assert rows.numpy().tobytes() == kb.node_rows.numpy().tobytes()
    assert bool((card.boxes[:, 3] == 0).all() and (card.boxes[:, 7] == 0).all())

    g = kb.group_size
    v = kb.tri_rows[:, :9 * g].reshape(-1, g, 3, 3)
    tf = card.tris.view(torch.float32)
    bits = (lambda x: x.contiguous().view(torch.int32))
    assert torch.equal(bits(tf[..., 0:3]), bits(v[:, :, 0]))
    assert torch.equal(bits(tf[..., 4:7]), bits(v[:, :, 1] - v[:, :, 0]))
    assert torch.equal(bits(tf[..., 8:11]), bits(v[:, :, 2] - v[:, :, 0]))
    want_mask = (kb.tri_rows[:, 9 * g:].to(torch.int32) if kb.use_masks
                 else torch.zeros_like(card.tris[..., 3]))
    assert torch.equal(card.tris[..., 3], want_mask)
    assert bool((card.tris[..., 7] == 0).all() and (card.tris[..., 11] == 0).all())
    assert kb.use_masks == (scene_tris[name][1] is not None and g * 10 <= 128)
    for x in (card.boxes, card.links, card.tris):
        assert x.dtype == torch.int32 and x.is_contiguous() and x.data_ptr() % 16 == 0
    assert rope._check_card(kb, torch.device("cpu")) is card


@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("group", [8, 14])
def test_card_tables_from_tpurt_round_trip(group, masks):
    """Card tables built from tpurt's own rope packing (carried across with
    convert.py) give back tpurt's node and leaf rows."""
    tris, mk = _random_masked(seed=5, n=400)
    jtb = j_build_bvh(jnp.asarray(tris), group_size=group)
    jkb = jt.make_kernel_bvh(jtb, jnp.asarray(tris), jnp.asarray(mk) if masks else None)
    arrays = {k: np.asarray(getattr(jtb.bvh, k)) for k in jtb.bvh._fields}
    arrays.update(tri_order=np.asarray(jtb.tri_order), node_rows=np.asarray(jkb.node_rows),
                  tri_rows=np.asarray(jkb.tri_rows))
    kb = kernel_bvh_from_tpurt(arrays, device="cpu")
    card = kb.card
    ref = np.asarray(jkb.node_rows)
    bf = card.boxes.numpy().view(np.float32)
    for o_ in range(8):
        np.testing.assert_array_equal(bf[:, [0, 1, 2, 4, 5, 6]].view(np.int32),
                                      ref[o_, :, :6].view(np.int32))
    np.testing.assert_array_equal(card.links.numpy(), ref[..., 6:8])
    tref = np.asarray(jkb.tri_rows)
    g = group
    v = tref[:, :9 * g].reshape(-1, g, 3, 3)
    tf = card.tris.numpy().view(np.float32)
    np.testing.assert_array_equal(tf[..., 0:3].view(np.int32), v[:, :, 0].view(np.int32))
    np.testing.assert_array_equal(tf[..., 4:7].view(np.int32),
                                  (v[:, :, 1] - v[:, :, 0]).view(np.int32))
    np.testing.assert_array_equal(tf[..., 8:11].view(np.int32),
                                  (v[:, :, 2] - v[:, :, 0]).view(np.int32))
    if masks and g * 10 <= 128:
        np.testing.assert_array_equal(card.tris[..., 3].numpy(), tref[:, 9 * g:])
    else:
        assert not bool(card.tris[..., 3].any())


def test_card_tables_refuse_bad_rows(scene_tris):
    """Boxes that differ between octants, a fractional, negative or
    past-the-end link, a fractional mask or one with bits above 16, and
    leaf rows of the wrong width are refused on the host."""
    kb = _tables(scene_tris, "random", 8)
    g = kb.group_size
    m = kb.node_rows.shape[1]
    ok = rope.card_tables(kb.node_rows, kb.tri_rows, g)
    for a, b in zip((ok.boxes, ok.links, ok.tris), (kb.card.boxes, kb.card.links, kb.card.tris)):
        assert torch.equal(a, b)
    cases = [(lambda r: r[3, 5].__setitem__(0, r[3, 5, 0] + 1.0), None, "differ between octants"),
             (lambda r: r[2, 0].__setitem__(6, 1.5), None, "link"),
             (lambda r: r[2, 0].__setitem__(7, -1.0), None, "link"),
             (lambda r: r[2, 0].__setitem__(7, float(m + 1)), None, "END sentinel"),
             (None, lambda t: t[0].__setitem__(9 * g, 7.5), "mask"),
             (None, lambda t: t[0].__setitem__(9 * g, float(1 << 17)), "bits above bit 16")]
    for bad_rows, bad_tris, match in cases:
        rows, tris = kb.node_rows.clone(), kb.tri_rows.clone()
        if bad_rows:
            bad_rows(rows)
        if bad_tris:
            bad_tris(tris)
        with pytest.raises(ValueError, match=match):
            rope.card_tables(rows, tris, g)
    with pytest.raises(ValueError, match="do not hold G=8"):
        rope.card_tables(kb.node_rows, kb.tri_rows[:, :-1].contiguous(), g)


def test_wrapper_check_refuses_missing_and_misaligned_tables(scene_tris):
    """The launch check raises on absent card tables, on tables that are
    not 16-byte aligned, not contiguous, not int32 or on another device
    than the rays; it passes the tables as built."""
    kb = _tables(scene_tris, "random", 8)
    cpu = torch.device("cpu")
    card = kb.card
    assert rope._check_card(kb, cpu) is card
    with pytest.raises(ValueError, match="no card tables"):
        rope._check_card(dataclasses.replace(kb, card=None), cpu)
    flat = torch.zeros(card.tris.numel() + 1, dtype=torch.int32)
    shifted = flat[1:].view(card.tris.shape)
    shifted.copy_(card.tris)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rope._check_card(dataclasses.replace(kb, card=dataclasses.replace(card, tris=shifted)),
                         cpu)
    strided = card.links.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        rope._check_card(dataclasses.replace(kb, card=dataclasses.replace(card, links=strided)),
                         cpu)
    as_float = card.boxes.view(torch.float32)
    with pytest.raises(TypeError, match="card boxes"):
        rope._check_card(dataclasses.replace(kb, card=dataclasses.replace(card, boxes=as_float)),
                         cpu)
    with pytest.raises(ValueError, match="are on cpu"):
        rope._check_card(kb, torch.device("meta"))


def test_cpu_tensors_still_take_the_plain_walk(scene_tris):
    """traverse_packets on CPU tensors gives the plain walk's results and
    launches nothing, card tables or not."""
    kb = _tables(scene_tris, "sponza", 8)
    o, d, t_min, _, active = (torch.from_numpy(x) for x in _rays(kb, 1, False))
    before = dict(rope.LAUNCHES)
    with_card = rope.traverse_packets(kb, o, d, t_min, 1e9, active)
    without = rope.traverse_packets(dataclasses.replace(kb, card=None), o, d, t_min, 1e9,
                                    active)
    assert rope.LAUNCHES == before
    for a, b in zip(with_card, without):
        assert torch.equal(a, b)


# ---- the walk ---------------------------------------------------------------

MODES = [("closest", False), ("occlusion", True), ("occlusion", False)]


@pytest.mark.parametrize("mode,all_definite", MODES)
@pytest.mark.parametrize("group", GROUPS)
@pytest.mark.parametrize("name", SCENES)
def test_reference_walk_matches_plain(scene_tris, name, group, mode, all_definite):
    """The kernels' walk over the card tables gives traverse_plain's t,
    prim, u, v and blocked bit for bit, and its node and leaf visits."""
    kb = _tables(scene_tris, name, group)
    occlusion = mode == "occlusion"
    seed = SCENES.index(name) * 100 + group * 10 + MODES.index((mode, all_definite))
    o, d, t_min, t_limit, active = _rays(kb, seed, occlusion)
    kw = dict(occlusion=occlusion, all_definite=all_definite)
    stats = {}
    plain = rope.traverse_plain(kb.node_rows, kb.tri_rows, torch.from_numpy(o),
                                torch.from_numpy(d), torch.from_numpy(t_min),
                                torch.from_numpy(t_limit), torch.from_numpy(active),
                                n_internal=kb.n_internal, group=kb.group_size, stats=stats,
                                **kw)
    with np.errstate(over="ignore"):  # slabs of rays parallel to an axis
        *ref, nv, lv = _reference_walk(kb, o, d, t_min, t_limit, active, **kw)
    for name_, r, p in zip(("t", "prim", "u", "v", "blocked"), ref, plain):
        np.testing.assert_array_equal(r.view(np.int32), p.numpy().view(np.int32), err_msg=name_)
    np.testing.assert_array_equal(nv, stats["node_visits"].numpy())
    np.testing.assert_array_equal(lv, stats["leaf_visits"].numpy())
    prim = ref[1]
    assert occlusion or (prim >= 0).any()
    assert (prim[~active] == -1).all() and (nv[~active] == 0).all()
    if occlusion and not kb.use_masks:  # every hit blocks, or none does
        np.testing.assert_array_equal(ref[4] != 0, (prim >= 0) & all_definite)
    if occlusion and name == "random" and kb.use_masks:
        assert 0 < int((ref[4] != 0).sum()) < int((prim >= 0).sum())
