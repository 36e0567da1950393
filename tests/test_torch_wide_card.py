"""K1/K2's card tables and their walk order, on the CPU.

`wide.card_tables` copies tpurt's node and leaf rows into the layout the
CUDA kernels read with 16-byte loads; these tests hold the copy to the
rows (every number copied, the edges one f32 subtraction) and to tpurt's
own packing. The kernels cannot run here, so the walk they do is written
out below as a per-ray Python reference over the card tables: a hit-mask
stack (one entry per visited node, popped lowest set bit first) and a
while-while loop (node steps until the next entry is a leaf, then the
leaves in a row). It must give `wide.traverse_plain`'s t, prim, flag,
node visits and leaf visits bit for bit, in closest mode with and
without cell masks and in occlusion mode with and without every hit
definite; that pins down on the CPU the visit order the kernels keep.
Its deepest stack must fit the depth bound the host computes from the
collapse. Scenes: the box, the lamp and adversarial fixtures, the mini
Sponza with alpha masks, and random triangles with random masks (once
through the depth-4 fallback collapse). Inputs are made with numpy from
fixed seeds."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurt.bvh import build_triangle_bvh as j_build_bvh
from tpurt.kernels import pallas_wide as jw
from tpurt_torch.bvh.lbvh import build_triangle_bvh
from tpurt_torch.convert import wide_bvh_from_numpy
from tpurt_torch.kernels import wide
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.procedural import write_box_scene, write_sponza_like_scene

FIX = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
SCENES = ["box", "lamp.gltf", "adv_multi_b.gltf", "sponza", "random", "random_depth4"]
N_RAYS = 256
F = np.float32


def _random_masked(seed=3, n=600):
    r = np.random.RandomState(seed)
    tris = ((r.rand(n, 1, 3) - 0.5) * 10 + (r.rand(n, 3, 3) - 0.5)).astype(np.float32)
    masks = ((r.rand(n) < 0.5).astype(np.int32) << 16) | r.randint(0, 1 << 16, n)
    opaque = r.randint(0, 1 << 16, n).astype(np.int32) & ~masks & 0xFFFF
    return tris, masks.astype(np.int32), opaque


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("card")
    out = {}
    for name in SCENES:
        if name.startswith("random"):
            tris, masks, opaque = _random_masked()
            tb = build_triangle_bvh(tris, 8)
            collapse = wide._collapse_depth3(tb, 4) if name == "random_depth4" else None
            kb = wide.make_wide_kernel_bvh(tb, tris, tri_alpha_mask=masks,
                                           tri_alpha_opaque=opaque, device="cpu",
                                           collapse=collapse)
        else:
            if name == "box":
                path = write_box_scene(str(tmp / "box.gltf"))
            elif name == "sponza":
                path = write_sponza_like_scene(str(tmp / "s.gltf"), columns=2, foliage=8)
            else:
                path = os.path.join(FIX, name)
            kb = Renderer.from_gltf(path, device="cpu").bvh
        out[name] = kb
    assert out["sponza"].use_masks and out["sponza"].use_opaque
    return out


def _rays(kb, seed, occlusion):
    """Origins in the scene's box, half the rays aimed at a triangle's
    centroid, a few axis-aligned; every seventh ray inactive, every fifth
    with t_min > 0 (a re-trace)."""
    r = np.random.RandomState(seed)
    lo = np.asarray(kb.tribvh.bvh.node_min[0], np.float64)
    hi = np.asarray(kb.tribvh.bvh.node_max[0], np.float64)
    ext = np.maximum(hi - lo, 1e-3)
    o = lo - 0.1 * ext + r.rand(N_RAYS, 3) * 1.2 * ext
    d = r.randn(N_RAYS, 3)
    tri = kb.tri_pos.numpy().astype(np.float64)
    aim = tri[r.randint(0, tri.shape[0], N_RAYS)].mean(axis=1) - o
    half = np.arange(N_RAYS) % 2 == 0
    d[half] = aim[half]
    d[1::16] *= (r.rand(len(d[1::16]), 3) < 0.5)  # zero components, some -0.0
    d[np.linalg.norm(d, axis=-1) == 0] = (0.0, 0.0, -1.0)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_min = np.where(np.arange(N_RAYS) % 5 == 1, r.rand(N_RAYS) * 0.5 * ext.max(), 0.0)
    if occlusion:
        t_limit = r.rand(N_RAYS) * 1.5 * np.linalg.norm(ext)
    else:
        t_limit = np.full(N_RAYS, 1e9)
    t_limit[np.arange(N_RAYS) % 7 == 3] = -3e38
    return (o.astype(F), d.astype(F), t_min.astype(F), t_limit.astype(F))


def _inv(x):
    return F(1.0 if x >= 0 else -1.0) / max(abs(x), F(1e-20))


def _reference_walk(kb, o, d, t_min, t_limit, *, occlusion, all_definite, cell_masks):
    """The kernels' walk, one ray at a time in f32 numpy over the card
    tables. Returns (t, prim, flag, node_visits, leaf_visits, deepest
    stack)."""
    nodes = kb.card.nodes.numpy()
    leaves = kb.card.leaves.numpy()
    nf, lf = nodes.view(F), leaves.view(F)
    apply_masks = kb.use_masks and (occlusion or cell_masks)
    n = o.shape[0]
    out_t = np.empty(n, F)
    out_p = np.empty(n, np.int32)
    out_f = np.empty(n, F)
    nv = np.zeros(n, np.int64)
    lv = np.zeros(n, np.int64)
    deepest = 0
    for i in range(n):
        ox, oy, oz = o[i]
        dx, dy, dz = d[i]
        tmin = t_min[i]
        inv = np.array([_inv(dx), _inv(dy), _inv(dz)], F)
        org = np.array([ox, oy, oz], F)
        octant = (4 if dx < 0 else 0) + (2 if dy < 0 else 0) + (1 if dz < 0 else 0)
        t_best, prim, flag = t_limit[i], -1, F(0)
        stack = []  # [row, hit bits, leaf bits], each with a bit left

        def pop():
            if not stack:
                return None
            e = stack[-1]
            s = (e[1] & -e[1]).bit_length() - 1
            e[1] &= ~(1 << s)
            is_leaf = (e[2] >> s) & 1
            if e[1] == 0:
                stack.pop()
            link = int(nodes[octant, e[0], s, 3])
            return ("leaf", link) if is_leaf else ("node", link)

        c = ("node", 0)
        while c is not None:
            while c is not None and c[0] == "node":
                nv[i] += 1
                row = nf[octant, c[1]]
                t0 = (row[:, 0:3] - org) * inv
                t1 = (row[:, 4:7] - org) * inv
                mn, mx = np.minimum(t0, t1), np.maximum(t0, t1)
                tn = np.maximum(np.maximum(mn[:, 0], mn[:, 1]), np.maximum(mn[:, 2], tmin))
                tf = np.minimum(np.minimum(mx[:, 0], mx[:, 1]), np.minimum(mx[:, 2], t_best))
                kind = nodes[octant, c[1], :, 7]
                hit = (tn <= tf) & (kind > 0)
                bits = int(np.sum(hit.astype(np.int64) << np.arange(hit.size)))
                lbits = int(np.sum((hit & (kind == 2)).astype(np.int64) << np.arange(hit.size)))
                if bits:
                    stack.append([c[1], bits, lbits])
                    deepest = max(deepest, len(stack))
                c = pop()
            while c is not None and c[0] == "leaf":
                lv[i] += 1
                tri, words = lf[c[1]], leaves[c[1]]
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
                for k in range(tri.shape[0]):
                    if not (ok[k] and u[k] >= 0 and v[k] >= 0 and u[k] + v[k] <= F(1.0)
                            and t[k] > tmin and t[k] < t_best):
                        continue
                    testable = False
                    if apply_masks:
                        cu = min(max(int(min(max(u[k] * F(4.0), F(0)), F(4))), 0), 3)
                        cv = min(max(int(min(max(v[k] * F(4.0), F(0)), F(4))), 0), 3)
                        cell = cu * 4 + cv
                        if (words[k, 7] >> cell) & 1:
                            continue
                        testable = bool((words[k, 7] >> 16) & 1) and not (words[k, 11] >> cell) & 1
                    t_best, prim = t[k], int(words[k, 3])
                    if occlusion:
                        if (not testable) if kb.use_masks else all_definite:
                            flag = F(1)
                    elif apply_masks:
                        flag = F(testable)
                c = None if occlusion and flag != 0 else pop()
        out_t[i], out_p[i], out_f[i] = t_best, prim, flag
    return out_t, out_p, out_f, nv, lv, deepest


# ---- the tables -------------------------------------------------------------

@pytest.mark.parametrize("name", SCENES)
def test_card_tables_round_trip(scenes, name):
    """Node rows rebuilt from the card tables equal node_rows byte for byte;
    v0, the masks and the ids equal tri_rows' lanes; e1 and e2 are the f32
    differences v1 - v0 and v2 - v0, bit for bit; empty slots are trailing
    in every row of every octant."""
    kb = scenes[name]
    a, g = kb.arity, kb.group_size
    nodes, leaves = kb.card.nodes, kb.card.leaves
    nf = nodes.view(torch.float32)
    w = kb.node_rows.shape[1]
    rows = torch.zeros_like(kb.node_rows)
    rows[..., :6 * a] = torch.cat([nf[..., 0:3], nf[..., 4:7]], dim=-1).reshape(8, w, 6 * a)
    rows[..., 6 * a:7 * a] = nodes[..., 3].to(torch.float32)
    rows[..., 7 * a:8 * a] = nodes[..., 7].to(torch.float32)
    assert rows.numpy().tobytes() == kb.node_rows.numpy().tobytes()

    tr = kb.tri_rows
    width = tr.shape[1]
    v = tr[:, :9 * g].reshape(-1, g, 3, 3)
    lf = leaves.view(torch.float32)
    bits = (lambda x: x.contiguous().view(torch.int32))
    assert torch.equal(bits(lf[..., 0:3]), bits(v[:, :, 0]))
    assert torch.equal(bits(lf[..., 4:7]), bits(v[:, :, 1] - v[:, :, 0]))
    assert torch.equal(bits(lf[..., 8:11]), bits(v[:, :, 2] - v[:, :, 0]))
    assert torch.equal(leaves[..., 3].to(torch.float32), tr[:, width - g:])
    zero = torch.zeros_like(leaves[..., 7])
    want_alpha = tr[:, 9 * g:10 * g].to(torch.int32) if kb.use_masks else zero
    want_opaque = tr[:, 10 * g:11 * g].to(torch.int32) if kb.use_opaque else zero
    assert torch.equal(leaves[..., 7], want_alpha)
    assert torch.equal(leaves[..., 11], want_opaque)

    used = nodes[..., 7] > 0
    assert bool((used[..., :-1] | ~used[..., 1:]).all())
    assert nodes.is_contiguous() and leaves.is_contiguous()
    assert nodes.data_ptr() % 16 == 0 and leaves.data_ptr() % 16 == 0


@pytest.mark.parametrize("masks", [False, True])
def test_card_tables_from_tpurt_round_trip(masks):
    """Card tables built from tpurt's own packing (carried across with
    convert.py) give back tpurt's node and leaf rows."""
    tris, am, op = _random_masked(seed=5, n=400)
    jtb = j_build_bvh(jnp.asarray(tris), group_size=8)
    jkb = jw.make_wide_kernel_bvh(jtb, jnp.asarray(tris),
                                  tri_alpha_mask=jnp.asarray(am) if masks else None,
                                  tri_alpha_opaque=jnp.asarray(op) if masks else None)
    tb = jkb.tribvh
    arrays = {k: np.asarray(getattr(tb.bvh, k)) for k in tb.bvh._fields}
    arrays.update(tri_order=np.asarray(tb.tri_order), node_rows=np.asarray(jkb.node_rows),
                  tri_rows=np.asarray(jkb.tri_rows), tri_pos=np.asarray(jkb.tri_pos),
                  arity=jkb.arity)
    kb = wide_bvh_from_numpy(arrays, device="cpu")
    card = kb.card
    nf = card.nodes.view(torch.float32)
    a, g = kb.arity, kb.group_size
    ref = np.asarray(jkb.node_rows)
    w = ref.shape[1]
    np.testing.assert_array_equal(
        torch.cat([nf[..., 0:3], nf[..., 4:7]], dim=-1).reshape(8, w, 6 * a).numpy().view(np.int32),
        ref[..., :6 * a].view(np.int32))
    np.testing.assert_array_equal(card.nodes[..., 3].numpy(), ref[..., 6 * a:7 * a])
    np.testing.assert_array_equal(card.nodes[..., 7].numpy(), ref[..., 7 * a:8 * a])
    tref = np.asarray(jkb.tri_rows)
    v = tref[:, :9 * g].reshape(-1, g, 3, 3)
    lf = card.leaves.numpy().view(np.float32)
    np.testing.assert_array_equal(lf[..., 0:3].view(np.int32), v[:, :, 0].view(np.int32))
    np.testing.assert_array_equal(lf[..., 4:7].view(np.int32),
                                  (v[:, :, 1] - v[:, :, 0]).view(np.int32))
    np.testing.assert_array_equal(card.leaves[..., 3].numpy(), tref[:, -g:])
    if masks:
        np.testing.assert_array_equal(card.leaves[..., 7].numpy(), tref[:, 9 * g:10 * g])
        np.testing.assert_array_equal(card.leaves[..., 11].numpy(), tref[:, 10 * g:11 * g])


def test_card_tables_refuse_bad_rows(scenes):
    """An empty slot before a used one, a fractional link and a kind
    outside 0-2 are refused on the host."""
    kb = scenes["random"]
    g, a = kb.group_size, kb.arity
    ok = wide.card_tables(kb.node_rows, kb.tri_rows, g, a)
    assert torch.equal(ok.nodes, kb.card.nodes) and torch.equal(ok.leaves, kb.card.leaves)
    used = (kb.node_rows[..., 7 * a:8 * a] > 0).sum(dim=-1)
    o_, w_ = [int(x[0]) for x in torch.nonzero(used >= 2, as_tuple=True)]
    gap = kb.node_rows.clone()
    gap[o_, w_, 7 * a] = 0.0
    with pytest.raises(ValueError, match="empty slot"):
        wide.card_tables(gap, kb.tri_rows, g, a)
    frac = kb.node_rows.clone()
    frac[o_, w_, 6 * a] += 0.5
    with pytest.raises(ValueError, match="link"):
        wide.card_tables(frac, kb.tri_rows, g, a)
    bad = kb.node_rows.clone()
    bad[o_, w_, 7 * a] = 3.0
    with pytest.raises(ValueError, match="kind"):
        wide.card_tables(bad, kb.tri_rows, g, a)


def test_wrapper_check_refuses_missing_and_misaligned_tables(scenes):
    """The launch check raises on absent card tables, on tables that are
    not 16-byte aligned or not contiguous, and on a depth bound past the
    kernel's shared-memory stack; it passes the tables as built."""
    kb = scenes["random"]
    cpu = torch.device("cpu")
    assert wide._check_card(kb, cpu) is kb.card
    with pytest.raises(ValueError, match="no card tables"):
        wide._check_card(dataclasses.replace(kb, card=None), cpu)
    flat = torch.zeros(kb.card.leaves.numel() + 1, dtype=torch.int32)
    shifted = flat[1:].view(kb.card.leaves.shape)
    shifted.copy_(kb.card.leaves)
    with pytest.raises(ValueError, match="16-byte aligned"):
        wide._check_card(dataclasses.replace(kb, card=wide.CardTables(kb.card.nodes, shifted)),
                         cpu)
    strided = kb.card.nodes.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        wide._check_card(dataclasses.replace(kb, card=wide.CardTables(strided, kb.card.leaves)),
                         cpu)
    with pytest.raises(ValueError, match="depth bound"):
        wide._check_card(dataclasses.replace(kb, depth_bound=wide.MAX_DEPTH + 1), cpu)


# ---- the walk ---------------------------------------------------------------

MODES = [("closest", False, False), ("closest", True, False),
         ("occlusion", False, True), ("occlusion", False, False)]


@pytest.mark.parametrize("mode,cell_masks,all_definite", MODES)
@pytest.mark.parametrize("name", SCENES)
def test_reference_walk_matches_plain(scenes, name, mode, cell_masks, all_definite):
    """The kernels' walk over the card tables gives traverse_plain's t,
    prim, flag, node visits and leaf visits bit for bit, and its deepest
    hit-mask stack fits the depth bound."""
    kb = scenes[name]
    occlusion = mode == "occlusion"
    o, d, t_min, t_limit = _rays(kb, seed=SCENES.index(name) * 10 + MODES.index(
        (mode, cell_masks, all_definite)), occlusion=occlusion)
    kw = dict(occlusion=occlusion, all_definite=all_definite, cell_masks=cell_masks)
    stats = {}
    tp, pp, fp = wide.traverse_plain(kb.node_rows, kb.tri_rows, torch.from_numpy(o),
                                     torch.from_numpy(d), torch.from_numpy(t_min),
                                     torch.from_numpy(t_limit), group=kb.group_size,
                                     arity=kb.arity, stats=stats, **kw)
    with np.errstate(over="ignore"):  # slabs of rays parallel to an axis
        tr, pr, fr, nv, lv, deepest = _reference_walk(kb, o, d, t_min, t_limit, **kw)
    np.testing.assert_array_equal(tr.view(np.int32), tp.numpy().view(np.int32))
    np.testing.assert_array_equal(pr, pp.numpy())
    np.testing.assert_array_equal(fr.view(np.int32), fp.numpy().view(np.int32))
    np.testing.assert_array_equal(nv, stats["node_visits"].numpy())
    np.testing.assert_array_equal(lv, stats["leaf_visits"].numpy())
    assert 1 <= deepest <= kb.depth_bound <= kb.stack_bound
    assert (pr >= 0).any()
    assert (pr[np.arange(N_RAYS) % 7 == 3] == -1).all()
    if name == "random" and (occlusion or cell_masks):
        assert 0 < int((fr != 0).sum()) < (pr >= 0).sum()


def test_depth_bound_counts_levels():
    """The depth bound is the number of levels of internal wide nodes: 1
    for a lone root, and for the greedy and the fallback collapse of the
    same tree at most the per-child stack bound."""
    tris, _, _ = _random_masked(seed=9, n=3000)
    tb = build_triangle_bvh(tris, 4)
    n_int = tb.bvh.num_internal
    for child, wide_of in (wide.collapse_to_wide(tb), wide._collapse_depth3(tb, 4)):
        depth = wide._depth_bound(child, wide_of, n_int)
        level = np.full(child.shape[0], -1)
        level[0] = 0
        for _ in range(child.shape[0]):
            kids = (child >= 0) & (child < n_int)
            rows, cols = np.nonzero(kids & (level[:, None] >= 0))
            level[wide_of[child[rows, cols]]] = level[rows] + 1
        assert (level >= 0).all()
        assert depth == level.max() + 1
        assert 2 <= depth <= wide._stack_bound(child, wide_of, n_int)
    lone = np.full((1, 16), -1)
    lone[0, 0] = 0
    assert wide._depth_bound(lone, np.full(0, -1), 0) == 1
