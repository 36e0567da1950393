"""K5's and K6's walks over the card tables, on the CPU.

The CUDA kernels cannot run here, so the walks they do are written out
below in Python over `wide.card_tables`' 16-byte words, and held bit for
bit against the plain versions they must equal:

- K5 (csrc/wide_octet.cu): walks of 1024/N rays (N = 2, 4, 8), the last
  one ragged and padded with inactive rays; one hit-mask stack per walk,
  replicated in every warp of the walk and updated from the exchanged
  union of the warps' hit masks; node slots read four at a time up to the
  first group that ends in an empty slot; in occlusion mode one exchange
  before the first step and one after each leaf step, and the walk ends
  when none of its rays is active and unblocked. Against
  `wide.octet_plain`: t, prim and flag bit for bit, and every ray's node
  and leaf steps, in closest mode with and without cell masks and in
  occlusion mode with and without every hit definite, on tables with and
  without mask columns; the deepest stack fits `depth_bound`.
- K6 (csrc/wide_stepcost.cu): one thread per ray, K1's hit-mask stack,
  exactly `steps` visits per ray with a restart at the root whenever the
  stack is empty, each phase on or off as in the five
  `wide.STEPCOST_CONFIGS`. Against `wide.stepcost_plain` (one stack entry
  per hit child): t, prim and acc bit for bit.

Inputs are made with numpy from fixed seeds."""

import functools

import numpy as np
import pytest
import torch

from tpurt_torch.bvh.lbvh import build_triangle_bvh
from tpurt_torch.kernels import wide
from tpurt_torch.renderer import Renderer
from tpurt_torch.scene.procedural import write_sponza_like_scene

F = np.float32
SCENES = ["random", "random_nomask", "sponza"]
MODES = [("closest", False, False), ("closest", True, False),
         ("occlusion", False, True), ("occlusion", False, False)]


def _random_tris(seed, n):
    r = np.random.RandomState(seed)
    tris = ((r.rand(n, 1, 3) - 0.5) * 10 + (r.rand(n, 3, 3) - 0.5)).astype(F)
    masks = ((r.rand(n) < 0.5).astype(np.int32) << 16) | r.randint(0, 1 << 16, n)
    opaque = r.randint(0, 1 << 16, n).astype(np.int32) & ~masks & 0xFFFF
    return tris, masks.astype(np.int32), opaque


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    tris, masks, opaque = _random_tris(3, 600)
    out = {
        "random": wide.make_wide_kernel_bvh(build_triangle_bvh(tris, 8), tris,
                                            tri_alpha_mask=masks, tri_alpha_opaque=opaque,
                                            device="cpu"),
        "random_nomask": wide.make_wide_kernel_bvh(build_triangle_bvh(tris, 4), tris,
                                                   device="cpu"),
    }
    path = write_sponza_like_scene(str(tmp_path_factory.mktemp("oc") / "s.gltf"), columns=1,
                                   foliage=8, stacks=1, segments=8, rings=6)
    out["sponza"] = Renderer.from_gltf(path, device="cpu").bvh
    assert out["random"].use_opaque and out["sponza"].use_masks
    assert not out["random_nomask"].use_masks
    return out


def _rays(kb, n, seed, occlusion, coherent=128):
    """n rays in walks: the first `coherent` from one point toward one
    triangle (a coherent walk that can end blocked), the rest from the
    scene's box, half aimed at centroids, a few with zero direction
    components; every seventh ray inactive, every fifth with t_min > 0."""
    r = np.random.RandomState(seed)
    lo = np.asarray(kb.tribvh.bvh.node_min[0], np.float64)
    hi = np.asarray(kb.tribvh.bvh.node_max[0], np.float64)
    ext = np.maximum(hi - lo, 1e-3)
    o = lo - 0.1 * ext + r.rand(n, 3) * 1.2 * ext
    c = coherent
    o[:c] = lo - 0.2 * ext
    tri = kb.tri_pos.numpy().astype(np.float64)
    aim = tri[r.randint(0, tri.shape[0], n)].mean(axis=1) - o
    d = r.randn(n, 3)
    half = np.arange(n) % 2 == 0
    d[half] = aim[half]
    # the coherent rays, from points near one corner, aim at the centroid
    # nearest the scene's centre
    o[:c] += 0.01 * ext * r.rand(c, 3)
    cen = tri.mean(axis=1)
    d[:c] = cen[np.argmin(np.linalg.norm(cen - 0.5 * (lo + hi), axis=-1))] - o[:c]
    d[c + 1::16] *= (r.rand(len(d[c + 1::16]), 3) < 0.5)
    d[np.linalg.norm(d, axis=-1) == 0] = (0.0, 0.0, -1.0)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_min = np.where(np.arange(n) % 5 == 1, r.rand(n) * 0.2 * ext.max(), 0.0)
    if occlusion:
        t_limit = r.rand(n) * 1.5 * np.linalg.norm(ext)
        t_limit[:c] = 2.0 * np.linalg.norm(ext)
    else:
        t_limit = np.full(n, 1e9)
    t_limit[np.arange(n) % 7 == 3] = -3e38
    return o.astype(F), d.astype(F), t_min.astype(F), t_limit.astype(F)


def _inv(x):
    """sign(x) / max(|x|, 1e-20) per component, in f32."""
    return np.where(x >= 0, F(1), F(-1)) / np.maximum(np.abs(x), F(1e-20))


def _loaded_slots(kinds, arity):
    """The slots a kernel's slot loop reaches: groups of four, up to the
    first group that ends in an empty slot."""
    for s0 in range(0, arity, 4):
        if s0 + 4 >= arity or kinds[s0 + 3] == 0:
            return min(s0 + 4, arity)
    return arity


def _slab_bits(words, slots, org, inv, tmin, tbest):
    """Hit bits (R,) of the card child `slots` of one node row (arity, 8
    int32 words) against rays (R, 3), in the kernels' expression order."""
    wf = words.view(F)
    lo, hi = wf[slots, 0:3], wf[slots, 4:7]
    t0 = (lo[None] - org[:, None]) * inv[:, None]
    t1 = (hi[None] - org[:, None]) * inv[:, None]
    mn, mx = np.minimum(t0, t1), np.maximum(t0, t1)
    tn = np.maximum(np.maximum(mn[..., 0], mn[..., 1]), np.maximum(mn[..., 2], tmin[:, None]))
    tf = np.minimum(np.minimum(mx[..., 0], mx[..., 1]), np.minimum(mx[..., 2], tbest[:, None]))
    return np.sum((tn <= tf).astype(np.int64) << np.asarray(slots, np.int64), axis=1)


def _leaf_tests(words, org, dirs, tmin, tbest, prim, flag, *, apply_masks, use_masks,
                occlusion, all_definite):
    """The G triangle tests of one card leaf (G, 12 int32 words) for rays
    (R, 3) in row order, with the cell masks when `apply_masks`; returns
    the updated (t_best, prim, flag)."""
    wf = words.view(F)
    v0, e1, e2 = wf[:, 0:3], wf[:, 4:7], wf[:, 8:11]
    dx, dy, dz = dirs[:, 0:1], dirs[:, 1:2], dirs[:, 2:3]
    px = dy * e2[:, 2] - dz * e2[:, 1]
    py = dz * e2[:, 0] - dx * e2[:, 2]
    pz = dx * e2[:, 1] - dy * e2[:, 0]
    det = e1[:, 0] * px + e1[:, 1] * py + e1[:, 2] * pz
    ok = np.abs(det) > F(1e-12)
    with np.errstate(divide="ignore"):
        inv_det = np.where(ok, F(1.0) / np.where(ok, det, F(1.0)), F(0.0))
    tx, ty, tz = org[:, 0:1] - v0[:, 0], org[:, 1:2] - v0[:, 1], org[:, 2:3] - v0[:, 2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[:, 2] - tz * e1[:, 1]
    qy = tz * e1[:, 0] - tx * e1[:, 2]
    qz = tx * e1[:, 1] - ty * e1[:, 0]
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2[:, 0] * qx + e2[:, 1] * qy + e2[:, 2] * qz) * inv_det
    for k in range(words.shape[0]):
        hit = (ok[:, k] & (u[:, k] >= 0) & (v[:, k] >= 0) & (u[:, k] + v[:, k] <= F(1.0))
               & (t[:, k] > tmin) & (t[:, k] < tbest))
        testable = np.zeros_like(hit)
        if apply_masks:
            cu = np.clip(np.where(hit, u[:, k] * F(4.0), F(0)).astype(np.int32), 0, 3)
            cv = np.clip(np.where(hit, v[:, k] * F(4.0), F(0)).astype(np.int32), 0, 3)
            cell = cu * 4 + cv
            hit &= ((words[k, 7] >> cell) & 1) == 0
            testable = (((words[k, 7] >> 16) & 1) == 1) & (((words[k, 11] >> cell) & 1) == 0)
        tbest = np.where(hit, t[:, k], tbest)
        prim = np.where(hit, words[k, 3], prim)
        if occlusion:
            definite = hit & ~testable if use_masks else (hit if all_definite else None)
            if definite is not None:
                flag = np.where(definite, F(1), flag)
        elif apply_masks:
            flag = np.where(hit, testable.astype(F), flag)
    return tbest, prim, flag


class _Stack:
    """A hit-mask stack: entries [row, hit | leaf << 16], each with a bit
    left; a pop takes the lowest set bit."""

    def __init__(self):
        self.entries = []

    def push(self, row, bits):
        self.entries.append([row, bits])

    def pop(self):
        if not self.entries:
            return None
        e = self.entries[-1]
        s = (e[1] & -e[1]).bit_length() - 1
        leaf = bool((e[1] >> (16 + s)) & 1)
        e[1] &= ~(0x10001 << s)
        if e[1] == 0:
            self.entries.pop()
        return e[0], s, leaf


def _octet_walk(kb, o, d, t_min, t_limit, *, walks, occlusion, all_definite, cell_masks,
                warp_per_walk=False):
    """K5's walk, one walk at a time, in either launch: one block per walk
    (ray j of a walk is thread j, in warp j // 32) or one warp per walk
    (ray j in lane j % 32). Returns (t, prim, flag, node steps and leaf
    steps per ray, deepest stack, walks that ended blocked with entries
    left)."""
    nodes, leaves = kb.card.nodes.numpy(), kb.card.leaves.numpy()
    apply_masks = kb.use_masks and (occlusion or cell_masks)
    a = kb.arity
    rpw = wide.PACKET // walks
    warps = 1 if warp_per_walk else rpw // 32
    n = o.shape[0]
    n_walks = -(-n // rpw)
    out_t, out_p, out_f = np.empty(n, F), np.empty(n, np.int32), np.empty(n, F)
    node_steps, leaf_steps = np.zeros(n, np.int64), np.zeros(n, np.int64)
    deepest, blocked_exits = 0, 0
    warp_of = np.arange(rpw) // 32 if warps > 1 else np.zeros(rpw, np.int64)
    for w in range(n_walks):
        j = np.arange(w * rpw, min((w + 1) * rpw, n))
        m = j.size
        org, dirs = np.zeros((rpw, 3), F), np.ones((rpw, 3), F)
        tmin, tbest = np.zeros(rpw, F), np.full(rpw, F(-3e38))
        org[:m], dirs[:m], tmin[:m], tbest[:m] = o[j], d[j], t_min[j], t_limit[j]
        inv = _inv(dirs)
        prim, flag = np.full(rpw, -1, np.int32), np.zeros(rpw, F)
        oct_ = (4 if d[j[0], 0] < 0 else 0) + (2 if d[j[0], 1] < 0 else 0) + (
            1 if d[j[0], 2] < 0 else 0)
        stacks = [_Stack() for _ in range(warps)]  # one copy per warp

        def exchange(bits):
            """Each warp ORs its lanes, every warp ORs the warps' slots."""
            per_warp = [int(np.bitwise_or.reduce(bits[warp_of == k])) for k in range(warps)]
            return functools.reduce(lambda x, y: x | y, per_warp)

        def pending():
            return ((flag == 0) & (tbest > F(-1e37))).astype(np.int64)

        def next_entry():
            popped = [s.pop() for s in stacks]
            assert all(p == popped[0] for p in popped)  # the copies agree
            if popped[0] is None:
                return None
            row, slot, leaf = popped[0]
            return ("leaf" if leaf else "node", int(nodes[oct_, row, slot, 3]))

        steps = [0, 0]
        c = ("node", 0)
        if occlusion and not exchange(pending()):
            c = None
        while c is not None:
            if c[0] == "node":
                steps[0] += 1
                words = nodes[oct_, c[1]]
                kinds = words[:, 7]
                slots = [s for s in range(_loaded_slots(kinds, a)) if kinds[s] != 0]
                union = exchange(_slab_bits(words, slots, org, inv, tmin, tbest))
                leaf_kind = sum(1 << s for s in slots if kinds[s] == 2)
                if union:
                    assert len(stacks[0].entries) < kb.depth_bound
                    for s in stacks:
                        s.push(c[1], union | ((union & leaf_kind) << 16))
                    deepest = max(deepest, len(stacks[0].entries))
                c = next_entry()
            else:
                steps[1] += 1
                tbest, prim, flag = _leaf_tests(
                    leaves[c[1]], org, dirs, tmin, tbest, prim, flag, apply_masks=apply_masks,
                    use_masks=kb.use_masks, occlusion=occlusion, all_definite=all_definite)
                if occlusion and not exchange(pending()):
                    blocked_exits += bool(stacks[0].entries)
                    c = None
                else:
                    c = next_entry()
        out_t[j], out_p[j], out_f[j] = tbest[:m], prim[:m], flag[:m]
        node_steps[j], leaf_steps[j] = steps
    return out_t, out_p, out_f, node_steps, leaf_steps, deepest, blocked_exits


@pytest.mark.parametrize("mode,cell_masks,all_definite", MODES)
@pytest.mark.parametrize("walks,warp_per_walk", [(2, False), (4, False), (8, False),
                                                 (8, True)])
@pytest.mark.parametrize("name", SCENES)
def test_octet_walk_matches_plain(scenes, name, walks, warp_per_walk, mode, cell_masks,
                                  all_definite):
    """K5's walk over the card tables, in either launch, gives
    octet_plain's t, prim, flag, node steps and leaf steps bit for bit, on
    two full walks and a ragged third; its deepest stack fits the depth
    bound."""
    kb = scenes[name]
    occlusion = mode == "occlusion"
    rpw = wide.PACKET // walks
    n = 2 * rpw + rpw // 3 + 5
    seed = (100 * SCENES.index(name) + 10 * walks + MODES.index((mode, cell_masks, all_definite))
            + 1000 * warp_per_walk)
    o, d, t_min, t_limit = _rays(kb, n, seed, occlusion, coherent=rpw)
    kw = dict(occlusion=occlusion, all_definite=all_definite, cell_masks=cell_masks)
    stats = {}
    tp, pp, fp = wide.octet_plain(kb.node_rows, kb.tri_rows, torch.from_numpy(o),
                                  torch.from_numpy(d), torch.from_numpy(t_min),
                                  torch.from_numpy(t_limit), group=kb.group_size,
                                  arity=kb.arity, walks=walks, stats=stats, **kw)
    with np.errstate(over="ignore"):  # slabs of rays parallel to an axis
        tr, pr, fr, nv, lv, deepest, exits = _octet_walk(kb, o, d, t_min, t_limit, walks=walks,
                                                         warp_per_walk=warp_per_walk, **kw)
    np.testing.assert_array_equal(tr.view(np.int32), tp.numpy().view(np.int32))
    np.testing.assert_array_equal(pr, pp.numpy())
    np.testing.assert_array_equal(fr.view(np.int32), fp.numpy().view(np.int32))
    np.testing.assert_array_equal(nv, stats["node_visits"].numpy())
    np.testing.assert_array_equal(lv, stats["leaf_visits"].numpy())
    assert 1 <= deepest <= kb.depth_bound
    assert (pr >= 0).any()
    assert (pr[np.arange(n) % 7 == 3] == -1).all()
    if occlusion and all_definite and not kb.use_masks:
        assert exits > 0  # some walk ended blocked with entries left
    if kb.use_masks and (occlusion or cell_masks):
        assert (fr != 0).any()


def test_octet_walk_exits_before_the_first_step():
    """In occlusion mode a walk whose rays are all inactive takes no step
    (the exchange before the first step ends it), and its rays keep their
    t_limit and prim -1; in closest mode it visits the root once."""
    tris, _, _ = _random_tris(5, 200)
    kb = wide.make_wide_kernel_bvh(build_triangle_bvh(tris, 8), tris, device="cpu")
    o, d, t_min, _ = _rays(kb, 256, 11, occlusion=True)
    t_limit = np.full(256, 100.0, F)
    t_limit[128:] = -3e38  # the second walk (8 walks: 128 rays each) is all inactive
    for occlusion in (True, False):
        kw = dict(occlusion=occlusion, all_definite=True, cell_masks=False)
        stats = {}
        tp, pp, _ = wide.octet_plain(kb.node_rows, kb.tri_rows, torch.from_numpy(o),
                                     torch.from_numpy(d), torch.from_numpy(t_min),
                                     torch.from_numpy(t_limit), group=8, arity=kb.arity,
                                     walks=8, stats=stats, **kw)
        tr, pr, _, nv, lv, _, _ = _octet_walk(kb, o, d, t_min, t_limit, walks=8, **kw)
        np.testing.assert_array_equal(nv, stats["node_visits"].numpy())
        np.testing.assert_array_equal(lv, stats["leaf_visits"].numpy())
        np.testing.assert_array_equal(tr.view(np.int32), tp.numpy().view(np.int32))
        assert (nv[128:] == (0 if occlusion else 1)).all() and (lv[128:] == 0).all()
        assert (pr[128:] == -1).all() and (nv[:128] > 1).all()


def test_octet_launch_follows_the_walk_count():
    """K5 takes one warp per walk only at 8 walks and only from
    OCTET_WARP_WALKS walks up (a ragged last walk counts), one block per
    walk otherwise."""
    rpw = wide.PACKET // 8
    m = wide.OCTET_WARP_WALKS
    assert wide.octet_warp_per_walk(m * rpw, 8)
    assert wide.octet_warp_per_walk((m - 1) * rpw + 1, 8)
    assert not wide.octet_warp_per_walk((m - 1) * rpw, 8)
    assert not wide.octet_warp_per_walk(65536, 8)
    assert wide.octet_warp_per_walk(1920 * 1080, 8)
    for walks in (2, 4):
        assert not wide.octet_warp_per_walk(1920 * 1080, walks)


# ---- K6 -----------------------------------------------------------------------

def _stepcost_walk(kb, o, d, t_min, t_limit, *, steps, do_box=True, do_extract=True,
                   do_push=True, do_leaf=True):
    """K6's walk, one ray at a time. Returns (t, prim, acc as int32,
    deepest stack)."""
    nodes, leaves = kb.card.nodes.numpy(), kb.card.leaves.numpy()
    a = kb.arity
    n = o.shape[0]
    out_t, out_p, out_acc = np.empty(n, F), np.empty(n, np.int32), np.empty(n, np.int64)
    deepest = 0
    for i in range(n):
        org, dirs = o[i:i + 1], d[i:i + 1]
        tmin, tbest = t_min[i:i + 1], t_limit[i:i + 1].copy()
        inv = _inv(dirs)
        prim, flag = np.full(1, -1, np.int32), np.zeros(1, F)
        oct_ = (4 if dirs[0, 0] < 0 else 0) + (2 if dirs[0, 1] < 0 else 0) + (
            1 if dirs[0, 2] < 0 else 0)
        stack, acc = _Stack(), 0
        for _ in range(steps):
            c, leaf = 0, False  # an empty stack restarts at the root
            if do_push:
                popped = stack.pop()
                if popped is not None:
                    row, slot, leaf = popped
                    c = int(nodes[oct_, row, slot, 3])
            if not leaf:
                words = nodes[oct_, c]
                if do_extract:
                    acc = (acc + int(words[0, 7]) + int(words[a - 1, 3])) & 0xFFFFFFFF
                mask, leaf_kind = 0x5, 0
                if do_box:
                    if do_extract:
                        kinds = words[:, 7]
                        slots = [s for s in range(_loaded_slots(kinds, a)) if kinds[s] != 0]
                        leaf_kind = sum(1 << s for s in slots if kinds[s] == 2)
                    else:
                        slots = list(range(a))  # every slot an internal child
                    mask = int(_slab_bits(words, slots, org, inv, tmin, tbest)[0])
                    acc ^= mask
                if do_push:
                    if mask:
                        assert len(stack.entries) < kb.depth_bound
                        stack.push(c, mask | ((mask & leaf_kind) << 16))
                        deepest = max(deepest, len(stack.entries))
                else:
                    acc = (acc + mask) & 0xFFFFFFFF
            elif do_leaf:
                tbest, prim, flag = _leaf_tests(
                    leaves[c], org, dirs, tmin, tbest, prim, flag,
                    apply_masks=False, use_masks=False, occlusion=False, all_definite=False)
        out_t[i], out_p[i], out_acc[i] = tbest[0], prim[0], acc
    return out_t, out_p, np.where(out_acc >= 1 << 31, out_acc - (1 << 32), out_acc), deepest


@pytest.mark.parametrize("config", [name for name, _ in wide.STEPCOST_CONFIGS])
@pytest.mark.parametrize("name", ["random", "sponza"])
def test_stepcost_walk_matches_plain(scenes, name, config):
    """K6's hit-mask walk gives stepcost_plain's t, prim and acc bit for
    bit in each kernel_bench configuration, at a step count past the
    longest walk (so walks restart at the root) and at a short one."""
    kb = scenes[name]
    toggles = dict(wide.STEPCOST_CONFIGS)[config]
    o, d, t_min, t_limit = _rays(kb, 96, 7 + len(config), occlusion=False, coherent=32)
    args = [torch.from_numpy(x) for x in (o, d, t_min, t_limit)]
    stats = {}
    wide.traverse_plain(kb.node_rows, kb.tri_rows, *args, group=kb.group_size, arity=kb.arity,
                        occlusion=False, all_definite=False, cell_masks=False, stats=stats)
    longest = int((stats["node_visits"] + stats["leaf_visits"]).max())
    for steps in (longest + longest // 2, 7):
        tp, pp, ap = wide.stepcost_plain(kb.node_rows, kb.tri_rows, *args, group=kb.group_size,
                                         arity=kb.arity, steps=steps, **toggles)
        with np.errstate(over="ignore"):
            tr, pr, ar, deepest = _stepcost_walk(kb, o, d, t_min, t_limit, steps=steps,
                                                 **toggles)
        np.testing.assert_array_equal(tr.view(np.int32), tp.numpy().view(np.int32))
        np.testing.assert_array_equal(pr, pp.numpy())
        np.testing.assert_array_equal(ar, ap.numpy())
        assert deepest <= kb.depth_bound
        if toggles.get("do_push", True):
            assert deepest >= 2
    if config == "full":
        assert (pr >= 0).any()
