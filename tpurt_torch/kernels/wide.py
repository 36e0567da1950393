"""16-ary wide-BVH tables and the closest-hit / occlusion traversal
(the counterpart of tpurt/kernels/pallas_wide.py).

Three parts:

1. Table building, host-side numpy (`collapse_to_wide`, `_stack_bound`,
   `pack_scene_for_wide_kernel`, `make_wide_kernel_bvh`): the same
   greedy collapse and the same f32 row layout as tpurt, byte for byte.
   A node row holds, per direction octant, 16 child boxes sorted near to
   far, then 16 links and 16 kinds (0 empty, 1 internal, 2 leaf). A
   leaf row holds G triangles x 9 floats, then (with alpha) the G
   transparent and G opaque 4x4 cell masks, then G global triangle ids,
   all as f32-exact integers.
2. The plain PyTorch traversals, each with its kernel's contract and
   arithmetic order: `traverse_plain` (K1/K2: every ray walks its own
   stack, one entry per step, all rays at once, with the per-ray stacks
   as an (N, depth) int tensor), `octet_plain` (K5: walks of 1024/N rays,
   each with one stack over the union of its rays' hits) and
   `stepcost_plain` (K6: K1's walk for a fixed number of steps with
   phases switched off).
3. The kernel wrappers `traverse_packets` / `occlusion_packets` (with
   `octet=N` the multi-walk kernel) and `stepcost_packets`. A CPU tensor
   goes to the plain version; a CUDA tensor goes to the hand-written
   kernel, built with nvcc on first use and bound through ctypes:
   csrc/wide_traverse.cu (K1 closest hit, K2 occlusion),
   csrc/wide_octet.cu (K5), csrc/wide_stepcost.cu (K6). There is no
   fallback from one to the other.

Per-ray semantics of K1/K2. A ray picks the node rows of its own
direction octant; tpurt's Pallas kernel picks one octant per 1024-ray
packet and walks the union of the packet's nodes. The visited set only
grows under the packet, so the closest hit is the same; which of two
triangles at exactly the same `t` wins can differ (the tie rule of
ROADMAP.md). In occlusion mode a ray retires at its first definite
blocker and otherwise keeps the closest uncertain (alpha-testable) hit.
K5 walks in tpurt's multi-walk order (`octet_plain`), so it gives K1's t
(prim but for ties) and, without mask columns, K2's blocked set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpurt_torch.bvh.lbvh import TriBVH
from tpurt_torch.kernels import cudalib
from tpurt_torch.kernels.intersect import mask_cell, ray_triangle_rows

ARITY = 16
_LANE = 128
# per-ray stack capacity of the CUDA kernel (local memory, ints)
MAX_STACK = 256
_BIG = 3.0e38

# rays per packet; a multi-walk kernel (K5) cuts it into N walks
PACKET = 1024
OCTET_WALKS = (2, 4, 8)

# launches of each CUDA kernel per mode; plain CPU traversals do not count
LAUNCHES = {"closest": 0, "occlusion": 0, "octet_closest": 0, "octet_occlusion": 0,
            "stepcost": 0}


@dataclasses.dataclass(frozen=True)
class WideKernelBVH:
    """Host TriBVH plus the packed device tables."""

    tribvh: TriBVH
    node_rows: torch.Tensor  # (8, W, 128) f32
    tri_rows: torch.Tensor   # (L, G*9 [+ G [+ G]] + G) f32
    tri_pos: torch.Tensor    # (T, 3, 3) f32, for the u/v recompute
    arity: int = ARITY
    stack_bound: int = 1     # exact worst-case stack depth of this topology

    @property
    def group_size(self) -> int:
        return self.tribvh.group_size

    @property
    def use_masks(self) -> bool:
        return self.tri_rows.shape[1] >= self.group_size * 11

    @property
    def use_opaque(self) -> bool:
        return self.tri_rows.shape[1] == self.group_size * 12

    def root_bounds(self):
        b = self.tribvh.bvh
        dev = self.node_rows.device
        return (torch.from_numpy(np.asarray(b.node_min[0], np.float32)).to(dev),
                torch.from_numpy(np.asarray(b.node_max[0], np.float32)).to(dev))


# ---- table building (host numpy) -----------------------------------------

def _binary_depths(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Depth of every internal node of the binary radix tree (root 0)."""
    n_int = left.shape[0]
    depth = np.full(n_int, -1, np.int64)
    depth[0] = 0
    frontier = np.array([0], np.int64)
    d = 0
    while frontier.size:
        children = np.concatenate([left[frontier], right[frontier]])
        children = children[children < n_int]
        d += 1
        depth[children] = d
        frontier = children
    return depth


def _collapse_depth3(tribvh: TriBVH, levels: int = 3) -> tuple:
    """Fallback collapse: wide nodes are the binary internals at
    depth % levels == 0, used when the greedy collapse's stack bound
    would exceed MAX_STACK."""
    bvh = tribvh.bvh
    left = np.asarray(bvh.left).astype(np.int64)
    right = np.asarray(bvh.right).astype(np.int64)
    n_int = bvh.num_internal
    depth = _binary_depths(left, right)
    wide_binary = np.nonzero(depth % levels == 0)[0]
    w = wide_binary.shape[0]
    wide_of_binary = np.full(n_int, -1, np.int64)
    wide_of_binary[wide_binary] = np.arange(w)
    arity = 1 << levels
    paths = np.arange(arity, dtype=np.int64)
    cur = np.repeat(wide_binary[:, None], arity, axis=1)
    stopped = np.zeros((w, arity), bool)
    valid = np.ones((w, arity), bool)
    for step in range(levels):
        bit = (paths[None, :] >> (levels - 1 - step)) & 1
        is_leaf_now = cur >= n_int
        newly = ~stopped & is_leaf_now
        valid &= ~((stopped | newly) & (bit == 1))
        stopped |= newly
        safe = np.clip(cur, 0, n_int - 1)
        nxt = np.where(bit == 0, left[safe], right[safe])
        cur = np.where(stopped, cur, nxt)
    child_node = np.where(valid, cur, -1)
    return child_node, wide_of_binary


def _stack_bound(child_node: np.ndarray, wide_of_binary: np.ndarray,
                 n_int: int) -> int:
    """Exact worst-case stack occupancy of a traversal over this wide
    topology: S(w) = k_w + max over internal children S(c), +1 for the
    root entry. Children carry higher wide ids than their parents, so one
    reverse sweep suffices. Valid for every octant's slot order."""
    w = child_node.shape[0]
    s = np.zeros(w, np.int64)
    k = (child_node >= 0).sum(axis=1)
    is_int = (child_node >= 0) & (child_node < n_int)
    for i in range(w - 1, -1, -1):
        best = 0
        for j in np.nonzero(is_int[i])[0]:
            cw = wide_of_binary[child_node[i, j]]
            if s[cw] > best:
                best = s[cw]
        s[i] = k[i] + best
    return int(s[0]) + 1 if w else 1


def collapse_to_wide(tribvh: TriBVH, arity: int = ARITY) -> tuple:
    """Collapse the binary BVH into `arity`-ary wide nodes by greedy
    frontier expansion (each wide node repeatedly expands its
    smallest-subtree internal terminal), as tpurt does. Returns
    (child_node (W, arity) terminal binary ids or -1,
     wide_of_binary (n_internal,) wide id or -1)."""
    bvh = tribvh.bvh
    left = np.asarray(bvh.left).astype(np.int64)
    right = np.asarray(bvh.right).astype(np.int64)
    n_int = bvh.num_internal
    levels = arity.bit_length() - 1
    if n_int == 0:
        child = np.full((1, arity), -1, np.int64)
        child[0, 0] = 0
        return child, np.full(0, -1, np.int64)
    depth = _binary_depths(left, right)
    size = np.ones(n_int, np.int64)
    for i in np.argsort(-depth):
        if left[i] < n_int:
            size[i] += size[left[i]]
        if right[i] < n_int:
            size[i] += size[right[i]]

    wide_of_binary = np.full(n_int, -1, np.int64)
    wide_of_binary[0] = 0
    rows = []
    queue = [0]
    qi = 0
    while qi < len(queue):
        r = queue[qi]
        qi += 1
        terms = [int(left[r]), int(right[r])]
        while len(terms) < arity:
            best, best_s = -1, None
            for j, tn in enumerate(terms):
                if tn < n_int and (best_s is None or size[tn] < best_s):
                    best, best_s = j, size[tn]
            if best < 0:
                break
            tn = terms.pop(best)
            terms.append(int(left[tn]))
            terms.append(int(right[tn]))
        for tn in terms:
            if tn < n_int:
                wide_of_binary[tn] = len(queue)
                queue.append(tn)
        rows.append(terms)

    w = len(rows)
    child_node = np.full((w, arity), -1, np.int64)
    for i, terms in enumerate(rows):
        child_node[i, :len(terms)] = terms

    if _stack_bound(child_node, wide_of_binary, n_int) > MAX_STACK:
        return _collapse_depth3(tribvh, levels)
    return child_node, wide_of_binary


def pack_scene_for_wide_kernel(tribvh: TriBVH, tri_pos: np.ndarray,
                               tri_alpha_mask=None, tri_alpha_opaque=None,
                               collapse=None, arity: int = ARITY):
    """Build (node_rows (8, W, 128), tri_rows (L, G*9[+G][+G]+G)) as f32
    numpy arrays, equal to tpurt's f32 packing."""
    bvh = tribvh.bvh
    g = tribvh.group_size
    assert g * 10 <= _LANE, f"group_size {g} does not fit a 128-lane leaf row"
    assert arity * 8 <= _LANE, f"arity {arity} node row exceeds 128 lanes"
    n_int = bvh.num_internal
    child_node, wide_of_binary = (collapse if collapse is not None
                                  else collapse_to_wide(tribvh, arity))
    assert child_node.shape[1] == arity, "collapse arity mismatch"
    w = child_node.shape[0]
    link0, kind0 = 6 * arity, 7 * arity

    node_min = np.asarray(bvh.node_min)
    node_max = np.asarray(bvh.node_max)
    safe = np.clip(child_node, 0, 2 * bvh.num_leaves - 2)
    cmin = node_min[safe]
    cmax = node_max[safe]
    empty = child_node < 0
    cmin = np.where(empty[..., None], _BIG, cmin)
    cmax = np.where(empty[..., None], -_BIG, cmax)

    is_leaf = (child_node >= n_int) & ~empty
    link = np.where(is_leaf, child_node - n_int,
                    np.where(empty, 0, wide_of_binary[np.clip(child_node, 0,
                                                              n_int - 1)]))
    assert (link >= 0).all(), "internal wide child lacks a wide id"
    kind = np.where(empty, 0, np.where(is_leaf, 2, 1))

    centers = 0.5 * (cmin + cmax)
    rows = np.zeros((8, w, _LANE), np.float32)
    for o in range(8):
        sign = np.array([1 - 2 * ((o >> 2) & 1), 1 - 2 * ((o >> 1) & 1),
                         1 - 2 * (o & 1)], np.float64)
        key = centers.astype(np.float64) @ sign
        key[empty] = np.inf
        order = np.argsort(key, axis=1, kind="stable")
        gi = np.arange(w)[:, None]
        box = np.concatenate([cmin[gi, order], cmax[gi, order]], axis=2)
        rows[o, :, 0:6 * arity] = box.reshape(w, 6 * arity)
        rows[o, :, link0:link0 + arity] = link[gi, order]
        rows[o, :, kind0:kind0 + arity] = kind[gi, order]

    tri_order = np.asarray(tribvh.tri_order)
    tri_np = np.asarray(tri_pos, np.float32)
    parts = [tri_np[tri_order].reshape(bvh.num_leaves, g * 9)]
    if tri_alpha_mask is not None and g * 11 <= _LANE:
        parts.append(np.asarray(tri_alpha_mask)[tri_order].astype(np.float32)
                     .reshape(bvh.num_leaves, g))
        if tri_alpha_opaque is not None and g * 12 <= _LANE:
            parts.append(np.asarray(tri_alpha_opaque)[tri_order]
                         .astype(np.float32).reshape(bvh.num_leaves, g))
    assert int(np.max(tri_order, initial=0)) < (1 << 24), \
        "leaf-row f32 id encoding requires < 2^24 triangles"
    parts.append(tri_order.astype(np.float32).reshape(bvh.num_leaves, g))
    return rows, np.concatenate(parts, axis=1)


def make_wide_kernel_bvh(tribvh: TriBVH, tri_pos, tri_alpha_mask=None,
                         tri_alpha_opaque=None, arity: int = ARITY,
                         device="cuda", collapse=None) -> WideKernelBVH:
    """Collapse (unless `collapse` is given), pack, and move the tables to
    `device`."""
    if collapse is None:
        collapse = collapse_to_wide(tribvh, arity)
    arity = collapse[0].shape[1]
    bound = _stack_bound(collapse[0], collapse[1], tribvh.bvh.num_internal)
    as_np = (lambda x: None if x is None else
             (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)))
    tri_np = as_np(tri_pos)
    node_rows, tri_rows = pack_scene_for_wide_kernel(
        tribvh, tri_np, as_np(tri_alpha_mask), as_np(tri_alpha_opaque),
        collapse=collapse, arity=arity)
    return WideKernelBVH(
        tribvh=tribvh,
        node_rows=torch.from_numpy(node_rows).to(device),
        tri_rows=torch.from_numpy(tri_rows).to(device),
        tri_pos=torch.from_numpy(np.ascontiguousarray(tri_np)).to(device),
        arity=arity, stack_bound=bound)


def wide_supported(tribvh: TriBVH) -> bool:
    """Whether the leaves fit the wide leaf row (G*10 <= 128: 9 vertex
    floats and an id per triangle). tpurt also checks its tables against
    an 80 MB VMEM budget; that is a limit of the TPU's on-chip memory and
    has no counterpart on the card."""
    return tribvh.group_size * 10 <= _LANE


def pick_group_size_wide(num_tris: int, vmem_budget_bytes=80 * 2 ** 20) -> int:
    """Leaf group size, chosen exactly as tpurt chooses it (G=8 unless the
    tables grow past tpurt's planning budget), so both packages build
    the same tables for the same scene."""
    for g in (8, 10, 11):
        n_leaves = max(-(-num_tris // g), 2)
        w = max(n_leaves // 4, 2)
        if (2 * w * 4 + n_leaves * 4) * _LANE < vmem_budget_bytes:
            return g
    return 12


def _uv_from_prim(kbvh: WideKernelBVH, o, d, prim):
    """Barycentrics of the committed hit, recomputed from the triangle
    with the traversal's Moller-Trumbore arithmetic."""
    tp = kbvh.tri_pos.reshape(kbvh.tri_pos.shape[0], 9)
    row = tp[torch.clamp(prim, 0, tp.shape[0] - 1).long()]
    _, u, v, _ = ray_triangle_rows(row, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])
    hit = prim >= 0
    zero = torch.zeros_like(u)
    return torch.where(hit, u, zero), torch.where(hit, v, zero)


# ---- the plain PyTorch traversals -------------------------------------------

def _octant(dx, dy, dz):
    return (dx < 0).long() * 4 + (dy < 0).long() * 2 + (dz < 0).long()


def _inv_dir(x):
    """sign(x) / max(|x|, 1e-20), as pallas_wide.py:544-547."""
    sign = torch.where(x >= 0, torch.ones_like(x), -torch.ones_like(x))
    return sign / torch.clamp(torch.abs(x), min=1e-20)


def _slab_hits(box, ox, oy, oz, inv_x, inv_y, inv_z, t_min, t_best):
    """Slab tests of child boxes (..., 6) against rays broadcast to them,
    in the kernels' expression order: tn <= tf."""
    t0x = (box[..., 0] - ox) * inv_x
    t0y = (box[..., 1] - oy) * inv_y
    t0z = (box[..., 2] - oz) * inv_z
    t1x = (box[..., 3] - ox) * inv_x
    t1y = (box[..., 4] - oy) * inv_y
    t1z = (box[..., 5] - oz) * inv_z
    tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                       torch.maximum(torch.minimum(t0z, t1z), t_min))
    tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                       torch.minimum(torch.maximum(t0z, t1z), t_best))
    return tn <= tf


def _push_far_first(stack, sp, idx, push, kinds, links, cap: bool = False):
    """Push the children of `push` (K, arity) onto the stacks `idx`,
    highest slot first, so slot 0 ends on top; a leaf goes on as
    -(link+1). Overflow raises, or with `cap` the pushes past the stack's
    size are dropped (K6)."""
    arity = push.shape[1]
    slots_rev = torch.arange(arity - 1, -1, -1, device=push.device)
    child = torch.where(kinds == 2, -(links + 1), links)
    push_r = push[:, slots_rev]
    child_r = child[:, slots_rev].to(stack.dtype)
    pos = sp[idx][:, None] + torch.cumsum(push_r.long(), dim=1) - 1
    if cap:
        push_r = push_r & (pos < MAX_STACK)
    elif bool((pos[push_r] >= MAX_STACK).any()):
        raise RuntimeError(f"wide traversal stack overflow (capacity {MAX_STACK})")
    rows_idx = idx[:, None].expand_as(pos)
    stack[rows_idx[push_r], pos[push_r]] = child_r[push_r]
    sp[idx] += push_r.sum(dim=1)


def _leaf_tests(lrow, ox, oy, oz, dx, dy, dz, t_min, tb, pr, fl, *, group: int,
                use_masks: bool, use_opaque: bool, apply_masks: bool,
                occlusion: bool, all_definite: bool):
    """The G triangle tests of leaf rows `lrow` (M, R), one per ray, in
    row order (_tri_test's), with the cell masks when `apply_masks`.
    Returns the updated (t_best, prim, flag): flag is blocked (sticky) in
    occlusion mode and pending in closest mode with cell masks."""
    g = group
    id_base = g * (9 + int(use_masks) + int(use_opaque))
    for k in range(g):
        ok, u, v, t = ray_triangle_rows(lrow[:, 9 * k:9 * k + 9], ox, oy, oz, dx, dy, dz)
        hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < tb)
        testable = None
        if apply_masks:
            m_int = lrow[:, g * 9 + k].to(torch.int32)
            cell = mask_cell(u, v)
            hit = hit & (((m_int >> cell) & 1) == 0)
            testable = ((m_int >> 16) & 1) == 1
            if use_opaque:
                o_int = lrow[:, g * 10 + k].to(torch.int32)
                testable = testable & (((o_int >> cell) & 1) == 0)
        tri_id = lrow[:, id_base + k].to(torch.int32)
        tb = torch.where(hit, t, tb)
        pr = torch.where(hit, tri_id, pr)
        if occlusion:
            if use_masks:
                definite = hit & ~testable
            elif all_definite:
                definite = hit
            else:
                definite = None
            if definite is not None:
                fl = torch.where(definite, torch.ones_like(fl), fl)
        elif apply_masks:
            fl = torch.where(hit, testable.to(torch.float32), fl)
    return tb, pr, fl


def traverse_plain(node_rows, tri_rows, o, d, t_min, t_limit, *, group: int,
                   arity: int, occlusion: bool, all_definite: bool,
                   cell_masks: bool, stats: Optional[dict] = None):
    """Walk every ray through the wide BVH at once: each step, every live
    ray pops one stack entry and either tests the 16 child boxes of a
    node (pushing the hit children far-first) or the G triangles of a
    leaf. Same contract and arithmetic order as the CUDA kernel.

    Inputs: node_rows (8, W, 128), tri_rows (L, R) f32; o, d (N, 3);
    t_min, t_limit (N,) with inactive rays at t_limit = -3e38.
    Returns (t (N,) f32, prim (N,) i32, flag (N,) f32): flag is
    `blocked` in occlusion mode and `pending` in closest mode with cell
    masks (else 0). With `stats` (a dict) it stores per-ray node and leaf
    visit counts, per-ray box tests (the non-empty child slots of the
    visited nodes: the kernel skips empty slots), and the number of
    distinct node and leaf rows read."""
    dev = o.device
    n = o.shape[0]
    g = group
    width = tri_rows.shape[1]
    use_masks = width >= g * 11
    use_opaque = width == g * 12
    apply_masks = use_masks and (occlusion or cell_masks)
    ox, oy, oz = o[:, 0].contiguous(), o[:, 1].contiguous(), o[:, 2].contiguous()
    dx, dy, dz = d[:, 0].contiguous(), d[:, 1].contiguous(), d[:, 2].contiguous()
    octant = _octant(dx, dy, dz)
    inv_x, inv_y, inv_z = _inv_dir(dx), _inv_dir(dy), _inv_dir(dz)
    t_best = t_limit.to(torch.float32).clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    flag = torch.zeros(n, dtype=torch.float32, device=dev)
    stack = torch.zeros((n, MAX_STACK), dtype=torch.int32, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)  # root entry 0 pushed
    node_visits = torch.zeros(n, dtype=torch.int64, device=dev)
    leaf_visits = torch.zeros(n, dtype=torch.int64, device=dev)
    box_tests = torch.zeros(n, dtype=torch.int64, device=dev)
    w_nodes = node_rows.shape[1]
    node_seen = torch.zeros(8 * w_nodes, dtype=torch.bool, device=dev)
    leaf_seen = torch.zeros(tri_rows.shape[0], dtype=torch.bool, device=dev)

    live = torch.arange(n, device=dev)
    while live.numel():
        sp_l = sp[live] - 1
        sp[live] = sp_l
        entry = stack[live, sp_l]
        is_node = entry >= 0

        # ---- node steps: 16 slab tests, push hits far-first ----
        ni = live[is_node]
        if ni.numel():
            e = entry[is_node].long()
            flat_row = octant[ni] * w_nodes + e
            node_seen[flat_row] = True
            node_visits[ni] += 1
            row = node_rows.reshape(-1, _LANE)[flat_row]
            box = row[:, :6 * arity].reshape(-1, arity, 6)
            col = (lambda x: x[ni][:, None])
            hit = _slab_hits(box, col(ox), col(oy), col(oz), col(inv_x), col(inv_y),
                             col(inv_z), col(t_min), col(t_best))
            links = row[:, 6 * arity:7 * arity].to(torch.int32)
            kinds = row[:, 7 * arity:8 * arity].to(torch.int32)
            box_tests[ni] += (kinds > 0).sum(dim=1)
            _push_far_first(stack, sp, ni, hit & (kinds > 0), kinds, links)

        # ---- leaf steps: G triangle tests in row order ----
        li = live[~is_node]
        if li.numel():
            leaf = (-entry[~is_node] - 1).long()
            leaf_seen[leaf] = True
            leaf_visits[li] += 1
            tb, pr, fl = _leaf_tests(
                tri_rows[leaf], ox[li], oy[li], oz[li], dx[li], dy[li], dz[li], t_min[li],
                t_best[li], prim[li], flag[li], group=g, use_masks=use_masks,
                use_opaque=use_opaque, apply_masks=apply_masks, occlusion=occlusion,
                all_definite=all_definite)
            t_best[li] = tb
            prim[li] = pr
            flag[li] = fl

        keep = sp[live] > 0
        if occlusion:
            keep = keep & (flag[live] == 0.0)
        live = live[keep]

    if stats is not None:
        stats["node_visits"] = node_visits
        stats["leaf_visits"] = leaf_visits
        stats["box_tests"] = box_tests
        stats["node_rows_read"] = int(node_seen.sum())
        stats["leaf_rows_read"] = int(leaf_seen.sum())
    return t_best, prim, flag


def octet_plain(node_rows, tri_rows, o, d, t_min, t_limit, *, group: int, arity: int,
                walks: int, occlusion: bool, all_definite: bool, cell_masks: bool,
                stats: Optional[dict] = None):
    """The multi-walk traversal (K5, tpurt's _octet_kernel order), all
    walks at once. The rays are cut into walks of PACKET // walks
    consecutive rays (the last one padded with inactive rays, as tpurt's
    _layout pads); a walk takes the octant of its first ray and one stack.
    Each step, every live walk pops one entry; on a node, every ray of the
    walk runs the slab tests of the non-empty slots against its own
    t_best, and the children that any ray hit are pushed far-first; on a
    leaf, every ray runs the G triangle tests. A walk ends when its stack
    is empty or, in occlusion mode, when none of its rays is both active
    and unblocked (checked before each step). A blocked ray keeps testing
    until its walk ends, as in tpurt.

    Same inputs and outputs as traverse_plain. `stats` holds per ray the
    node and leaf steps of its walk and the box tests it ran, and the
    distinct node and leaf rows read."""
    if walks not in OCTET_WALKS:
        raise ValueError(f"octet walks must be one of {OCTET_WALKS}, got {walks}")
    dev = o.device
    n = o.shape[0]
    rpw = PACKET // walks
    nw = max(-(-n // rpw), 1)
    pad = nw * rpw - n
    g = group
    width = tri_rows.shape[1]
    use_masks = width >= g * 11
    use_opaque = width == g * 12
    apply_masks = use_masks and (occlusion or cell_masks)

    def lay(x, fill):
        x = x.to(torch.float32)
        if pad:
            x = torch.cat([x, torch.full((pad,), fill, dtype=torch.float32, device=dev)])
        return x.reshape(nw, rpw)

    ox, oy, oz = lay(o[:, 0], 0.0), lay(o[:, 1], 0.0), lay(o[:, 2], 0.0)
    dx, dy, dz = lay(d[:, 0], 1.0), lay(d[:, 1], 1.0), lay(d[:, 2], 1.0)
    tmin = lay(t_min, 0.0)
    t_best = lay(t_limit, -_BIG).clone()
    inv_x, inv_y, inv_z = _inv_dir(dx), _inv_dir(dy), _inv_dir(dz)
    walk_oct = _octant(dx[:, 0], dy[:, 0], dz[:, 0])
    prim = torch.full((nw, rpw), -1, dtype=torch.int32, device=dev)
    flag = torch.zeros((nw, rpw), dtype=torch.float32, device=dev)
    stack = torch.zeros((nw, MAX_STACK), dtype=torch.int32, device=dev)
    sp = torch.ones(nw, dtype=torch.int64, device=dev)  # root entry 0 pushed
    node_steps = torch.zeros(nw, dtype=torch.int64, device=dev)
    leaf_steps = torch.zeros(nw, dtype=torch.int64, device=dev)
    box_tests = torch.zeros(nw, dtype=torch.int64, device=dev)
    w_nodes = node_rows.shape[1]
    node_seen = torch.zeros(8 * w_nodes, dtype=torch.bool, device=dev)
    leaf_seen = torch.zeros(tri_rows.shape[0], dtype=torch.bool, device=dev)

    live = torch.arange(nw, device=dev)
    while live.numel():
        if occlusion:
            pending = (flag[live] == 0.0) & (t_best[live] > -1e37)
            live = live[pending.any(dim=1)]
            if not live.numel():
                break
        sp_l = sp[live] - 1
        sp[live] = sp_l
        entry = stack[live, sp_l]
        is_node = entry >= 0

        wi = live[is_node]
        if wi.numel():
            flat_row = walk_oct[wi] * w_nodes + entry[is_node].long()
            node_seen[flat_row] = True
            node_steps[wi] += 1
            row = node_rows.reshape(-1, _LANE)[flat_row]
            box = row[:, :6 * arity].reshape(-1, 1, arity, 6)
            col = (lambda x: x[wi][:, :, None])
            hit = _slab_hits(box, col(ox), col(oy), col(oz), col(inv_x), col(inv_y),
                             col(inv_z), col(tmin), col(t_best)).any(dim=1)
            links = row[:, 6 * arity:7 * arity].to(torch.int32)
            kinds = row[:, 7 * arity:8 * arity].to(torch.int32)
            box_tests[wi] += (kinds > 0).sum(dim=1)
            _push_far_first(stack, sp, wi, hit & (kinds > 0), kinds, links)

        wl = live[~is_node]
        if wl.numel():
            leaf = (-entry[~is_node] - 1).long()
            leaf_seen[leaf] = True
            leaf_steps[wl] += 1
            lrow = tri_rows[leaf][:, None, :].expand(-1, rpw, -1).reshape(-1, width)
            flat = (lambda x: x[wl].reshape(-1))
            tb, pr, fl = _leaf_tests(
                lrow, flat(ox), flat(oy), flat(oz), flat(dx), flat(dy), flat(dz), flat(tmin),
                flat(t_best), flat(prim), flat(flag), group=g, use_masks=use_masks,
                use_opaque=use_opaque, apply_masks=apply_masks, occlusion=occlusion,
                all_definite=all_definite)
            t_best[wl] = tb.reshape(-1, rpw)
            prim[wl] = pr.reshape(-1, rpw)
            flag[wl] = fl.reshape(-1, rpw)

        live = live[sp[live] > 0]

    if stats is not None:
        per_ray = (lambda x: x[:, None].expand(nw, rpw).reshape(-1)[:n])
        stats["node_visits"] = per_ray(node_steps)
        stats["leaf_visits"] = per_ray(leaf_steps)
        stats["box_tests"] = per_ray(box_tests)
        stats["node_rows_read"] = int(node_seen.sum())
        stats["leaf_rows_read"] = int(leaf_seen.sum())
    return t_best.reshape(-1)[:n], prim.reshape(-1)[:n], flag.reshape(-1)[:n]


def stepcost_plain(node_rows, tri_rows, o, d, t_min, t_limit, *, group: int, arity: int,
                   steps: int, do_box: bool = True, do_extract: bool = True,
                   do_push: bool = True, do_leaf: bool = True,
                   stats: Optional[dict] = None):
    """The step-cost instrument (K6) over K1's per-ray walk: every ray pops
    exactly `steps` entries, restarting at the root when its stack is
    empty, with each phase on or off (off phases replaced by constants):
    `do_box` the slab tests (off: hit mask 0x5), `do_extract` the kind
    and link loads (off: kind 1, link 0), `do_push` the stack writes
    (pushes past the stack's size dropped), `do_leaf` the triangle tests
    (no cell masks). Returns (t (N,) f32, prim (N,) i32, acc (N,) i32):
    acc is the uint32 accumulator that keeps each live phase in the
    output (extract adds kind[0] + link[arity-1], box XORs the mask, and
    with push off the mask is added), as two's-complement int32. With
    every phase on and `steps` at least a ray's walk, t and prim equal
    traverse_plain's closest hit without cell masks. `stats` as in
    traverse_plain: the box tests and leaf tests each ray ran, and the
    distinct rows read."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    dev = o.device
    n = o.shape[0]
    g = group
    width = tri_rows.shape[1]
    ox, oy, oz = o[:, 0].contiguous(), o[:, 1].contiguous(), o[:, 2].contiguous()
    dx, dy, dz = d[:, 0].contiguous(), d[:, 1].contiguous(), d[:, 2].contiguous()
    octant = _octant(dx, dy, dz)
    inv_x, inv_y, inv_z = _inv_dir(dx), _inv_dir(dy), _inv_dir(dz)
    t_best = t_limit.to(torch.float32).clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    acc = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, MAX_STACK), dtype=torch.int32, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    w_nodes = node_rows.shape[1]
    every = torch.arange(n, device=dev)
    bit = 1 << torch.arange(arity, device=dev)
    node_visits = torch.zeros(n, dtype=torch.int64, device=dev)
    leaf_visits = torch.zeros(n, dtype=torch.int64, device=dev)
    box_tests = torch.zeros(n, dtype=torch.int64, device=dev)
    node_seen = torch.zeros(8 * w_nodes, dtype=torch.bool, device=dev)
    leaf_seen = torch.zeros(tri_rows.shape[0], dtype=torch.bool, device=dev)
    u32 = 0xFFFFFFFF
    for _ in range(steps):
        empty = sp == 0
        sp = torch.where(empty, sp, sp - 1)
        entry = torch.where(empty, torch.zeros_like(stack[:, 0]), stack[every, sp])
        is_node = entry >= 0
        ni = every[is_node]
        if ni.numel():
            flat_row = octant[ni] * w_nodes + entry[ni].long()
            node_seen[flat_row] = True
            node_visits[ni] += 1
            row = node_rows.reshape(-1, _LANE)[flat_row]
            if do_extract:
                links = row[:, 6 * arity:7 * arity].to(torch.int32)
                kinds = row[:, 7 * arity:8 * arity].to(torch.int32)
                acc[ni] = (acc[ni] + kinds[:, 0] + links[:, arity - 1]) & u32
            else:
                kinds = torch.ones((ni.numel(), arity), dtype=torch.int32, device=dev)
                links = torch.zeros_like(kinds)
            if do_box:
                box = row[:, :6 * arity].reshape(-1, arity, 6)
                col = (lambda x: x[ni][:, None])
                hit = _slab_hits(box, col(ox), col(oy), col(oz), col(inv_x), col(inv_y),
                                 col(inv_z), col(t_min), col(t_best)) & (kinds > 0)
                box_tests[ni] += (kinds > 0).sum(dim=1)
                mask = (hit.long() * bit).sum(dim=1)
                acc[ni] = acc[ni] ^ mask
            else:
                mask = torch.full((ni.numel(),), 0x5, dtype=torch.int64, device=dev)
                hit = (mask[:, None] & bit) != 0
            if do_push:
                _push_far_first(stack, sp, ni, hit & (kinds > 0), kinds, links, cap=True)
            else:
                acc[ni] = (acc[ni] + mask) & u32
        li = every[~is_node]
        if do_leaf and li.numel():
            leaf = (-entry[li] - 1).long()
            leaf_seen[leaf] = True
            leaf_visits[li] += 1
            tb, pr, _ = _leaf_tests(
                tri_rows[leaf], ox[li], oy[li], oz[li], dx[li], dy[li], dz[li], t_min[li],
                t_best[li], prim[li], torch.zeros_like(t_best[li]), group=g,
                use_masks=width >= g * 11, use_opaque=width == g * 12, apply_masks=False,
                occlusion=False, all_definite=False)
            t_best[li] = tb
            prim[li] = pr
    if stats is not None:
        stats["node_visits"] = node_visits
        stats["leaf_visits"] = leaf_visits
        stats["box_tests"] = box_tests
        stats["node_rows_read"] = int(node_seen.sum())
        stats["leaf_rows_read"] = int(leaf_seen.sum())
    acc = torch.where(acc >= 1 << 31, acc - (1 << 32), acc).to(torch.int32)
    return t_best, prim, acc


# ---- the CUDA kernel: build, bind, launch ----------------------------------

_LIB = "wide_traverse"
_ARGTYPES = {name: cudalib.argtypes("pipipppppppiiiiiiipp")
             for name in ("tpurt_wide_closest", "tpurt_wide_occlusion")}


def _check_launch(kbvh: WideKernelBVH, o, d, t_min, t_limit):
    """Raise unless the tables and rays are what the wide kernels read."""
    dev = o.device
    n = o.shape[0]
    for name, x in (("node_rows", kbvh.node_rows), ("tri_rows", kbvh.tri_rows),
                    ("t_min", t_min), ("t_limit", t_limit), ("d", d)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays are on {dev}")
    cudalib.check(o, "o", (n, 3))
    cudalib.check(d, "d", (n, 3))
    cudalib.check(t_min, "t_min", (n,))
    cudalib.check(t_limit, "t_limit", (n,))
    cudalib.check(kbvh.node_rows, "node_rows", (8, kbvh.node_rows.shape[1], _LANE))
    cudalib.check(kbvh.tri_rows, "tri_rows", tuple(kbvh.tri_rows.shape))
    if kbvh.arity * 8 > _LANE:
        raise ValueError(f"arity {kbvh.arity} does not fit a node row")
    if kbvh.stack_bound > MAX_STACK:
        raise ValueError(f"stack bound {kbvh.stack_bound} exceeds the kernel's "
                         f"{MAX_STACK}-entry stack")


def _outputs(n, dev, flag_dtype=torch.float32):
    return (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=flag_dtype, device=dev))


def traverse_cuda(kbvh: WideKernelBVH, o, d, t_min, t_limit, *, occlusion: bool,
                  all_definite: bool, cell_masks: bool):
    """Launch K1 (closest) or K2 (occlusion) on the current stream.
    Returns (t, prim, flag) as traverse_plain does. Does not wait for the
    card: a stack overflow surfaces at the next
    cudalib.check_kernel_errors."""
    dev = o.device
    n = o.shape[0]
    _check_launch(kbvh, o, d, t_min, t_limit)
    t, prim, flag = _outputs(n, dev)
    if n == 0:
        return t, prim, flag
    lib = cudalib.load(_LIB, _ARGTYPES)
    err = cudalib.error_word(dev)
    fn = lib.tpurt_wide_occlusion if occlusion else lib.tpurt_wide_closest
    apply_masks = kbvh.use_masks and (occlusion or cell_masks)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(kbvh.node_rows.data_ptr(), kbvh.node_rows.shape[1],
            kbvh.tri_rows.data_ptr(), kbvh.tri_rows.shape[1],
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_limit.data_ptr(),
            t.data_ptr(), prim.data_ptr(), flag.data_ptr(), n,
            kbvh.group_size, kbvh.arity, int(kbvh.use_masks),
            int(kbvh.use_opaque), int(apply_masks), int(all_definite),
            err.data_ptr(), stream)
    cudalib.launch_check(rc, "wide traversal")
    LAUNCHES["occlusion" if occlusion else "closest"] += 1
    return t, prim, flag


_OCTET_LIB = "wide_octet"
_OCTET_ARGTYPES = {name: cudalib.argtypes("pipipppppppiiiiiiiipp")
                   for name in ("tpurt_octet_closest", "tpurt_octet_occlusion")}


def octet_cuda(kbvh: WideKernelBVH, o, d, t_min, t_limit, *, walks: int, occlusion: bool,
               all_definite: bool, cell_masks: bool):
    """Launch K5 (csrc/wide_octet.cu) on the current stream: one block per
    walk of PACKET // walks rays. Returns (t, prim, flag) as octet_plain
    does; a stack overflow surfaces at the next
    cudalib.check_kernel_errors."""
    if walks not in OCTET_WALKS:
        raise ValueError(f"octet walks must be one of {OCTET_WALKS}, got {walks}")
    dev = o.device
    n = o.shape[0]
    _check_launch(kbvh, o, d, t_min, t_limit)
    if kbvh.tri_rows.shape[1] > _LANE:
        raise ValueError(f"leaf rows of {kbvh.tri_rows.shape[1]} floats exceed {_LANE}")
    t, prim, flag = _outputs(n, dev)
    if n == 0:
        return t, prim, flag
    lib = cudalib.load(_OCTET_LIB, _OCTET_ARGTYPES)
    err = cudalib.error_word(dev)
    fn = lib.tpurt_octet_occlusion if occlusion else lib.tpurt_octet_closest
    apply_masks = kbvh.use_masks and (occlusion or cell_masks)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(kbvh.node_rows.data_ptr(), kbvh.node_rows.shape[1],
            kbvh.tri_rows.data_ptr(), kbvh.tri_rows.shape[1],
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_limit.data_ptr(),
            t.data_ptr(), prim.data_ptr(), flag.data_ptr(), n,
            kbvh.group_size, kbvh.arity, int(kbvh.use_masks),
            int(kbvh.use_opaque), int(apply_masks), int(all_definite), walks,
            err.data_ptr(), stream)
    cudalib.launch_check(rc, "multi-walk traversal")
    LAUNCHES["octet_occlusion" if occlusion else "octet_closest"] += 1
    return t, prim, flag


def _traverse(kbvh, o, d, t_min, t_limit, *, occlusion, all_definite, cell_masks, octet=0):
    """Route by device: CPU tensors to the plain version, CUDA tensors to
    the kernel (K1/K2, or K5 with `octet` walks), anything else raises."""
    if octet and octet not in OCTET_WALKS:
        raise ValueError(f"octet must be 0 or one of {OCTET_WALKS}, got {octet}")
    o = o.contiguous().to(torch.float32)
    d = d.contiguous().to(torch.float32)
    t_min = t_min.contiguous().to(torch.float32)
    t_limit = t_limit.contiguous().to(torch.float32)
    kw = dict(occlusion=occlusion, all_definite=all_definite, cell_masks=cell_masks)
    if o.is_cuda:
        if octet:
            return octet_cuda(kbvh, o, d, t_min, t_limit, walks=octet, **kw)
        return traverse_cuda(kbvh, o, d, t_min, t_limit, **kw)
    if o.device.type == "cpu":
        plain = (lambda **k: octet_plain(walks=octet, **k)) if octet else traverse_plain
        return plain(node_rows=kbvh.node_rows, tri_rows=kbvh.tri_rows, o=o, d=d, t_min=t_min,
                     t_limit=t_limit, group=kbvh.group_size, arity=kbvh.arity, **kw)
    raise ValueError(f"no traversal for device {o.device}")


def _t_limit(t_limit, active):
    """Activity is encoded in t_limit: an inactive ray starts at -3e38, so
    no box interval and no triangle t can pass."""
    return torch.where(active, t_limit, torch.full_like(t_limit, -_BIG))


def _uv(kbvh, o, d, t, prim, need_uv):
    if need_uv:
        return _uv_from_prim(kbvh, o, d, prim)
    return torch.zeros_like(t), torch.zeros_like(t)


def traverse_packets(kbvh: WideKernelBVH, o, d, t_min, t_max, active,
                     cell_masks: bool = False, octet: int = 0, need_uv: bool = True):
    """Closest hit: K1, or with `octet` = N in (2, 4, 8) the multi-walk
    kernel K5 (pallas_wide.py:1673). Returns (t, prim, u, v), plus
    `pending` when `cell_masks` is asked for: decided-transparent cells
    are skipped in the traversal, and pending marks a committed hit on an
    alpha-testable triangle in an undecided cell. Without mask columns in
    the leaf rows pending is None and the traversal runs without cell
    tests. With need_uv=False, u and v are zeros (tpurt's flag: the u/v
    recompute is skipped)."""
    want_pending = cell_masks
    if cell_masks and not kbvh.use_masks:
        cell_masks = False
    t_limit = _t_limit(torch.full((o.shape[0],), float(np.float32(t_max)),
                                  dtype=torch.float32, device=o.device), active)
    t, prim, flag = _traverse(kbvh, o, d, t_min, t_limit, occlusion=False,
                              all_definite=False, cell_masks=cell_masks, octet=octet)
    u, v = _uv(kbvh, o, d, t, prim, need_uv)
    if not want_pending:
        return t, prim, u, v
    return t, prim, u, v, (flag > 0.5) if cell_masks else None


def occlusion_packets(kbvh: WideKernelBVH, o, d, t_min, t_limit, active,
                      scene_has_alpha: bool, octet: int = 0, need_uv: bool = True):
    """Occlusion: K2, or K5 with `octet` walks (pallas_wide.py:1735).
    Returns (blocked, t, prim, u, v): `blocked` marks a definite blocker
    in (t_min, t_limit); otherwise (t, prim) is the closest uncertain hit
    for the host alpha recheck (a blocked ray's t and prim are not
    defined). need_uv as in traverse_packets."""
    t, prim, flag = _traverse(kbvh, o, d, t_min, _t_limit(t_limit, active),
                              occlusion=True, all_definite=not scene_has_alpha,
                              cell_masks=False, octet=octet)
    u, v = _uv(kbvh, o, d, t, prim, need_uv)
    return flag > 0.0, t, prim, u, v


# ---- K6: the step-cost instrument -------------------------------------------

_STEPCOST_LIB = "wide_stepcost"
_STEPCOST_ARGTYPES = {"tpurt_stepcost": cudalib.argtypes("pipipppppppiiiiiiiiip")}
# kernel_bench's configurations, each dropping one phase more (tpurt's
# kernel_bench.py:290-297 without the TPU's collapse phase)
STEPCOST_CONFIGS = (
    ("full", {}),
    ("-leaf", dict(do_leaf=False)),
    ("-push", dict(do_leaf=False, do_push=False)),
    ("-extract", dict(do_leaf=False, do_push=False, do_extract=False)),
    ("-box", dict(do_leaf=False, do_push=False, do_extract=False, do_box=False)),
)
_STEPCOST_ALL_ON = dict(do_box=True, do_extract=True, do_push=True, do_leaf=True)


def stepcost_cuda(kbvh: WideKernelBVH, o, d, t_min, t_limit, *, steps: int,
                  do_box: bool = True, do_extract: bool = True, do_push: bool = True,
                  do_leaf: bool = True):
    """Launch K6 (csrc/wide_stepcost.cu) on the current stream. Returns
    (t, prim, acc) as stepcost_plain does. The kernel is built for the
    phase combinations of STEPCOST_CONFIGS only; any other is refused."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    toggles = dict(do_box=do_box, do_extract=do_extract, do_push=do_push, do_leaf=do_leaf)
    if not any(toggles == {**_STEPCOST_ALL_ON, **c} for _, c in STEPCOST_CONFIGS):
        raise ValueError(f"K6 is built for the STEPCOST_CONFIGS combinations only, "
                         f"not {toggles}")
    dev = o.device
    n = o.shape[0]
    _check_launch(kbvh, o, d, t_min, t_limit)
    t, prim, acc = _outputs(n, dev, torch.int32)
    if n == 0:
        return t, prim, acc
    lib = cudalib.load(_STEPCOST_LIB, _STEPCOST_ARGTYPES)
    g = kbvh.group_size
    id_base = g * (9 + int(kbvh.use_masks) + int(kbvh.use_opaque))
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.tpurt_stepcost(kbvh.node_rows.data_ptr(), kbvh.node_rows.shape[1],
                            kbvh.tri_rows.data_ptr(), kbvh.tri_rows.shape[1],
                            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_limit.data_ptr(),
                            t.data_ptr(), prim.data_ptr(), acc.data_ptr(), n, g, kbvh.arity,
                            id_base, steps, int(do_box), int(do_extract), int(do_push),
                            int(do_leaf), stream)
    cudalib.launch_check(rc, "step-cost")
    LAUNCHES["stepcost"] += 1
    return t, prim, acc


def stepcost_packets(kbvh: WideKernelBVH, o, d, t_min, t_limit, *, steps: int,
                     do_box: bool = True, do_extract: bool = True, do_push: bool = True,
                     do_leaf: bool = True):
    """The step-cost instrument (K6, pallas_wide.py:1384 stepcost_packets):
    every ray runs exactly `steps` steps of K1's walk with the phases
    switched as asked. Returns (t, prim, acc). A CPU tensor goes to
    stepcost_plain (any combination of phases), a CUDA tensor to the
    kernel (the STEPCOST_CONFIGS combinations). tpurt's `do_collapse` and
    `collapse_mode` time the TPU's cross-lane collapse of a packet's hit
    masks, which a walk with one thread per ray does not have; tpurt's
    `unroll` has no counterpart either (any `steps` >= 1 is taken)."""
    o = o.contiguous().to(torch.float32)
    d = d.contiguous().to(torch.float32)
    t_min = t_min.contiguous().to(torch.float32)
    t_limit = t_limit.contiguous().to(torch.float32)
    kw = dict(steps=steps, do_box=do_box, do_extract=do_extract, do_push=do_push,
              do_leaf=do_leaf)
    if o.is_cuda:
        return stepcost_cuda(kbvh, o, d, t_min, t_limit, **kw)
    if o.device.type == "cpu":
        return stepcost_plain(kbvh.node_rows, kbvh.tri_rows, o, d, t_min, t_limit,
                              group=kbvh.group_size, arity=kbvh.arity, **kw)
    raise ValueError(f"no step-cost walk for device {o.device}")
