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
2. The plain PyTorch traversal (`traverse_plain`): every ray walks its
   own stack, one entry per step, all rays at once, with the per-ray
   stacks as an (N, depth) int tensor. It has the kernel's contract and
   the kernel's arithmetic order, and it counts node and leaf visits.
3. The kernel wrappers `traverse_packets` / `occlusion_packets`. A CPU
   tensor goes to the plain traversal; a CUDA tensor goes to the
   hand-written kernel in csrc/wide_traverse.cu (K1 closest hit, K2
   occlusion), built with nvcc on first use and bound through ctypes.
   There is no fallback from one to the other.

Per-ray semantics, shared by both routes. A ray picks the node rows of
its own direction octant; tpurt's Pallas kernel picks one octant per
1024-ray packet and walks the union of the packet's nodes. The visited
set only grows under the packet, so the closest hit is the same; which
of two triangles at exactly the same `t` wins can differ (the tie rule
of ROADMAP.md). In occlusion mode a ray retires at its first definite
blocker and otherwise keeps the closest uncertain (alpha-testable) hit.
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

# launches of the CUDA kernel per mode; plain CPU traversals do not count
LAUNCHES = {"closest": 0, "occlusion": 0}


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


# ---- the plain PyTorch traversal -------------------------------------------

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
    id_base = g * (9 + int(use_masks) + int(use_opaque))
    ox, oy, oz = o[:, 0].contiguous(), o[:, 1].contiguous(), o[:, 2].contiguous()
    dx, dy, dz = d[:, 0].contiguous(), d[:, 1].contiguous(), d[:, 2].contiguous()
    octant = ((dx < 0).long() * 4 + (dy < 0).long() * 2 + (dz < 0).long())

    def inv_dir(x):
        sign = torch.where(x >= 0, torch.ones_like(x), -torch.ones_like(x))
        return sign / torch.clamp(torch.abs(x), min=1e-20)

    inv_x, inv_y, inv_z = inv_dir(dx), inv_dir(dy), inv_dir(dz)
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
    slots_rev = torch.arange(arity - 1, -1, -1, device=dev)

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
            tmin_n = t_min[ni][:, None]
            tb_n = t_best[ni][:, None]
            t0x = (box[..., 0] - ox[ni][:, None]) * inv_x[ni][:, None]
            t0y = (box[..., 1] - oy[ni][:, None]) * inv_y[ni][:, None]
            t0z = (box[..., 2] - oz[ni][:, None]) * inv_z[ni][:, None]
            t1x = (box[..., 3] - ox[ni][:, None]) * inv_x[ni][:, None]
            t1y = (box[..., 4] - oy[ni][:, None]) * inv_y[ni][:, None]
            t1z = (box[..., 5] - oz[ni][:, None]) * inv_z[ni][:, None]
            tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                               torch.maximum(torch.minimum(t0z, t1z), tmin_n))
            tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                               torch.minimum(torch.maximum(t0z, t1z), tb_n))
            links = row[:, 6 * arity:7 * arity].to(torch.int32)
            kinds = row[:, 7 * arity:8 * arity].to(torch.int32)
            box_tests[ni] += (kinds > 0).sum(dim=1)
            push = (tn <= tf) & (kinds > 0)
            child = torch.where(kinds == 2, -(links + 1), links)
            push_r = push[:, slots_rev]
            child_r = child[:, slots_rev]
            pos = sp[ni][:, None] + torch.cumsum(push_r.long(), dim=1) - 1
            if bool((pos[push_r] >= MAX_STACK).any()):
                raise RuntimeError(f"wide traversal stack overflow (capacity {MAX_STACK})")
            rows_idx = ni[:, None].expand_as(pos)
            stack[rows_idx[push_r], pos[push_r]] = child_r[push_r]
            sp[ni] += push.sum(dim=1)

        # ---- leaf steps: G triangle tests in row order ----
        li = live[~is_node]
        if li.numel():
            leaf = (-entry[~is_node] - 1).long()
            leaf_seen[leaf] = True
            leaf_visits[li] += 1
            lrow = tri_rows[leaf]
            lox, loy, loz = ox[li], oy[li], oz[li]
            ldx, ldy, ldz = dx[li], dy[li], dz[li]
            ltmin = t_min[li]
            tb = t_best[li]
            pr = prim[li]
            fl = flag[li]
            for k in range(g):
                ok, u, v, t = ray_triangle_rows(lrow[:, 9 * k:9 * k + 9], lox, loy, loz,
                                                ldx, ldy, ldz)
                hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > ltmin) & (t < tb)
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


# ---- the CUDA kernel: build, bind, launch ----------------------------------

_LIB = "wide_traverse"
_ARGTYPES = {name: cudalib.argtypes("pipipppppppiiiiiiipp")
             for name in ("tpurt_wide_closest", "tpurt_wide_occlusion")}


def traverse_cuda(kbvh: WideKernelBVH, o, d, t_min, t_limit, *, occlusion: bool,
                  all_definite: bool, cell_masks: bool):
    """Launch K1 (closest) or K2 (occlusion) on the current stream.
    Returns (t, prim, flag) as traverse_plain does. Does not wait for the
    card: a stack overflow surfaces at the next
    cudalib.check_kernel_errors."""
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
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    flag = torch.empty(n, dtype=torch.float32, device=dev)
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


def _traverse(kbvh, o, d, t_min, t_limit, *, occlusion, all_definite, cell_masks):
    """Route by device: CPU tensors to the plain version, CUDA tensors to
    the kernel, anything else raises."""
    o = o.contiguous().to(torch.float32)
    d = d.contiguous().to(torch.float32)
    t_min = t_min.contiguous().to(torch.float32)
    t_limit = t_limit.contiguous().to(torch.float32)
    if o.is_cuda:
        return traverse_cuda(kbvh, o, d, t_min, t_limit, occlusion=occlusion,
                             all_definite=all_definite, cell_masks=cell_masks)
    if o.device.type == "cpu":
        return traverse_plain(kbvh.node_rows, kbvh.tri_rows, o, d, t_min, t_limit,
                              group=kbvh.group_size, arity=kbvh.arity,
                              occlusion=occlusion, all_definite=all_definite,
                              cell_masks=cell_masks)
    raise ValueError(f"no traversal for device {o.device}")


def _t_limit(t_limit, active):
    """Activity is encoded in t_limit: an inactive ray starts at -3e38, so
    no box interval and no triangle t can pass."""
    return torch.where(active, t_limit, torch.full_like(t_limit, -_BIG))


def traverse_packets(kbvh: WideKernelBVH, o, d, t_min, t_max, active,
                     cell_masks: bool = False):
    """Closest hit (K1). Returns (t, prim, u, v), plus `pending` when
    `cell_masks` is asked for: decided-transparent cells are skipped in
    the traversal, and pending marks a committed hit on an alpha-testable
    triangle in an undecided cell. Without mask columns in the leaf rows
    pending is None and the traversal runs without cell tests."""
    want_pending = cell_masks
    if cell_masks and not kbvh.use_masks:
        cell_masks = False
    t_limit = _t_limit(torch.full((o.shape[0],), float(np.float32(t_max)),
                                  dtype=torch.float32, device=o.device), active)
    t, prim, flag = _traverse(kbvh, o, d, t_min, t_limit, occlusion=False,
                              all_definite=False, cell_masks=cell_masks)
    u, v = _uv_from_prim(kbvh, o, d, prim)
    if not want_pending:
        return t, prim, u, v
    return t, prim, u, v, (flag > 0.5) if cell_masks else None


def occlusion_packets(kbvh: WideKernelBVH, o, d, t_min, t_limit, active,
                      scene_has_alpha: bool):
    """Occlusion (K2). Returns (blocked, t, prim, u, v): `blocked` marks a
    definite blocker in (t_min, t_limit); otherwise (t, prim) is the
    closest uncertain hit for the host alpha recheck."""
    t, prim, flag = _traverse(kbvh, o, d, t_min, _t_limit(t_limit, active),
                              occlusion=True, all_definite=not scene_has_alpha,
                              cell_masks=False)
    u, v = _uv_from_prim(kbvh, o, d, prim)
    return flag > 0.0, t, prim, u, v
