"""16-ary wide-BVH tables and the closest-hit / occlusion traversal
(the counterpart of tpurt/kernels/pallas_wide.py).

Three parts:

1. Table building, host-side numpy (`collapse_to_wide`, `_stack_bound`,
   `_depth_bound`, `pack_scene_for_wide_kernel`, `make_wide_kernel_bvh`):
   the same greedy collapse and the same f32 row layout as tpurt, byte
   for byte. A node row holds, per direction octant, 16 child boxes
   sorted near to far, then 16 links and 16 kinds (0 empty, 1 internal,
   2 leaf). A leaf row holds G triangles x 9 floats, then (with alpha)
   the G transparent and G opaque 4x4 cell masks, then G global triangle
   ids, all as f32-exact integers. `card_tables` copies the same numbers
   once per BVH into the layout K1/K2 read with 16-byte loads (see
   `CardTables`).
2. The plain PyTorch traversals, each with its kernel's contract and
   arithmetic order: `traverse_plain` (K1/K2: every ray walks its own
   stack, one entry per step, all rays at once, with the per-ray stacks
   as an (N, depth) int tensor), `octet_plain` (K5: walks of 1024/N rays,
   each with one stack over the union of its rays' hits) and
   `stepcost_plain` (K6: the per-ray walk with one stack entry per hit
   child, as K1 walked before its card tables, for a fixed number of
   steps with phases switched off) and `alpha_walk_plain` (K1/K2 with the
   alpha re-trace: every ray walks again past its own rejected hits, at
   most `max_skips` times, full width and with no host read; the
   integrator's host loop is its reference).
3. The kernel wrappers `traverse_packets` / `occlusion_packets` (with
   `octet=N` the multi-walk kernel), `alpha_packets` (K1/K2's Alpha
   instantiations) and `stepcost_packets`. One function, `_route`,
   casts the rays and routes them (rope.py's walks too): a CPU tensor
   goes to the plain version; a CUDA tensor goes to the hand-written
   kernel, built with nvcc on first use and bound through ctypes:
   csrc/wide_traverse.cu (K1 closest hit, K2 occlusion),
   csrc/wide_octet.cu (K5), csrc/wide_stepcost.cu (K6), all three over
   the card tables and their hit-mask stacks. There is no fallback from
   one to the other. Every launcher (`traverse_cuda`, `alpha_walk_cuda`,
   `octet_cuda`, `stepcost_cuda`, rope.traverse_cuda) goes through
   cudalib.launch, which checks, allocates, launches and counts.

Per-ray semantics of K1/K2. A ray picks the node rows of its own
direction octant; tpurt's Pallas kernel picks one octant per 1024-ray
packet and walks the union of the packet's nodes. The visited set only
grows under the packet, so the closest hit is the same; which of two
triangles at exactly the same `t` wins can differ (the tie rule of
ROADMAP.md). In occlusion mode a ray retires at its first definite
blocker and otherwise keeps the closest uncertain (alpha-testable) hit.
K1/K2 keep one hit-mask entry per visited node where the plain version
pushes one entry per hit child; popping the lowest set bit visits the
children in the same order, so the two agree bit for bit, prim and flag
included. K5 and K6 keep the same entries (K5 one stack per walk, with
the union of its rays' hit masks). K5 walks in tpurt's multi-walk order
(`octet_plain`), so it gives K1's t (prim but for ties) and, without
mask columns, K2's blocked set.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import TYPE_CHECKING, NamedTuple, Optional, Union

import numpy as np
import torch

from tpurt_torch.bvh.lbvh import TriBVH
from tpurt_torch.kernels import cudalib
from tpurt_torch.kernels.intersect import (
    KIND_MISS,
    KIND_SPHERE,
    KIND_TRIANGLE,
    intersect_spheres,
    mask_cell,
    ray_triangle_rows,
)
from tpurt_torch.kernels.texture import sample_texture_alpha_quad
from tpurt_torch.scene.types import NO_TEXTURE
from tpurt_torch.utils.profiling import host_sync

if TYPE_CHECKING:
    from tpurt_torch.scene.device import DeviceScene

ARITY = 16
_LANE = 128
# per-ray (per-walk) stack capacity (ints) of the per-child-push walks:
# the plain versions only
MAX_STACK = 256
# K1/K2 and K6 keep their hit-mask entries (8 bytes each) in the dynamic
# shared memory of a 128-thread block, at most 227 KB (K5 keeps one stack
# per warp: at most 16 x MAX_DEPTH entries, 29 KB)
MAX_DEPTH = 232448 // (128 * 8)
_BIG = 3.0e38

# rays per packet; a multi-walk kernel (K5) cuts it into N walks
PACKET = 1024
OCTET_WALKS = (2, 4, 8)

# launches of each CUDA kernel per mode; plain CPU traversals do not count.
# "closest" and "occlusion" count every K1 and K2 launch, "closest_alpha"
# and "occlusion_alpha" those of them with the alpha re-trace
LAUNCHES = {"closest": 0, "occlusion": 0, "closest_alpha": 0, "occlusion_alpha": 0,
            "octet_closest": 0, "octet_occlusion": 0, "stepcost": 0}


@dataclasses.dataclass(frozen=True)
class CardTables:
    """tpurt's node and leaf rows, the same numbers laid out for the
    16-byte loads of K1/K2, K5 and K6 (int32 words; floats as their
    bits):

    nodes  (8, W, arity, 8): child s of a row is [lo.x lo.y lo.z link]
           [hi.x hi.y hi.z kind], in the row's near-to-far slot order,
           empty slots (kind 0) last;
    leaves (L, G, 12): triangle k is [v0.xyz id] [e1.xyz alpha mask]
           [e2.xyz opaque mask], e1 = v1 - v0 and e2 = v2 - v0 in f32, a
           mask 0 where the leaf rows have no such column."""

    nodes: torch.Tensor
    leaves: torch.Tensor


@dataclasses.dataclass(frozen=True)
class WideKernelBVH:
    """Host TriBVH plus the packed device tables."""

    tribvh: TriBVH
    node_rows: torch.Tensor  # (8, W, 128) f32
    tri_rows: torch.Tensor   # (L, G*9 [+ G [+ G]] + G) f32
    tri_pos: torch.Tensor    # (T, 3, 3) f32, for the u/v recompute
    arity: int = ARITY
    stack_bound: int = 1     # exact worst-case stack depth of this topology
    depth_bound: int = 1     # hit-mask entries a K1/K2, K5 or K6 walk holds at most
    card: Optional[CardTables] = None  # the kernels' copy of the tables

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
        """The root box (lo, hi) on the tables' device: two copies from the
        host, each of which waits for the stream there."""
        b = self.tribvh.bvh
        dev = self.node_rows.device
        out = []
        for x in (b.node_min[0], b.node_max[0]):
            x = torch.from_numpy(np.asarray(x, np.float32))
            with host_sync("root_bounds"):
                out.append(x.to(dev))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class AlphaTest:
    """What the alpha re-trace of K1/K2 reads: DeviceScene's alpha tables,
    its lights (K1's sphere test) and `max_skips`, the re-traces a ray may
    take. `counters`, when given, is an int32 (2,) tensor of zeros that
    the launch fills with [the most re-traces a ray took, 1 if a ray ended
    at the cap still rejected]."""

    tri_alpha: torch.Tensor      # (T,) bool
    tri_alpha_row: torch.Tensor  # (T, 11) f32
    tex_table: torch.Tensor      # (NT, 10) i32
    atlas_quad: torch.Tensor     # (QH, QW, 16) uint8
    lights: torch.Tensor         # (L, 8) f32
    max_skips: int
    counters: Optional[torch.Tensor] = None


class AlphaWalk(NamedTuple):
    """K1/K2 with the alpha re-trace, ray by ray. `flag` is K1's pending
    (cell masks) or K2's blocked; `counters` as AlphaTest's, or None where
    none was given."""

    t: torch.Tensor      # (N,) f32: K1 t_max on a miss
    prim: torch.Tensor   # (N,) i32: triangle id, K1 a light id on a sphere hit
    u: torch.Tensor      # (N,) f32: the last walk's triangle (0 without one)
    v: torch.Tensor      # (N,) f32
    kind: torch.Tensor   # (N,) i32: KIND_* of kernels/intersect.py
    flag: torch.Tensor   # (N,) f32
    counters: Optional[torch.Tensor]


def retrace_tmin(t):
    """t_min just past a rejected hit: t * (1 + 1e-6) + 1e-5."""
    return t * float(np.float32(1.0 + 1e-6)) + float(np.float32(1e-5))


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


def _depth_bound(child_node: np.ndarray, wide_of_binary: np.ndarray, n_int: int) -> int:
    """Most entries a hit-mask stack holds in a walk over this wide
    topology: one per internal wide node on the path from the root, so
    the number of levels of internal wide nodes (the deepest one's depth
    plus one). A breadth-first sweep from the root, so it holds for any
    numbering of the wide nodes (the greedy collapse's and the
    _collapse_depth3 fallback's) and for every octant's slot order."""
    levels, frontier = 0, np.zeros(1 if child_node.shape[0] else 0, np.int64)
    while frontier.size:
        levels += 1
        kids = child_node[frontier].reshape(-1)
        frontier = wide_of_binary[kids[(kids >= 0) & (kids < n_int)]]
    return max(levels, 1)


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


def _exact_ints(x: torch.Tensor, name: str) -> torch.Tensor:
    """The int32 values of f32-exact non-negative integers below 2^24;
    raises on any other value."""
    if bool(((x < 0) | (x >= 1 << 24)).any()):
        raise ValueError(f"{name}: values outside [0, 2^24)")
    xi = x.to(torch.int32)
    if not torch.equal(xi.to(x.dtype), x):
        raise ValueError(f"{name}: values that are not integers")
    return xi


def card_tables(node_rows: torch.Tensor, tri_rows: torch.Tensor, group: int,
                arity: int = ARITY) -> CardTables:
    """The kernels' copy of tpurt's tables (see CardTables), built on their
    device. Every float is copied, or is one f32 subtraction (the edges);
    links, kinds, masks and ids are converted to int32 once, here. Raises
    unless the links, kinds, masks and ids are exact integers below 2^24,
    the kinds are 0, 1 or 2, and every row's empty slots come last (K1/K2
    stop at the first group of slots that ends in one)."""
    dev = node_rows.device
    w = node_rows.shape[1]
    box = node_rows[..., :6 * arity].reshape(8, w, arity, 6).contiguous().view(torch.int32)
    link = _exact_ints(node_rows[..., 6 * arity:7 * arity], "link")
    kind = _exact_ints(node_rows[..., 7 * arity:8 * arity], "kind")
    if bool((kind > 2).any()):
        raise ValueError("kind: values other than 0, 1 and 2")
    if bool(((kind[..., 1:] > 0) & (kind[..., :-1] == 0)).any()):
        raise ValueError("a node row has an empty slot before a used one")
    nodes = torch.cat([box[..., 0:3], link[..., None], box[..., 3:6], kind[..., None]], dim=-1)

    g = group
    n_leaf, width = tri_rows.shape
    v = tri_rows[:, :9 * g].reshape(n_leaf, g, 3, 3)
    v0 = v[:, :, 0]
    bits = (lambda x: x.contiguous().view(torch.int32))
    none = torch.zeros((n_leaf, g, 1), dtype=torch.int32, device=dev)
    alpha = (_exact_ints(tri_rows[:, 9 * g:10 * g], "alpha mask")[..., None]
             if width >= 11 * g else none)
    opaque = (_exact_ints(tri_rows[:, 10 * g:11 * g], "opaque mask")[..., None]
              if width == 12 * g else none)
    ids = _exact_ints(tri_rows[:, width - g:], "triangle id")[..., None]
    leaves = torch.cat([bits(v0), ids, bits(v[:, :, 1] - v0), alpha,
                        bits(v[:, :, 2] - v0), opaque], dim=-1)
    return CardTables(nodes=nodes.contiguous(), leaves=leaves.contiguous())


def make_wide_kernel_bvh(tribvh: TriBVH, tri_pos, tri_alpha_mask=None,
                         tri_alpha_opaque=None, arity: int = ARITY,
                         device="cuda", collapse=None) -> WideKernelBVH:
    """Collapse (unless `collapse` is given), pack, move the tables to
    `device` and build the kernels' card tables there."""
    if collapse is None:
        collapse = collapse_to_wide(tribvh, arity)
    arity = collapse[0].shape[1]
    n_int = tribvh.bvh.num_internal
    as_np = (lambda x: None if x is None else
             (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)))
    tri_np = as_np(tri_pos)
    node_rows, tri_rows = pack_scene_for_wide_kernel(
        tribvh, tri_np, as_np(tri_alpha_mask), as_np(tri_alpha_opaque),
        collapse=collapse, arity=arity)
    node_rows = torch.from_numpy(node_rows).to(device)
    tri_rows = torch.from_numpy(tri_rows).to(device)
    return WideKernelBVH(
        tribvh=tribvh, node_rows=node_rows, tri_rows=tri_rows,
        tri_pos=torch.from_numpy(np.ascontiguousarray(tri_np)).to(device),
        arity=arity, stack_bound=_stack_bound(collapse[0], collapse[1], n_int),
        depth_bound=_depth_bound(collapse[0], collapse[1], n_int),
        card=card_tables(node_rows, tri_rows, tribvh.group_size, arity))


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


def alpha_rejected_plain(alpha: Union[AlphaTest, DeviceScene], prim, u, v, tested):
    """The exact any-hit alpha test on every ray at once, the one rule in
    Python (the Alpha kernels hold to it; the integrator's host loop,
    wavefront._alpha_rejected, calls it on its tested lanes): True where
    a tested hit is rejected, by its decided cell of the fused alpha row
    or else by the NEAREST tap below the cutoff (NO_TEXTURE reads as
    opaque). Reads only `alpha`'s tri_alpha_row, tex_table and
    atlas_quad, which an AlphaTest and a DeviceScene both have."""
    row = alpha.tri_alpha_row[torch.clamp(prim, 0, alpha.tri_alpha_row.shape[0] - 1).long()]
    cell = mask_cell(u, v)
    tbit = (row[:, 9].to(torch.int32) >> cell) & 1
    obit = (row[:, 10].to(torch.int32) >> cell) & 1
    w0 = 1.0 - u - v
    uv_u = w0 * row[:, 3] + u * row[:, 5] + v * row[:, 7]
    uv_v = w0 * row[:, 4] + u * row[:, 6] + v * row[:, 8]
    tex = row[:, 2].to(torch.int32)
    a = sample_texture_alpha_quad(alpha.atlas_quad, alpha.tex_table, tex, uv_u, uv_v)
    a = torch.where(tex == NO_TEXTURE, torch.ones_like(a), a)
    return tested & ((tbit == 1) | ((obit == 0) & (a < row[:, 1])))


def alpha_walk_plain(kbvh: WideKernelBVH, o, d, t_min, t_limit, active, alpha: AlphaTest, *,
                     occlusion: bool, cell_masks: bool = False, spheres: bool = False,
                     t_max: float = 0.0) -> AlphaWalk:
    """The alpha re-trace of K1/K2's Alpha instantiations in plain PyTorch,
    full width and masked: every ray still walking takes traverse_plain's
    walk together, the rest are inactive in it, and the loop runs
    alpha.max_skips + 1 walks with no host read. Its reference is the
    integrator's host loop (wavefront._trace, wavefront._shadow_blocked),
    which it equals ray by ray: a rejected hit is walked past from
    t * (1 + 1e-6) + 1e-5 at most max_skips times, after which it stands
    (K1) or blocks (K2); K1 applies closest_hit's miss and sphere lights
    (`spheres`, at each walk's t_min) after every walk. t_limit holds
    inactive rays at -3e38, as traverse_plain takes it; `active` gates
    K1's sphere test. Returns an AlphaWalk; alpha.counters, when given,
    take the kernel's maxima."""
    dev = o.device
    n = o.shape[0]
    masks = kbvh.use_masks and (occlusion or cell_masks)
    nl = alpha.lights.shape[0] if spheres and not occlusion else 0
    t_cap = float(np.float32(t_max))
    t = torch.zeros(n, dtype=torch.float32, device=dev)
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u, v, flag = torch.zeros_like(t), torch.zeros_like(t), torch.zeros_like(t)
    kind = torch.zeros(n, dtype=torch.int32, device=dev)
    retraces = torch.zeros(n, dtype=torch.int32, device=dev)
    t_cur = t_min.clone()
    todo = torch.ones(n, dtype=torch.bool, device=dev)  # rays still walking
    for k in range(alpha.max_skips + 1):
        tk, pk, fk = traverse_plain(kbvh.node_rows, kbvh.tri_rows, o, d, t_cur,
                                    torch.where(todo, t_limit, torch.full_like(t_limit, -_BIG)),
                                    group=kbvh.group_size, arity=kbvh.arity,
                                    occlusion=occlusion, all_definite=False,
                                    cell_masks=cell_masks)
        uk, vk = _uv_from_prim(kbvh, o, d, pk)
        kk = torch.where(pk >= 0, KIND_TRIANGLE, KIND_MISS).to(torch.int32)
        if occlusion:
            blocker = fk != 0.0
            unc = ~blocker & (pk >= 0)
            tested = unc if masks else unc & alpha.tri_alpha[
                torch.clamp(pk, 0, alpha.tri_alpha.shape[0] - 1).long()]
            rej = alpha_rejected_plain(alpha, pk, uk, vk, tested)
            fk = (blocker | (unc & ~rej)).to(torch.float32)
        else:
            tk = torch.where(pk >= 0, tk, torch.full_like(tk, t_cap))
            if nl > 0:
                s_hit, s_t, s_id = intersect_spheres(o, d, alpha.lights, t_cur, t_max)
                s_hit = s_hit & active & (s_t < tk)
                tk = torch.where(s_hit, s_t, tk)
                pk = torch.where(s_hit, s_id, pk)
                kk = torch.where(s_hit, torch.full_like(kk, KIND_SPHERE), kk)
                fk = torch.where(s_hit, torch.zeros_like(fk), fk)
            tested = (fk > 0.5) if masks else (kk == KIND_TRIANGLE) & alpha.tri_alpha[
                torch.clamp(pk, 0, alpha.tri_alpha.shape[0] - 1).long()]
            rej = alpha_rejected_plain(alpha, pk, uk, vk, tested)
        t, prim, u, v, kind, flag = (torch.where(todo, a, b) for a, b in
                                     ((tk, t), (pk, prim), (uk, u), (vk, v), (kk, kind),
                                      (fk, flag)))
        todo = todo & rej
        if k < alpha.max_skips:
            retraces = torch.where(todo, torch.full_like(retraces, k + 1), retraces)
            t_cur = torch.where(todo, retrace_tmin(tk), t_cur)
    if occlusion:  # the cap: a rejected hit blocks
        flag = torch.where(todo, torch.ones_like(flag), flag)
    counters = alpha.counters
    if counters is not None:  # the kernel's atomicMax and atomicOr
        most = retraces.max() if n else retraces.sum()
        counters.copy_(torch.maximum(counters, torch.stack([most, todo.any().to(torch.int32)])))
    return AlphaWalk(t=t, prim=prim, u=u, v=v, kind=kind, flag=flag, counters=counters)


# ---- the CUDA kernel: build, bind, launch ----------------------------------

_LIB = "wide_traverse"
_WALK_ARGS = "piipipppppppiiiipp"
# the Alpha entry points: the walk's arguments, then csrc's AlphaArgs
_ARGTYPES = {**{name: cudalib.argtypes(_WALK_ARGS)
                for name in ("tpurt_wide_closest", "tpurt_wide_occlusion")},
             **{name: cudalib.argtypes(_WALK_ARGS + "p" * 10 + "i" * 6 + "f")
                for name in ("tpurt_wide_closest_alpha", "tpurt_wide_occlusion_alpha")}}


def _check_launch(kbvh: WideKernelBVH, dev, plain_stack: bool = True) -> CardTables:
    """Raise unless the tables are what the wide kernels read, on the rays'
    device `dev`, and, with `plain_stack`, the topology's per-child stack
    bound fits the plain versions' MAX_STACK (K1's and K6's equality with
    them rests on it; K5 does without). Returns the card tables
    (_check_card)."""
    for name, x in (("node_rows", kbvh.node_rows), ("tri_rows", kbvh.tri_rows)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays are on {dev}")
    cudalib.check(kbvh.node_rows, "node_rows", (8, kbvh.node_rows.shape[1], _LANE))
    cudalib.check(kbvh.tri_rows, "tri_rows", tuple(kbvh.tri_rows.shape))
    if kbvh.arity * 8 > _LANE:
        raise ValueError(f"arity {kbvh.arity} does not fit a node row")
    if plain_stack and kbvh.stack_bound > MAX_STACK:
        raise ValueError(f"stack bound {kbvh.stack_bound} exceeds the kernel's "
                         f"{MAX_STACK}-entry stack")
    return _check_card(kbvh, dev)


def _check_card(kbvh: WideKernelBVH, dev) -> CardTables:
    """Raise unless the card tables are there, on the rays' device,
    int32, contiguous, 16-byte aligned and of the tables' shape, and the
    depth bound fits the kernel's shared-memory stack."""
    card = kbvh.card
    if card is None:
        raise ValueError("the BVH has no card tables: build it with make_wide_kernel_bvh, "
                         "or give it card=card_tables(...)")
    w = kbvh.node_rows.shape[1]
    n_leaf, g = kbvh.tri_rows.shape[0], kbvh.group_size
    for name, x, shape in (("card nodes", card.nodes, (8, w, kbvh.arity, 8)),
                           ("card leaves", card.leaves, (n_leaf, g, 12))):
        if x.device != dev:
            raise ValueError(f"{name} are on {x.device}, rays are on {dev}")
        cudalib.check(x, name, shape, torch.int32)
        if x.data_ptr() % 16:
            raise ValueError(f"{name} are not 16-byte aligned")
    if not 1 <= kbvh.depth_bound <= MAX_DEPTH:
        raise ValueError(f"depth bound {kbvh.depth_bound} outside the kernel's "
                         f"1..{MAX_DEPTH} stack entries")
    return card


# the dtypes of (t, prim, flag)
_OUTS = (torch.float32, torch.int32, torch.float32)


def _walk_args(kbvh: WideKernelBVH, card: CardTables, rays, out) -> tuple:
    """The arguments K1/K2, K5 and K6 open with: the card tables, the four
    ray columns, three outputs and the ray count."""
    return (card.nodes.data_ptr(), kbvh.node_rows.shape[1], kbvh.arity,
            card.leaves.data_ptr(), kbvh.group_size, *(x.data_ptr() for x in rays[:4]),
            *(x.data_ptr() for x in out[:3]), rays[0].shape[0])


def traverse_cuda(kbvh: WideKernelBVH, o, d, t_min, t_limit, *, occlusion: bool,
                  all_definite: bool, cell_masks: bool):
    """Launch K1 (closest) or K2 (occlusion) over the card tables on the
    current stream. Returns (t, prim, flag) as traverse_plain does, bit
    for bit. Does not wait for the card: a walk past the depth bound
    surfaces at the next cudalib.check_kernel_errors."""
    rays = (o, d, t_min, t_limit)
    apply_masks = kbvh.use_masks and (occlusion or cell_masks)
    return cudalib.launch(
        "wide traversal", _LIB, _ARGTYPES,
        "tpurt_wide_occlusion" if occlusion else "tpurt_wide_closest",
        rays, lambda dev: _check_launch(kbvh, dev), _OUTS,
        lambda card, out, err, stream: (*_walk_args(kbvh, card, rays, out), int(apply_masks),
                                        int(all_definite), kbvh.depth_bound, err, stream),
        LAUNCHES, ["occlusion" if occlusion else "closest"])


def _check_alpha(alpha: AlphaTest, dev) -> None:
    """Raise unless the alpha tables and the counters are what the Alpha
    kernels read, on the rays' device."""
    n_tri = alpha.tri_alpha_row.shape[0]
    qh, qw = alpha.atlas_quad.shape[:2]
    for name, x, shape, dtype in (
            ("tri_alpha", alpha.tri_alpha, (n_tri,), torch.bool),
            ("tri_alpha_row", alpha.tri_alpha_row, (n_tri, 11), torch.float32),
            ("tex_table", alpha.tex_table, (alpha.tex_table.shape[0], 10), torch.int32),
            ("atlas_quad", alpha.atlas_quad, (qh, qw, 16), torch.uint8),
            ("lights", alpha.lights, (alpha.lights.shape[0], 8), torch.float32)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays are on {dev}")
        cudalib.check(x, name, shape, dtype)
    if alpha.counters is not None:
        if alpha.counters.device != dev:
            raise ValueError(f"counters are on {alpha.counters.device}, rays are on {dev}")
        cudalib.check(alpha.counters, "counters", (2,), torch.int32)
    if n_tri == 0 or alpha.max_skips < 0:
        raise ValueError(f"alpha test over {n_tri} triangles, max_skips {alpha.max_skips}")


def alpha_walk_cuda(kbvh: WideKernelBVH, o, d, t_min, t_limit, active, alpha: AlphaTest, *,
                    occlusion: bool, cell_masks: bool = False, spheres: bool = False,
                    t_max: float = 0.0) -> AlphaWalk:
    """Launch K1 (closest) or K2 (occlusion) with the alpha re-trace (the
    Alpha instantiations of csrc/wide_traverse.cu) on the current stream.
    Returns the AlphaWalk of alpha_walk_plain, bit for bit; the counters
    are filled when the launch ends. Does not wait for the card."""
    apply_masks = kbvh.use_masks and (occlusion or cell_masks)
    nl = alpha.lights.shape[0] if spheres and not occlusion else 0
    qh, qw = alpha.atlas_quad.shape[:2]

    def tables(dev):
        card = _check_launch(kbvh, dev)
        _check_alpha(alpha, dev)
        return card

    def args(card, out, err, stream):
        u, v, kind = out[3:]
        return (*_walk_args(kbvh, card, (o, d, t_min, t_limit), out), int(apply_masks), 0,
                kbvh.depth_bound, err, stream,
                alpha.tri_alpha.data_ptr(), alpha.tri_alpha_row.data_ptr(),
                alpha.tex_table.data_ptr(), alpha.atlas_quad.data_ptr(), alpha.lights.data_ptr(),
                active.data_ptr(), u.data_ptr(), v.data_ptr(), kind.data_ptr(),
                None if alpha.counters is None else alpha.counters.data_ptr(),
                alpha.tri_alpha_row.shape[0], alpha.tex_table.shape[0], qh, qw, nl,
                alpha.max_skips, float(np.float32(t_max)))

    t, prim, flag, u, v, kind = cudalib.launch(
        "wide traversal with alpha re-trace", _LIB, _ARGTYPES,
        "tpurt_wide_occlusion_alpha" if occlusion else "tpurt_wide_closest_alpha",
        (o, d, t_min, t_limit, active), tables,
        _OUTS + (torch.float32, torch.float32, torch.int32), args, LAUNCHES,
        ["occlusion", "occlusion_alpha"] if occlusion else ["closest", "closest_alpha"])
    return AlphaWalk(t, prim, u, v, kind, flag, alpha.counters)


_OCTET_LIB = "wide_octet"
_OCTET_ARGTYPES = {name: cudalib.argtypes("piipipppppppiiiiiipp")
                   for name in ("tpurt_octet_closest", "tpurt_octet_occlusion")}
# K5 at 8 walks launches one warp per walk (4 rays per lane) from this many
# walks up and one block per walk below: on the bench scene the block
# launch was faster up to 3,840 walks, the warp launch from 7,680 (PERF.md)
OCTET_WARP_WALKS = 6144


def octet_warp_per_walk(n: int, walks: int) -> bool:
    """Whether K5 launches one warp per walk for `n` rays in `walks` walks
    per packet (else one block per walk)."""
    return walks == 8 and -(-n // (PACKET // walks)) >= OCTET_WARP_WALKS


def octet_cuda(kbvh: WideKernelBVH, o, d, t_min, t_limit, *, walks: int, occlusion: bool,
               all_definite: bool, cell_masks: bool):
    """Launch K5 (csrc/wide_octet.cu) over the card tables on the current
    stream: one block per walk of PACKET // walks rays, or one warp per
    walk where octet_warp_per_walk says so. Returns (t, prim, flag) as
    octet_plain does, bit for bit; a walk past the depth bound surfaces at
    the next cudalib.check_kernel_errors."""
    if walks not in OCTET_WALKS:
        raise ValueError(f"octet walks must be one of {OCTET_WALKS}, got {walks}")
    rays = (o, d, t_min, t_limit)
    apply_masks = kbvh.use_masks and (occlusion or cell_masks)
    return cudalib.launch(
        "multi-walk traversal", _OCTET_LIB, _OCTET_ARGTYPES,
        "tpurt_octet_occlusion" if occlusion else "tpurt_octet_closest",
        rays, lambda dev: _check_launch(kbvh, dev, plain_stack=False), _OUTS,
        lambda card, out, err, stream: (*_walk_args(kbvh, card, rays, out), int(apply_masks),
                                        int(all_definite), walks, kbvh.depth_bound,
                                        int(octet_warp_per_walk(o.shape[0], walks)), err,
                                        stream),
        LAUNCHES, ["octet_occlusion" if occlusion else "octet_closest"])


def _route(plain, kernel, o, d, t_min, t_limit, *rest):
    """Cast the ray columns to contiguous f32 and route by device: CPU
    tensors to `plain`, CUDA tensors to `kernel` (each called with the
    cast columns and `rest`), anything else raises. There is no fallback
    from one to the other."""
    o, d, t_min, t_limit = (x.contiguous().to(torch.float32) for x in (o, d, t_min, t_limit))
    if o.is_cuda:
        return kernel(o, d, t_min, t_limit, *rest)
    if o.device.type == "cpu":
        return plain(o, d, t_min, t_limit, *rest)
    raise ValueError(f"no traversal for device {o.device}")


def _traverse(kbvh, o, d, t_min, t_limit, *, occlusion, all_definite, cell_masks, octet=0):
    """Route by device (_route): the plain version or the kernel, K1/K2,
    or K5 with `octet` walks."""
    if octet and octet not in OCTET_WALKS:
        raise ValueError(f"octet must be 0 or one of {OCTET_WALKS}, got {octet}")
    kw = dict(occlusion=occlusion, all_definite=all_definite, cell_masks=cell_masks)
    tables = dict(group=kbvh.group_size, arity=kbvh.arity)
    if octet:
        return _route(partial(octet_plain, kbvh.node_rows, kbvh.tri_rows, walks=octet,
                              **tables, **kw),
                      partial(octet_cuda, kbvh, walks=octet, **kw), o, d, t_min, t_limit)
    return _route(partial(traverse_plain, kbvh.node_rows, kbvh.tri_rows, **tables, **kw),
                  partial(traverse_cuda, kbvh, **kw), o, d, t_min, t_limit)


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


def alpha_packets(kbvh: WideKernelBVH, o, d, t_min, t_limit, active, alpha: AlphaTest, *,
                  occlusion: bool, cell_masks: bool = False, spheres: bool = False,
                  t_max: float = 0.0) -> AlphaWalk:
    """K1 (closest hit over (t_min, t_limit), the miss at t_max, the sphere
    lights with `spheres`) or K2 (occlusion) with the alpha re-trace of
    rejected hits: alpha_walk_cuda on CUDA tensors, alpha_walk_plain on
    CPU tensors, anything else raises. Inactive rays miss."""
    kw = dict(occlusion=occlusion, cell_masks=cell_masks, spheres=spheres, t_max=t_max)
    return _route(partial(alpha_walk_plain, kbvh, **kw), partial(alpha_walk_cuda, kbvh, **kw),
                  o, d, t_min, _t_limit(t_limit, active), active.contiguous(), alpha)


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
_STEPCOST_ARGTYPES = {"tpurt_stepcost": cudalib.argtypes("piipipppppppiiiiiiipp")}
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
    """Launch K6 (csrc/wide_stepcost.cu) over the card tables on the
    current stream. Returns (t, prim, acc) as stepcost_plain does, bit for
    bit. The kernel is built for the phase combinations of
    STEPCOST_CONFIGS only; any other is refused. A walk past the depth
    bound surfaces at the next cudalib.check_kernel_errors."""
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    toggles = dict(do_box=do_box, do_extract=do_extract, do_push=do_push, do_leaf=do_leaf)
    if not any(toggles == {**_STEPCOST_ALL_ON, **c} for _, c in STEPCOST_CONFIGS):
        raise ValueError(f"K6 is built for the STEPCOST_CONFIGS combinations only, "
                         f"not {toggles}")
    rays = (o, d, t_min, t_limit)
    return cudalib.launch(
        "step-cost", _STEPCOST_LIB, _STEPCOST_ARGTYPES, "tpurt_stepcost", rays,
        lambda dev: _check_launch(kbvh, dev), (torch.float32, torch.int32, torch.int32),
        lambda card, out, err, stream: (*_walk_args(kbvh, card, rays, out), steps, int(do_box),
                                        int(do_extract), int(do_push), int(do_leaf),
                                        kbvh.depth_bound, err, stream),
        LAUNCHES, ["stepcost"])


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
    kw = dict(steps=steps, do_box=do_box, do_extract=do_extract, do_push=do_push,
              do_leaf=do_leaf)
    return _route(partial(stepcost_plain, kbvh.node_rows, kbvh.tri_rows, group=kbvh.group_size,
                          arity=kbvh.arity, **kw),
                  partial(stepcost_cuda, kbvh, **kw), o, d, t_min, t_limit)
