"""Triangle BVH builds (the counterpart of tpurt/bvh/lbvh.py).

Two builds of the same grouped-leaf layout, chosen as tpurt chooses:

- on the host, in the native library: binned SAH by preference, a Morton
  sort + Karras radix tree as its fallback;
- on the device, when the native library is unavailable: Morton codes,
  a stable argsort, the Karras split search over code||index keys,
  fixed-count refit sweeps, and the per-octant `first` links and `skip`
  ropes (tpurt's jitted `build_lbvh`, as torch ops on the device's
  tensors, copied to the host once at the end).

Either result stays in numpy; kernels/wide.py collapses and packs it
into the device tables.

Node layout (N leaves => N-1 internal nodes):
- `left`, `right`: (N-1,) child ids; k < N-1 is internal node k,
  k >= N-1 is leaf k - (N-1).
- `node_min`, `node_max`: (2N-1, 3) boxes, internal nodes first.
- `leaf_prim`: (N,) the leaf's primitive (the group id in a TriBVH,
  identity after the build).
- `first`, `skip`: (8, N-1) and (8, 2N-1) per-octant rope links, END =
  2N-1; the wide kernel does not read them.
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch import native
from tpurt_torch.runtime.device import resolve_device


class LBVH(NamedTuple):
    left: np.ndarray
    right: np.ndarray
    node_min: np.ndarray
    node_max: np.ndarray
    leaf_prim: np.ndarray
    first: np.ndarray
    skip: np.ndarray

    @property
    def num_leaves(self) -> int:
        return self.leaf_prim.shape[0]

    @property
    def num_internal(self) -> int:
        return self.leaf_prim.shape[0] - 1


class TriBVH(NamedTuple):
    """LBVH whose leaves each cover `group_size` consecutive triangles of
    `tri_order` (original triangle ids, padded by repetition)."""

    bvh: LBVH
    tri_order: np.ndarray  # (n_leaves * G,) int32

    @property
    def group_size(self) -> int:
        return self.tri_order.shape[0] // self.bvh.leaf_prim.shape[0]


def build_triangle_bvh(tri_pos, group_size: int = 4, refit_passes: int = 64,
                       device="cuda") -> TriBVH:
    """The triangle BVH, built as tpurt builds it (tpurt/bvh/lbvh.py:259):
    on the host when the native library is available, otherwise on
    `device` (`_build_triangle_bvh_device`, announced on stderr).
    `group_size` defaults to 4, as tpurt's does, so a call without it
    builds tpurt's leaves."""
    built = _build_triangle_bvh_host(tri_pos, group_size)
    if built is not None:
        return built
    print(f"tpurt_torch: native library unavailable ({native.unavailable_reason()}); "
          f"building the triangle BVH on {device}", file=sys.stderr)
    return _build_triangle_bvh_device(tri_pos, group_size, refit_passes, device=device)


def _build_triangle_bvh_host(tri_pos, group_size: int):
    """Native host build (tpurt/bvh/lbvh.py::_build_triangle_bvh_host):
    binned SAH, or Morton grouping + Karras when SAH overflows its leaf
    budget. None if the native library is unavailable."""
    if not native.available():
        return None
    tri_np = np.asarray(tri_pos.cpu() if isinstance(tri_pos, torch.Tensor) else tri_pos,
                        np.float32)
    t = tri_np.shape[0]
    pmin = tri_np.min(axis=1)
    pmax = tri_np.max(axis=1)

    built = native.build_sah_tribvh(pmin, pmax, group_size)
    if built is not None:
        tri_order, bvh = built
        return TriBVH(bvh=bvh, tri_order=tri_order)
    centroids = 0.5 * (pmin + pmax)
    lo = pmin.min(axis=0)
    hi = pmax.max(axis=0)
    extent = np.maximum(hi - lo, 1e-20)
    codes = native.morton30((centroids - lo) / extent)
    order = np.argsort(codes, kind="stable").astype(np.int32)

    n_groups = max((t + group_size - 1) // group_size, 2)
    padded = n_groups * group_size
    order_padded = np.concatenate(
        [order, np.broadcast_to(order[-1:], (padded - t,))])
    gmin = pmin[order_padded].reshape(n_groups, group_size, 3).min(axis=1)
    gmax = pmax[order_padded].reshape(n_groups, group_size, 3).max(axis=1)
    bvh = native.build_lbvh_native(gmin, gmax)
    if bvh is None:
        return None
    tri_order_leaf = order_padded.reshape(n_groups, group_size)[
        bvh.leaf_prim].reshape(-1)
    bvh = bvh._replace(leaf_prim=np.arange(n_groups, dtype=np.int32))
    return TriBVH(bvh=bvh, tri_order=tri_order_leaf)


def _expand_bits(v):
    """Insert two zero bits between each of the low 10 bits (u32 maths in
    int64 with masks)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3(points01):
    """30-bit Morton code of (N, 3) float32 points in [0, 1]^3, as int64
    (tpurt/bvh/lbvh.py::morton3)."""
    q = torch.clamp(points01 * 1024.0, 0.0, 1023.0).to(torch.int64)
    return ((_expand_bits(q[..., 0]) << 2) | (_expand_bits(q[..., 1]) << 1)
            | _expand_bits(q[..., 2]))


# ---- the device build ---------------------------------------------------------

def _clz32(x):
    """Leading zeros of 32-bit values held in int64 (tpurt's _clz32): a
    five-step binary search, since torch has no clz or popcount."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        top_clear = x < (1 << (32 - s))
        n = n + top_clear.to(x.dtype) * s
        x = torch.where(top_clear, x << s, x)
    return n + (x == 0).to(x.dtype)


def _morton_order(prim_min, prim_max):
    """The stable Morton order of the boxes' centroids over their joint
    bounds, and the sorted codes."""
    centroids = 0.5 * (prim_min + prim_max)
    lo = torch.amin(prim_min, dim=0)
    hi = torch.amax(prim_max, dim=0)
    extent = torch.clamp(hi - lo, min=1e-20)
    codes = morton3((centroids - lo) / extent)
    order = torch.argsort(codes, stable=True)
    return order, codes[order]


def _lbvh_tensors(prim_min, prim_max, refit_passes: int) -> LBVH:
    """tpurt's build_lbvh on the boxes' device; int64 and float32 tensors.
    Every step is elementwise, a gather, a min/max or a scatter to unique
    indices, so the result does not depend on the device."""
    n = prim_min.shape[0]
    n_int = n - 1
    order, codes = _morton_order(prim_min, prim_max)
    i = torch.arange(n_int, dtype=torch.int64, device=prim_min.device)
    ci = codes[:n_int]

    def delta(j):
        """Common prefix length of the keys code||index of i and j; -1
        where j is out of range (Karras 2012, sec. 4)."""
        jc = torch.clamp(j, 0, n - 1)
        cj = codes[jc]
        d = torch.where(ci == cj, 32 + _clz32(i ^ jc), _clz32(ci ^ cj))
        return torch.where((j >= 0) & (j < n), d, torch.full_like(d, -1))

    d = torch.sign(delta(i + 1) - delta(i - 1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    delta_min = delta(i - d)
    # upper bound of the range length by doubling (clamped at 2^30), then
    # the exact other end and the split by binary search, each a fixed
    # number of steps as in tpurt's scans
    lmax = torch.full_like(i, 2)
    for _ in range(32):
        lmax = torch.where(delta(i + lmax * d) > delta_min,
                           torch.clamp(lmax * 2, max=1 << 30), lmax)
    length = torch.zeros_like(i)
    for shift in range(1, 31):
        step = lmax >> shift
        length = torch.where(delta(i + (length + step) * d) > delta_min, length + step, length)
    j = i + length * d
    delta_node = delta(j)
    split = torch.zeros_like(i)
    for shift in range(1, 31):
        step = (length + (1 << shift) - 1) >> shift
        split = torch.where(delta(i + (split + step) * d) > delta_node, split + step, split)
    gamma = i + split * d + torch.clamp(d, max=0)
    left = torch.where(torch.minimum(i, j) == gamma, gamma + n_int, gamma)
    right = torch.where(torch.maximum(i, j) == gamma + 1, gamma + 1 + n_int, gamma + 1)

    # refit: leaves fixed, internal nodes converge one level per sweep
    inf = torch.full((n_int, 3), float("inf"), dtype=prim_min.dtype, device=prim_min.device)
    node_min = torch.cat([inf, prim_min[order]])
    node_max = torch.cat([-inf, prim_max[order]])
    for _ in range(refit_passes):
        new_min = torch.minimum(node_min[left], node_min[right])
        new_max = torch.maximum(node_max[left], node_max[right])
        node_min[:n_int] = new_min
        node_max[:n_int] = new_max

    # per-octant child order: the child nearer along the octant's
    # direction first. The score is the sign of oct_signs . delta; the
    # products are exact (signs are +-1), so only the order of the sum
    # matters, and it is XLA's: (x + y) + z
    centers = 0.5 * (node_min + node_max)
    dl = centers[right] - centers[left]
    score = torch.stack([(sx * dl[:, 0] + sy * dl[:, 1]) + sz * dl[:, 2]
                         for sx, sy, sz in _OCT_SIGNS])
    near = score >= 0.0
    first = torch.where(near, left[None, :], right[None, :])
    second = torch.where(near, right[None, :], left[None, :])

    # ropes per octant: skip[first[i]] = second[i] (the sibling), then
    # skip[second[i]] = skip[i] (the parent's escape), which climbs one
    # level per sweep. Within an octant every node is the child of one
    # parent, so each scatter writes unique indices.
    skip = torch.full((8, 2 * n - 1), 2 * n - 1, dtype=torch.int64, device=prim_min.device)
    for _ in range(refit_passes):
        skip.scatter_(1, first, second)
        skip.scatter_(1, second, skip[:, :n_int].clone())
    return LBVH(left=left, right=right, node_min=node_min, node_max=node_max,
                leaf_prim=order, first=first, skip=skip)


# octant bit 4: x < 0, 2: y < 0, 1: z < 0
_OCT_SIGNS = [(1.0 - 2 * ((o >> 2) & 1), 1.0 - 2 * ((o >> 1) & 1), 1.0 - 2 * (o & 1))
              for o in range(8)]


def _host(bvh: LBVH) -> LBVH:
    """The LBVH's tensors as numpy: int32 links, float32 boxes."""
    return LBVH(*(x.cpu().numpy().astype(np.float32 if x.is_floating_point() else np.int32)
                  for x in bvh))


def build_lbvh(prim_min, prim_max, refit_passes: int = 64, device="cuda") -> LBVH:
    """tpurt's build_lbvh (tpurt/bvh/lbvh.py:98) over (N, 3) primitive
    boxes (N >= 2), on `device`; returns numpy arrays. refit_passes
    bounds the refit and rope sweeps: the radix tree over the tie-broken
    keys is at most 60 levels deep, so 64 always converge."""
    dev = resolve_device(device)
    pmin = torch.as_tensor(prim_min, dtype=torch.float32).to(dev)
    pmax = torch.as_tensor(prim_max, dtype=torch.float32).to(dev)
    return _host(_lbvh_tensors(pmin, pmax, refit_passes))


def triangle_aabbs(tri_pos):
    """(T, 3, 3) world triangles -> per-primitive (min, max) boxes."""
    tri_pos = torch.as_tensor(tri_pos)
    return torch.amin(tri_pos, dim=1), torch.amax(tri_pos, dim=1)


def _build_triangle_bvh_device(tri_pos, group_size: int = 4, refit_passes: int = 64,
                               device="cuda") -> TriBVH:
    """tpurt's device build (tpurt/bvh/lbvh.py:321): Morton-sort the
    triangles, group `group_size` consecutive ones per leaf (the last
    padded by repeating the last sorted triangle), build the LBVH over the
    group boxes on `device`, and permute the groups into leaf order
    (identity leaf_prim). Returns numpy arrays."""
    dev = resolve_device(device)
    tri = torch.as_tensor(tri_pos, dtype=torch.float32).to(dev)
    t = tri.shape[0]
    pmin, pmax = triangle_aabbs(tri)
    order, _ = _morton_order(pmin, pmax)
    n_groups = max((t + group_size - 1) // group_size, 2)
    padded = n_groups * group_size
    order_padded = torch.cat([order, order[-1:].expand(padded - t)])
    gmin = torch.amin(pmin[order_padded].reshape(n_groups, group_size, 3), dim=1)
    gmax = torch.amax(pmax[order_padded].reshape(n_groups, group_size, 3), dim=1)
    bvh = _lbvh_tensors(gmin, gmax, refit_passes)
    tri_order = order_padded.reshape(n_groups, group_size)[bvh.leaf_prim].reshape(-1)
    bvh = bvh._replace(leaf_prim=torch.arange(n_groups, device=dev))
    return TriBVH(bvh=_host(bvh), tri_order=tri_order.cpu().numpy().astype(np.int32))


class InvalidLBVH(AssertionError):
    """validate_lbvh found a broken tree."""


def _require(cond, msg):
    if not cond:
        raise InvalidLBVH(msg)


def validate_lbvh(bvh: LBVH, prim_min, prim_max) -> None:
    """tpurt's property checks (tpurt/bvh/lbvh.py:351), on the host: every
    leaf reached exactly once from the root; each child box inside its
    parent's (1e-5 slack); leaf boxes equal their primitive's; and in each
    octant the stackless walk (descend via `first`, leave a leaf via
    `skip`) visits every node once and ends at END. Raises InvalidLBVH."""
    left, right = np.asarray(bvh.left), np.asarray(bvh.right)
    node_min, node_max = np.asarray(bvh.node_min), np.asarray(bvh.node_max)
    n = bvh.num_leaves
    seen = np.zeros(n, dtype=int)
    stack = [0] if n > 1 else []
    if n == 1:
        seen[0] = 1
    guard = 0
    while stack:
        guard += 1
        _require(guard < 4 * n, "traversal did not terminate")
        node = stack.pop()
        for child in (left[node], right[node]):
            _require((node_min[child] >= node_min[node] - 1e-5).all()
                     and (node_max[child] <= node_max[node] + 1e-5).all(),
                     f"child {child} leaves the box of node {node}")
            if child >= n - 1:
                seen[child - (n - 1)] += 1
            else:
                stack.append(child)
    _require((seen == 1).all(), "every leaf must be reached exactly once")
    lp = np.asarray(bvh.leaf_prim)
    for got, want in ((node_min[n - 1:], np.asarray(prim_min)[lp]),
                      (node_max[n - 1:], np.asarray(prim_max)[lp])):
        _require(np.allclose(got, want, rtol=1e-6, atol=0.0),
                 "leaf boxes differ from their primitives'")
    first, skip = np.asarray(bvh.first), np.asarray(bvh.skip)
    end = 2 * n - 1
    if n > 1:
        for o in range(8):
            visits = np.zeros(end, dtype=int)
            node, hops = 0, 0
            while node != end:
                _require(0 <= node < end, f"octant {o}: link {node} out of range")
                visits[node] += 1
                node = first[o, node] if node < n - 1 else skip[o, node]
                hops += 1
                _require(hops <= end + 1, f"octant {o} walk did not terminate")
            _require((visits == 1).all(), f"octant {o} DFS must visit every node once")
