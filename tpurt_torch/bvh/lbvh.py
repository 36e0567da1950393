"""Triangle BVH build on the host (the counterpart of the host path of
tpurt/bvh/lbvh.py): binned SAH in the native library by preference, a
Morton sort + Karras radix tree (also native) as its fallback. The
result stays in numpy; kernels/wide.py collapses and packs it into the
device tables. tpurt's jitted device LBVH has no counterpart yet.

Node layout (N leaves => N-1 internal nodes):
- `left`, `right`: (N-1,) child ids; k < N-1 is internal node k,
  k >= N-1 is leaf k - (N-1).
- `node_min`, `node_max`: (2N-1, 3) boxes, internal nodes first.
- `leaf_prim`: (N,) the leaf's group id (identity after the build).
- `first`, `skip`: per-octant rope links, unused by the wide kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch import native


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


def build_triangle_bvh(tri_pos: np.ndarray, group_size: int = 4) -> TriBVH:
    """Host triangle BVH (tpurt/bvh/lbvh.py::_build_triangle_bvh_host):
    binned SAH, or Morton grouping + Karras when SAH overflows its leaf
    budget. `group_size` defaults to 4, as tpurt's does, so a call without
    it builds tpurt's leaves. Raises if the native library cannot be
    built."""
    tri_np = np.asarray(tri_pos, np.float32)
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
        raise RuntimeError("native LBVH build failed")
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
