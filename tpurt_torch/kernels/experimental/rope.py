"""Binary rope-BVH tables and the stackless closest-hit (K3) and
occlusion (K4) walks (the counterpart of
tpurt/kernels/experimental/pallas_traverse.py).

Three parts:

1. Tables, host-side numpy (`pack_scene_for_kernel`, `make_kernel_bvh`),
   byte-equal to tpurt's. A node row is (8, M, 8) f32 per direction
   octant: [min3, max3, hit link, miss link], the links being the
   TriBVH's per-octant `first` (internal nodes, 0 for leaves) and `skip`
   ropes as f32-exact integers. A leaf row holds the leaf's G triangles
   (G*9 floats, in `tri_order`) and, when G*10 <= 128, the G alpha masks
   (bits 0-15 transparent 4x4 cells, bit 16 alpha-testable).
2. The plain PyTorch walks (`traverse_plain`): every live ray takes one
   rope step per iteration, all rays at once. They have the kernels'
   contract and arithmetic order and serve CPU tensors and the tests.
3. The kernel wrappers `traverse_packets` / `occlusion_packets`
   (tpurt's signatures, without `interpret`). A CPU tensor goes to the
   plain walk; a CUDA tensor goes to csrc/rope_traverse.cu (K3, K4),
   built with nvcc on first use and bound through ctypes. There is no
   fallback from one to the other.

The walk. A ray starts at the root if active (else at the END sentinel
M); at node n it tests n's box against (t_min, t_best); an internal node
whose box is hit goes to `first[oct][n]`, anything else to
`skip[oct][n]`; a leaf whose box is hit tests its G triangles in row
order with a strict `t < t_best` (the last leaf is padded with copies of
its last triangle, so the first copy wins). tpurt's kernel walks one
octant per 1024-ray packet and descends when any ray of the packet hits;
here each ray walks its own octant. Every ray's set of hits is the same,
so closest hits agree except on exact-t ties. In occlusion mode a ray
retires after the leaf in which it met a definite blocker; the order of
the walk decides whether an uncertain (alpha-testable) hit or a definite
one further on is met first, so `blocked` of one ray can differ from
tpurt's packet walk when the packet's octant is not the ray's (the
integrator's recheck resolves both orders to the same image).

K4's padding rays (t_limit = 0) have no counterpart: there are no
packets, and the kernel skips threads past the last ray.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from tpurt_torch.bvh.lbvh import TriBVH
from tpurt_torch.kernels import cudalib
from tpurt_torch.kernels.intersect import mask_cell, ray_triangle_rows

PACKET = 1024  # tpurt's rays per packet; the kernels here have no packets
_LANE = 128
KERNEL_GROUP = 14  # G*9 = 126 <= 128: the largest leaf a row holds
_ROW = 8  # floats per node row: min3, max3, hit link, miss link

# launches of the CUDA kernel per mode; plain CPU walks do not count
LAUNCHES = {"rope_closest": 0, "rope_occlusion": 0}


@dataclasses.dataclass(frozen=True)
class KernelBVH:
    """TriBVH plus its packed rope tables on a device."""

    tribvh: TriBVH
    node_rows: torch.Tensor  # (8, M, 8) f32
    tri_rows: torch.Tensor   # (L, G*9 [+ G]) f32
    tri_order: torch.Tensor  # (L*G,) int64: leaf slot -> original triangle id

    @property
    def group_size(self) -> int:
        return self.tribvh.group_size

    @property
    def n_internal(self) -> int:
        return self.tribvh.bvh.num_internal

    @property
    def use_masks(self) -> bool:
        return self.tri_rows.shape[1] == self.group_size * 10


# ---- tables (host numpy) ---------------------------------------------------

def pack_scene_for_kernel(tribvh: TriBVH, tri_pos, tri_alpha_mask=None):
    """(node_rows (8, M, 8), tri_rows (L, G*9 [+ G])) as f32 numpy arrays,
    equal to tpurt's. Needs identity leaf order (leaf l holds triangle
    block l of tri_order, as build_triangle_bvh makes it) and G*9 <= 128."""
    bvh = tribvh.bvh
    g = tribvh.group_size
    assert g * 9 <= _LANE, f"group_size {g} does not fit a 128-lane leaf row"
    box = np.concatenate([bvh.node_min, bvh.node_max], axis=1).astype(np.float32)
    first_pad = np.concatenate(
        [np.asarray(bvh.first, np.int32), np.zeros((8, bvh.num_leaves), np.int32)], axis=1)
    node_rows = np.concatenate(
        [np.broadcast_to(box[None], (8,) + box.shape),
         first_pad[..., None].astype(np.float32),
         np.asarray(bvh.skip)[..., None].astype(np.float32)], axis=2)
    tri_order = np.asarray(tribvh.tri_order)
    tri_rows = np.asarray(tri_pos, np.float32)[tri_order].reshape(bvh.num_leaves, g * 9)
    if tri_alpha_mask is not None and g * 10 <= _LANE:
        masks = np.asarray(tri_alpha_mask)[tri_order].astype(np.float32)
        tri_rows = np.concatenate([tri_rows, masks.reshape(bvh.num_leaves, g)], axis=1)
    return node_rows, tri_rows


def _as_np(x):
    if x is None or not isinstance(x, torch.Tensor):
        return x if x is None else np.asarray(x)
    return x.cpu().numpy()


def make_kernel_bvh(tribvh: TriBVH, tri_pos, tri_alpha_mask=None,
                    device="cuda") -> KernelBVH:
    """Pack the rope tables and move them to `device` once."""
    node_rows, tri_rows = pack_scene_for_kernel(tribvh, _as_np(tri_pos),
                                                _as_np(tri_alpha_mask))
    return KernelBVH(
        tribvh=tribvh,
        node_rows=torch.from_numpy(np.ascontiguousarray(node_rows)).to(device),
        tri_rows=torch.from_numpy(np.ascontiguousarray(tri_rows)).to(device),
        tri_order=torch.from_numpy(np.asarray(tribvh.tri_order, np.int64)).to(device))


def kernel_supported(tribvh: TriBVH) -> bool:
    """Whether the leaves fit a 128-lane row (G*9 <= 128). tpurt also
    checks its packed tables against a 52 MB VMEM budget; that is a limit
    of the TPU's on-chip memory and has no counterpart on the card,
    whose tables sit in device memory."""
    return tribvh.group_size * 9 <= _LANE


def _vmem_bytes(n_leaves: int) -> int:
    m = 2 * n_leaves - 1
    return (2 * m + n_leaves) * _LANE * 4


def pick_group_size(num_tris: int, vmem_budget_bytes=52 * 2 ** 20) -> int:
    """Leaf group size, chosen exactly as tpurt chooses it (the smallest
    of 4..14 whose tables fit tpurt's planning budget), so both packages
    build the same tables for the same scene. The budget is tpurt's TPU
    number, not a limit of the card."""
    for g in (4, 6, 8, 10, 12, 14):
        if _vmem_bytes(max(-(-num_tris // g), 2)) < vmem_budget_bytes:
            return g
    return KERNEL_GROUP


# ---- the plain PyTorch walk --------------------------------------------------

def traverse_plain(node_rows, tri_rows, o, d, t_min, t_limit, active, *,
                   n_internal: int, group: int, occlusion: bool, all_definite: bool,
                   stats: Optional[dict] = None):
    """Walk every ray along the ropes at once, one node per ray per
    iteration. Same contract and arithmetic order as the CUDA kernel.

    Inputs: node_rows (8, M, 8), tri_rows (L, R) f32; o, d (N, 3); t_min,
    t_limit (N,) (t_limit is the start of t_best: t_max for K3); active
    (N,) bool. Returns (t, prim, u, v, blocked): prim is the leaf slot
    leaf * G + k (-1 on a miss), blocked (f32 0/1) is set only in
    occlusion mode. With masks (R == G*10) a hit in a cell whose bit is
    set is rejected; in occlusion mode a hit blocks when bit 16 is clear,
    or on any hit with `all_definite` and no masks. Raises if a ray takes
    more than 4*M steps (a broken rope). With `stats` (a dict) it stores
    per-ray node visits (one box test each) and leaf tests, and the
    number of distinct node and leaf rows read."""
    dev = o.device
    n = o.shape[0]
    g = group
    m = node_rows.shape[1]
    use_masks = tri_rows.shape[1] == g * 10
    ox, oy, oz = o[:, 0].contiguous(), o[:, 1].contiguous(), o[:, 2].contiguous()
    dx, dy, dz = d[:, 0].contiguous(), d[:, 1].contiguous(), d[:, 2].contiguous()
    octant = ((dx < 0).long() * 4 + (dy < 0).long() * 2 + (dz < 0).long())

    def inv_dir(x):
        sign = torch.where(x >= 0, torch.ones_like(x), -torch.ones_like(x))
        return sign / torch.clamp(torch.abs(x), min=1e-20)

    inv_x, inv_y, inv_z = inv_dir(dx), inv_dir(dy), inv_dir(dz)
    t_best = t_limit.to(torch.float32).clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    uu = torch.zeros(n, dtype=torch.float32, device=dev)
    vv = torch.zeros(n, dtype=torch.float32, device=dev)
    blocked = torch.zeros(n, dtype=torch.float32, device=dev)
    node = torch.where(active, 0, m).to(torch.int64)
    flat = node_rows.reshape(-1, _ROW)
    node_visits = torch.zeros(n, dtype=torch.int64, device=dev)
    leaf_visits = torch.zeros(n, dtype=torch.int64, device=dev)
    node_seen = torch.zeros(8 * m, dtype=torch.bool, device=dev)
    leaf_seen = torch.zeros(tri_rows.shape[0], dtype=torch.bool, device=dev)

    live = torch.nonzero(node != m, as_tuple=True)[0]
    steps = 0
    while live.numel():
        if steps >= 4 * m:
            raise RuntimeError(f"rope walk exceeded its 4*M = {4 * m} step cap "
                               "(a broken rope link)")
        steps += 1
        nd = node[live]
        flat_row = octant[live] * m + nd
        row = flat[flat_row]
        node_seen[flat_row] = True
        node_visits[live] += 1
        lox, loy, loz = ox[live], oy[live], oz[live]
        t0x = (row[:, 0] - lox) * inv_x[live]
        t1x = (row[:, 3] - lox) * inv_x[live]
        t0y = (row[:, 1] - loy) * inv_y[live]
        t1y = (row[:, 4] - loy) * inv_y[live]
        t0z = (row[:, 2] - loz) * inv_z[live]
        t1z = (row[:, 5] - loz) * inv_z[live]
        tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                           torch.maximum(torch.minimum(t0z, t1z), t_min[live]))
        tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                           torch.minimum(torch.maximum(t0z, t1z), t_best[live]))
        box_hit = tn <= tf
        is_leaf = nd >= n_internal

        # ---- leaves whose box is hit: G triangle tests in row order ----
        sel = box_hit & is_leaf
        li = live[sel]
        if li.numel():
            leaf = nd[sel] - n_internal
            leaf_seen[leaf] = True
            leaf_visits[li] += 1
            lrow = tri_rows[leaf]
            lo = (ox[li], oy[li], oz[li])
            ld = (dx[li], dy[li], dz[li])
            ltmin = t_min[li]
            tb, pr, lu, lv, bl = t_best[li], prim[li], uu[li], vv[li], blocked[li]
            slot0 = (leaf * g).to(torch.int32)
            for k in range(g):
                ok, u, v, t = ray_triangle_rows(lrow[:, 9 * k:9 * k + 9], *lo, *ld)
                hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > ltmin) & (t < tb)
                if use_masks:
                    m_int = lrow[:, g * 9 + k].to(torch.int32)
                    hit = hit & (((m_int >> mask_cell(u, v)) & 1) == 0)
                    if occlusion:
                        definite = hit & (((m_int >> 16) & 1) == 0)
                        bl = torch.where(definite, torch.ones_like(bl), bl)
                elif occlusion and all_definite:
                    bl = torch.where(hit, torch.ones_like(bl), bl)
                tb = torch.where(hit, t, tb)
                pr = torch.where(hit, slot0 + k, pr)
                lu = torch.where(hit, u, lu)
                lv = torch.where(hit, v, lv)
            t_best[li], prim[li], uu[li], vv[li], blocked[li] = tb, pr, lu, lv, bl

        nxt = torch.where(box_hit & ~is_leaf, row[:, 6], row[:, 7]).to(torch.int64)
        node[live] = nxt
        keep = nxt != m
        if occlusion:
            keep = keep & (blocked[live] == 0.0)
        live = live[keep]

    if stats is not None:
        stats["node_visits"] = node_visits
        stats["leaf_visits"] = leaf_visits
        stats["node_rows_read"] = int(node_seen.sum())
        stats["leaf_rows_read"] = int(leaf_seen.sum())
    return t_best, prim, uu, vv, blocked


# ---- the CUDA kernel: build, bind, launch ----------------------------------

_LIB = "rope_traverse"
_ARGTYPES = {name: cudalib.argtypes("piipiiii" + "p" * 10 + "ipp")
             for name in ("tpurt_rope_closest", "tpurt_rope_occlusion")}


def traverse_cuda(kbvh: KernelBVH, o, d, t_min, t_limit, active, *, occlusion: bool,
                  all_definite: bool):
    """Launch K3 (closest) or K4 (occlusion) on the current stream. Returns
    (t, prim, u, v, blocked) as traverse_plain does. Does not wait for the
    card: a walk that hits its step cap surfaces at the next
    cudalib.check_kernel_errors."""
    dev = o.device
    n = o.shape[0]
    for name, x in (("node_rows", kbvh.node_rows), ("tri_rows", kbvh.tri_rows),
                    ("d", d), ("t_min", t_min), ("t_limit", t_limit), ("active", active)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, rays are on {dev}")
    g = kbvh.group_size
    m = kbvh.node_rows.shape[1]
    cudalib.check(o, "o", (n, 3))
    cudalib.check(d, "d", (n, 3))
    cudalib.check(t_min, "t_min", (n,))
    cudalib.check(t_limit, "t_limit", (n,))
    cudalib.check(active, "active", (n,), torch.bool)
    cudalib.check(kbvh.node_rows, "node_rows", (8, m, _ROW))
    if kbvh.tri_rows.shape[1] not in (g * 9, g * 10) or not 1 <= g <= KERNEL_GROUP:
        raise ValueError(f"leaf rows of width {kbvh.tri_rows.shape[1]} do not hold G={g}")
    cudalib.check(kbvh.tri_rows, "tri_rows", (kbvh.tribvh.bvh.num_leaves, kbvh.tri_rows.shape[1]))
    out = (torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.int32, device=dev),
           torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.float32, device=dev),
           torch.empty(n, dtype=torch.float32, device=dev))
    if n == 0:
        return out
    lib = cudalib.load(_LIB, _ARGTYPES)
    fn = lib.tpurt_rope_occlusion if occlusion else lib.tpurt_rope_closest
    rc = fn(kbvh.node_rows.data_ptr(), m, kbvh.n_internal,
            kbvh.tri_rows.data_ptr(), kbvh.tri_rows.shape[1], g,
            int(kbvh.use_masks), int(all_definite),
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_limit.data_ptr(),
            active.data_ptr(), *(x.data_ptr() for x in out), n,
            cudalib.error_word(dev).data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cudalib.launch_check(rc, "rope traversal")
    LAUNCHES["rope_occlusion" if occlusion else "rope_closest"] += 1
    return out


def _traverse(kbvh: KernelBVH, o, d, t_min, t_limit, active, *, occlusion, all_definite):
    """Route by device: CPU tensors to the plain walk, CUDA tensors to the
    kernel, anything else raises."""
    o = o.contiguous().to(torch.float32)
    d = d.contiguous().to(torch.float32)
    t_min = t_min.contiguous().to(torch.float32)
    t_limit = t_limit.contiguous().to(torch.float32)
    active = active.contiguous().to(torch.bool)
    if o.is_cuda:
        return traverse_cuda(kbvh, o, d, t_min, t_limit, active, occlusion=occlusion,
                             all_definite=all_definite)
    if o.device.type == "cpu":
        return traverse_plain(kbvh.node_rows, kbvh.tri_rows, o, d, t_min, t_limit, active,
                              n_internal=kbvh.n_internal, group=kbvh.group_size,
                              occlusion=occlusion, all_definite=all_definite)
    raise ValueError(f"no rope traversal for device {o.device}")


def original_ids(kbvh: KernelBVH, slot):
    """Leaf slot (leaf * G + k) to the original triangle id, -1 kept."""
    ids = kbvh.tri_order[torch.clamp(slot, min=0).long()].to(torch.int32)
    return torch.where(slot >= 0, ids, slot)


def traverse_packets(kbvh: KernelBVH, o, d, t_min, t_max, active):
    """Closest hit (K3). Returns (t, prim (original ids, -1 on a miss), u,
    v). Inactive rays miss at t_max. With mask columns, hits in
    transparent cells are skipped."""
    t_limit = torch.full((o.shape[0],), float(np.float32(t_max)), dtype=torch.float32,
                         device=o.device)
    t, slot, u, v, _ = _traverse(kbvh, o, d, t_min, t_limit, active, occlusion=False,
                                 all_definite=False)
    return t, original_ids(kbvh, slot), u, v


def occlusion_packets(kbvh: KernelBVH, o, d, t_min, t_limit, active,
                      scene_has_alpha: bool):
    """Occlusion (K4). Returns (blocked, t, prim, u, v): `blocked` marks a
    definite blocker in (t_min, t_limit); otherwise (t, prim, u, v) is the
    closest accepted hit (an alpha-testable one) for the host recheck.
    Without alpha in the scene every hit is definite."""
    t, slot, u, v, blocked = _traverse(kbvh, o, d, t_min, t_limit, active, occlusion=True,
                                       all_definite=not scene_has_alpha)
    return blocked > 0.0, t, original_ids(kbvh, slot), u, v
