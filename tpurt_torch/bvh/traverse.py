"""Closest-hit and occlusion dispatch (the counterpart of
tpurt/bvh/traverse.py).

`closest_hit` dispatches on the BVH's type, as tpurt's does: the wide
tables (WideKernelBVH) go to K1, or to the multi-walk K5 when the
KernelPolicy asks for it (`octet_closest`), the rope tables
(rope.KernelBVH) to `intersect_scene`, the rope walk, which runs K3 (it
also takes a TriBVH or a plain LBVH and packs their tables; the policy
does not apply to it, as in tpurt). `occlusion_hit` takes the wide
tables only, as tpurt's does (K2, or K5 with `octet_occlusion`): the
rope path resolves shadow rays with a full closest-hit trace in the
integrator. `intersect_brute_force` is the
test oracle.

On the wide path, above 2048 rays the rays are sorted by an (octant,
origin Morton, direction Morton) key before the traversal and the
results are put back in the caller's order, as tpurt does; tpurt's
variadic `lax.sort` becomes a stable `torch.sort` plus gathers. The sort
changes which rays share a warp, never a ray's result. The rope path is
not sorted, as in tpurt.
"""

from __future__ import annotations

import numpy as np
import torch

from tpurt_torch.bvh.lbvh import LBVH, TriBVH, morton3
from tpurt_torch.config import DEFAULT_KERNEL_POLICY, KernelPolicy
from tpurt_torch.kernels import wide
from tpurt_torch.kernels.experimental import rope
from tpurt_torch.kernels.intersect import (
    Hit,
    KIND_MISS,
    KIND_SPHERE,
    KIND_TRIANGLE,
    intersect_spheres,
    ray_triangle,
)

SORT_MIN_RAYS = 2048


def _apply_spheres(o, d, lights, t_min, t_max, active, t, prim, kind):
    """Spheres after the triangles: a sphere hit nearer than the triangle
    hit replaces it (tpurt/bvh/traverse.py:185-191)."""
    s_hit, s_t, s_id = intersect_spheres(o, d, lights, t_min, t_max)
    s_hit = s_hit & active & (s_t < t)
    return (torch.where(s_hit, s_t, t), torch.where(s_hit, s_id, prim),
            torch.where(s_hit, torch.full_like(kind, KIND_SPHERE), kind), s_hit)


def _rope_tables(bvh, tri_pos, device) -> rope.KernelBVH:
    """The rope tables of a TriBVH or a plain LBVH (one triangle per leaf,
    leaf_prim the triangle ids: the G=1 case of tpurt:85-90), packed on
    `device`. A rope.KernelBVH is returned as it is."""
    if isinstance(bvh, rope.KernelBVH):
        return bvh
    if not isinstance(bvh, TriBVH):
        if not isinstance(bvh, LBVH):
            raise TypeError(f"no rope walk over {type(bvh).__name__}")
        n = bvh.leaf_prim.shape[0]
        bvh = TriBVH(bvh=bvh._replace(leaf_prim=np.arange(n, dtype=np.int32)),
                     tri_order=np.asarray(bvh.leaf_prim, np.int32))
    return rope.make_kernel_bvh(bvh, tri_pos, device=device)


def intersect_scene(bvh, tri_pos, lights, o, d, t_min, t_max,
                    include_spheres=True, active=None) -> Hit:
    """Closest hit by the stackless rope walk (tpurt/bvh/traverse.py:57),
    through K3: the plain walk on CPU tensors, the CUDA kernel on CUDA
    tensors. `bvh` is a TriBVH (its own G), a plain LBVH over single
    triangles, or their rope tables (rope.KernelBVH, packed once by the
    caller: `tri_pos` is then unused). No mask column: alpha is resolved
    by the integrator's re-trace. A single-leaf tree (no internal node)
    tests its triangles directly, as tpurt does. Spheres are applied after
    the triangles. Inactive rays miss at t_max."""
    n = o.shape[0]
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=o.device)
    kb = _rope_tables(bvh, tri_pos, o.device)
    if kb.n_internal == 0:
        g = kb.group_size
        t, prim, u, v = _each_triangle(kb.tri_rows[0, :9 * g].reshape(g, 3, 3), kb.tri_order,
                                       o, d, t_min, t_max, active)
    else:
        t, prim, u, v = rope.traverse_packets(kb, o, d, t_min, t_max, active)
    kind = torch.where(prim >= 0, KIND_TRIANGLE, KIND_MISS).to(torch.int32)
    if include_spheres and lights.shape[0] > 0:
        t, prim, kind, _ = _apply_spheres(o, d, lights, t_min, t_max, active, t, prim, kind)
    return Hit(t=t, kind=kind, prim=prim, u=u, v=v)


def _each_triangle(tris, ids, o, d, t_min, t_max, active):
    """Every ray against the (K, 3, 3) triangles in order, strict t <
    t_best (the first of equal hits wins); prim is ids[k] (tpurt:105-117
    and :414)."""
    n = o.shape[0]
    t_best = torch.full((n,), float(np.float32(t_max)), dtype=torch.float32, device=o.device)
    prim = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    u_best = torch.zeros_like(t_best)
    v_best = torch.zeros_like(t_best)
    for k in range(tris.shape[0]):
        tri = tris[k:k + 1]
        hit, t, u, v = ray_triangle(o, d, tri[:, 0], tri[:, 1], tri[:, 2], t_min, t_best)
        hit = hit & active
        t_best = torch.where(hit, t, t_best)
        prim = torch.where(hit, ids[k].to(torch.int32), prim)
        u_best = torch.where(hit, u, u_best)
        v_best = torch.where(hit, v, v_best)
    return t_best, prim, u_best, v_best


def intersect_brute_force(tri_pos, lights, o, d, t_min, t_max, include_spheres=True) -> Hit:
    """Test oracle (tpurt/bvh/traverse.py:414): every ray against every
    triangle, in triangle order, then the spheres."""
    every = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    ids = torch.arange(tri_pos.shape[0], device=o.device)
    t, prim, u, v = _each_triangle(tri_pos, ids, o, d, t_min, t_max, every)
    kind = torch.where(prim >= 0, KIND_TRIANGLE, KIND_MISS).to(torch.int32)
    if include_spheres and lights.shape[0] > 0:
        t, prim, kind, _ = _apply_spheres(o, d, lights, t_min, t_max, every, t, prim, kind)
    return Hit(t=t, kind=kind, prim=prim, u=u, v=v)


def _octant_morton_key(kbvh, o, d, active, ray_class=None):
    """Sort key, most significant first: ray class (1b, optional) |
    octant (3b) | origin Morton high (12b) | direction Morton (6b) |
    origin Morton low (9b). Inactive rays sort to the back."""
    octant = ((d[:, 0] < 0).long() * 4 + (d[:, 1] < 0).long() * 2
              + (d[:, 2] < 0).long())
    root_lo, root_hi = kbvh.root_bounds()
    extent = torch.clamp(root_hi - root_lo, min=1e-20)
    m = morton3((o - root_lo) / extent)
    dm = morton3((d + 1.0) * 0.5)
    hi = m >> 18
    lo = (m >> 9) & 0x1FF
    key = (octant << 27) | (hi << 15) | (((dm >> 24) & 0x3F) << 9) | lo
    if ray_class is not None:
        key = key | (ray_class.long() << 30)
    return torch.where(active, key, torch.full_like(key, 0x7FFFFFFF))


def _sort_rays(key, cols):
    """Stable sort of ray columns by `key`. Returns (order, sorted cols);
    `_unsort(order, outs)` restores the caller's order."""
    order = torch.sort(key, stable=True).indices
    return order, tuple(c[order] for c in cols)


def _unsort(order, cols):
    out = []
    for c in cols:
        r = torch.empty_like(c)
        r[order] = c
        out.append(r)
    return tuple(out)


def closest_hit(kbvh, lights, o, d, t_min, t_max,
                include_spheres=True, active=None, sort_rays=True,
                return_pending=False, policy: KernelPolicy = DEFAULT_KERNEL_POLICY):
    """Closest hit plus the analytic sphere lights: over the wide tables
    (K1, or K5 with `policy.octet_closest` walks), or by the rope walk
    over rope tables (`intersect_scene`, K3). With `return_pending`
    returns (Hit, pending): pending marks committed triangle hits that
    still need the host texture tap (None when the traversal ran no cell
    tests: `policy.cell_masks_closest` off, the wide tables without mask
    columns, and the rope walk; the caller then runs the full host alpha
    test)."""
    if isinstance(kbvh, rope.KernelBVH):
        hit = intersect_scene(kbvh, None, lights, o, d, t_min, t_max,
                              include_spheres=include_spheres, active=active)
        return (hit, None) if return_pending else hit
    if not isinstance(kbvh, wide.WideKernelBVH):
        raise TypeError(f"closest_hit needs device tables, not {type(kbvh).__name__}")
    n = o.shape[0]
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=o.device)
    cell_masks = return_pending and policy.cell_masks_closest
    kw = dict(cell_masks=cell_masks, octet=policy.octet_closest)
    if sort_rays and n > SORT_MIN_RAYS:
        key = _octant_morton_key(kbvh, o, d, active)
        order, (op, dp, tp, ap) = _sort_rays(key, (o, d, t_min, active))
        out = wide.traverse_packets(kbvh, op, dp, tp, t_max, ap, **kw)
        t, prim, u, v = _unsort(order, out[:4])
        pending = out[4] if cell_masks else None
        if pending is not None:
            (pending,) = _unsort(order, (pending,))
    else:
        out = wide.traverse_packets(kbvh, o, d, t_min, t_max, active, **kw)
        t, prim, u, v = out[:4]
        pending = out[4] if cell_masks else None
    kind = torch.where(prim >= 0, KIND_TRIANGLE, KIND_MISS).to(torch.int32)
    t = torch.where(prim >= 0, t, torch.full_like(t, float(t_max)))
    if include_spheres and lights.shape[0] > 0:
        t, prim, kind, s_hit = _apply_spheres(o, d, lights, t_min, t_max, active,
                                              t, prim, kind)
        if pending is not None:
            pending = pending & ~s_hit
    hit = Hit(t=t, kind=kind, prim=prim, u=u, v=v)
    return (hit, pending) if return_pending else hit


def occlusion_hit(kbvh, o, d, t_min, t_limit, active, scene_has_alpha: bool,
                  sort_rays=True, ray_class=None,
                  policy: KernelPolicy = DEFAULT_KERNEL_POLICY):
    """Occlusion over the wide tables (K2, or K5 with
    `policy.octet_occlusion` walks). Returns (blocked, Hit of the closest
    uncertain hit, kind TRIANGLE where one exists). Like tpurt's, it takes
    the wide tables only."""
    if not isinstance(kbvh, wide.WideKernelBVH):
        raise TypeError("occlusion_hit needs the wide tables; the rope path traces "
                        "shadow rays with closest_hit")
    n = o.shape[0]
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=o.device)
    if sort_rays and n > SORT_MIN_RAYS:
        key = _octant_morton_key(kbvh, o, d, active, ray_class)
        order, (op, dp, tp, tl, ap) = _sort_rays(key, (o, d, t_min, t_limit, active))
        out = wide.occlusion_packets(kbvh, op, dp, tp, tl, ap, scene_has_alpha,
                                     octet=policy.octet_occlusion)
        blocked, t, prim, u, v = _unsort(order, out)
    else:
        blocked, t, prim, u, v = wide.occlusion_packets(
            kbvh, o, d, t_min, t_limit, active, scene_has_alpha,
            octet=policy.octet_occlusion)
    kind = torch.where(prim >= 0, KIND_TRIANGLE, KIND_MISS).to(torch.int32)
    return blocked, Hit(t=t, kind=kind, prim=prim, u=u, v=v)
