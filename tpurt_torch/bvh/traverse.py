"""Closest-hit and occlusion dispatch over the wide tables (the
counterpart of tpurt/bvh/traverse.py's closest_hit / occlusion_hit).

Above 2048 rays the rays are sorted by an (octant, origin Morton,
direction Morton) key before the traversal and the results are put
back in the caller's order, as tpurt does; tpurt's variadic `lax.sort`
becomes a stable `torch.sort` plus gathers. The sort changes which rays
share a warp, never a ray's result. tpurt's binary rope walk
(`intersect_scene`) and the brute-force oracle come in a later slice.
"""

from __future__ import annotations

import torch

from tpurt_torch.bvh.lbvh import morton3
from tpurt_torch.kernels import wide
from tpurt_torch.kernels.intersect import (
    Hit,
    KIND_MISS,
    KIND_SPHERE,
    KIND_TRIANGLE,
    intersect_spheres,
)

SORT_MIN_RAYS = 2048


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
                return_pending=False):
    """Closest hit over the wide tables (K1) plus the analytic sphere
    lights. With `return_pending` returns (Hit, pending): pending marks
    committed triangle hits that still need the host texture tap (None
    when the leaf rows carry no cell masks)."""
    n = o.shape[0]
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=o.device)
    if sort_rays and n > SORT_MIN_RAYS:
        key = _octant_morton_key(kbvh, o, d, active)
        order, (op, dp, tp, ap) = _sort_rays(key, (o, d, t_min, active))
        out = wide.traverse_packets(kbvh, op, dp, tp, t_max, ap,
                                    cell_masks=return_pending)
        t, prim, u, v = _unsort(order, out[:4])
        pending = out[4] if return_pending else None
        if pending is not None:
            (pending,) = _unsort(order, (pending,))
    else:
        out = wide.traverse_packets(kbvh, o, d, t_min, t_max, active,
                                    cell_masks=return_pending)
        t, prim, u, v = out[:4]
        pending = out[4] if return_pending else None
    kind = torch.where(prim >= 0, KIND_TRIANGLE, KIND_MISS).to(torch.int32)
    t = torch.where(prim >= 0, t, torch.full_like(t, float(t_max)))
    if include_spheres and lights.shape[0] > 0:
        s_hit, s_t, s_id = intersect_spheres(o, d, lights, t_min, t_max)
        s_hit = s_hit & active & (s_t < t)
        t = torch.where(s_hit, s_t, t)
        prim = torch.where(s_hit, s_id, prim)
        kind = torch.where(s_hit, torch.full_like(kind, KIND_SPHERE), kind)
        if pending is not None:
            pending = pending & ~s_hit
    hit = Hit(t=t, kind=kind, prim=prim, u=u, v=v)
    return (hit, pending) if return_pending else hit


def occlusion_hit(kbvh, o, d, t_min, t_limit, active, scene_has_alpha: bool,
                  sort_rays=True, ray_class=None):
    """Occlusion over the wide tables (K2). Returns (blocked, Hit of the
    closest uncertain hit, kind TRIANGLE where one exists)."""
    n = o.shape[0]
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=o.device)
    if sort_rays and n > SORT_MIN_RAYS:
        key = _octant_morton_key(kbvh, o, d, active, ray_class)
        order, (op, dp, tp, tl, ap) = _sort_rays(key, (o, d, t_min, t_limit, active))
        out = wide.occlusion_packets(kbvh, op, dp, tp, tl, ap, scene_has_alpha)
        blocked, t, prim, u, v = _unsort(order, out)
    else:
        blocked, t, prim, u, v = wide.occlusion_packets(
            kbvh, o, d, t_min, t_limit, active, scene_has_alpha)
    kind = torch.where(prim >= 0, KIND_TRIANGLE, KIND_MISS).to(torch.int32)
    return blocked, Hit(t=t, kind=kind, prim=prim, u=u, v=v)
