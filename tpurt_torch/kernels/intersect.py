"""Ray-primitive intersection math over flat ray arrays (the counterpart
of tpurt/kernels/intersect.py): Moller-Trumbore triangles with the
Vulkan barycentric convention, the reference's q-form sphere test, the
AABB slab test, and the safe reciprocal direction used by the slab
tests."""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpurt_torch.kernels.bsdf import _cross, _dot, sqrt_rn

KIND_MISS = 0
KIND_TRIANGLE = 1
KIND_SPHERE = 2


class Hit(NamedTuple):
    t: torch.Tensor     # (N,) f32 hit distance (t_max on a miss)
    kind: torch.Tensor  # (N,) i32 KIND_*
    prim: torch.Tensor  # (N,) i32 triangle id or light id
    u: torch.Tensor     # (N,) f32 barycentric u
    v: torch.Tensor     # (N,) f32 barycentric v


def ray_triangle(o, d, v0, v1, v2, t_min, t_max):
    """Batched Moller-Trumbore, no culling. Returns (hit, t, u, v)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, torch.reciprocal(torch.where(ok, det, torch.ones_like(det))),
                          torch.zeros_like(det))
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max)
    return hit, t, u, v


def ray_triangle_rows(tri, ox, oy, oz, dx, dy, dz):
    """Moller-Trumbore on rays given as x/y/z columns against (N, 9) rows
    [v0, v1, v2], in the expression order of the traversal kernels (their
    CUDA versions repeat it operation for operation, built without fused
    multiply-adds, so t is bit-equal). Returns (ok, u, v, t): ok is
    |det| > 1e-12; the caller applies the range tests."""
    v0x, v0y, v0z = tri[:, 0], tri[:, 1], tri[:, 2]
    e1x, e1y, e1z = tri[:, 3] - v0x, tri[:, 4] - v0y, tri[:, 5] - v0z
    e2x, e2y, e2z = tri[:, 6] - v0x, tri[:, 7] - v0y, tri[:, 8] - v0z
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, torch.reciprocal(torch.where(ok, det, torch.ones_like(det))),
                          torch.zeros_like(det))
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    return ok, u, v, t


def mask_cell(u, v):
    """The 4x4 alpha-mask cell of barycentrics (u, v): cu * 4 + cv. The
    clamps before the cast keep lanes outside [0, 1] defined; only hit
    lanes read the cell."""
    cu = torch.clamp(torch.clamp(u * 4.0, 0.0, 4.0).to(torch.int32), 0, 3)
    cv = torch.clamp(torch.clamp(v * 4.0, 0.0, 4.0).to(torch.int32), 0, 3)
    return cu * 4 + cv


def ray_sphere_reference(o, d, center, radius, t_min, t_max):
    """The reference's sphere test (raytrace.rint:5-22) with its q-form
    that omits the 1/2 factors. Returns (hit, t)."""
    cto = o - center
    b = _dot(d, cto)
    c = _dot(cto, cto) - radius * radius
    b2 = 2.0 * b
    disc = b2 * b2 - 4.0 * c
    sqrt_disc = sqrt_rn(torch.clamp(disc, min=0.0))
    q = torch.where(b > 0.0, -b - sqrt_disc, -b + sqrt_disc)
    q_safe = torch.where(q == 0.0, torch.full_like(q, 1e-20), q)
    t = torch.minimum(q, c / q_safe)
    hit = (disc >= 0.0) & (t > t_min) & (t < t_max)
    return hit, t


def intersect_spheres(o, d, lights, t_min, t_max):
    """Closest sphere-light hit over the (L, 8) lights. Returns
    (hit (N,), t (N,), light id (N,) int32)."""
    n = o.shape[0]
    num = lights.shape[0]
    if num == 0:
        return (torch.zeros(n, dtype=torch.bool, device=o.device),
                torch.full((n,), float("inf"), dtype=torch.float32, device=o.device),
                torch.zeros(n, dtype=torch.int32, device=o.device))
    ts = []
    for i in range(num):
        hit, t = ray_sphere_reference(o, d, lights[i, :3], lights[i, 3], t_min, t_max)
        ts.append(torch.where(hit, t, torch.full_like(t, float("inf"))))
    ts = torch.stack(ts, dim=0)
    t_best, best = torch.min(ts, dim=0)
    return torch.isfinite(t_best), t_best, best.to(torch.int32)


def ray_aabb(o, inv_d, box_min, box_max, t_min, t_max):
    """Slab test over (N, 3) boxes (tpurt/kernels/intersect.py:105), in
    tpurt's expression order. Returns (hit, entry distance)."""
    t0 = (box_min - o) * inv_d
    t1 = (box_max - o) * inv_d
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    t_near = torch.maximum(torch.amax(tn, dim=-1), torch.as_tensor(t_min).to(tn))
    t_far = torch.minimum(torch.amin(tf, dim=-1), torch.as_tensor(t_max).to(tf))
    return t_near <= t_far, t_near


def safe_inv_dir(d):
    """sign(d) / max(|d|, 1e-20): a reciprocal without inf."""
    sign = torch.where(d >= 0.0, torch.ones_like(d), -torch.ones_like(d))
    return sign / torch.clamp(torch.abs(d), min=1e-20)
