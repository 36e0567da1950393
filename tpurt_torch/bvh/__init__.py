"""Acceleration structures: the triangle BVH builds (native host, or on
the device) and the traversal dispatch over the wide and rope tables."""

from tpurt_torch.bvh.lbvh import (
    LBVH,
    TriBVH,
    build_lbvh,
    build_triangle_bvh,
    morton3,
    triangle_aabbs,
    validate_lbvh,
)

__all__ = [
    "LBVH",
    "TriBVH",
    "build_lbvh",
    "build_triangle_bvh",
    "morton3",
    "triangle_aabbs",
    "validate_lbvh",
    "intersect_brute_force",
    "intersect_scene",
]


def __getattr__(name):
    # bvh/traverse.py imports the kernel modules, which import bvh/lbvh.py
    # through this package, so its names load on first use
    if name in ("intersect_brute_force", "intersect_scene"):
        from tpurt_torch.bvh import traverse

        return getattr(traverse, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
