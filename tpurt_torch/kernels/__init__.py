"""Per-ray maths (intersection, BSDF, lights, textures) and the wide-BVH
traversal with its CUDA kernel. The package exports tpurt's intersection
API (tpurt/kernels/__init__.py); importing it builds nothing."""

from tpurt_torch.kernels.intersect import (
    Hit,
    KIND_MISS,
    KIND_SPHERE,
    KIND_TRIANGLE,
    intersect_spheres,
    ray_aabb,
    ray_sphere_reference,
    ray_triangle,
    safe_inv_dir,
)

__all__ = [
    "Hit",
    "KIND_MISS",
    "KIND_SPHERE",
    "KIND_TRIANGLE",
    "intersect_spheres",
    "ray_aabb",
    "ray_sphere_reference",
    "ray_triangle",
    "safe_inv_dir",
]
