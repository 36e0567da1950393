"""Per-ray maths (intersection, BSDF, lights, textures) and the wide-BVH
traversal with its CUDA kernel."""
