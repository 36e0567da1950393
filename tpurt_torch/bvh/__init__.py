"""Acceleration structures: the host BVH build and the traversal
dispatch over the wide tables."""
