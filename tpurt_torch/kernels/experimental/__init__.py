"""Kernels kept beside the main path (the counterpart of
tpurt/kernels/experimental/).

- `rope`: the binary rope-link traversal (K3 closest hit, K4 occlusion),
  one CUDA source, csrc/rope_traverse.cu. tpurt keeps its Pallas
  version as an independently written cross-check of the wide kernel;
  the port keeps it for the same reason (chip_smoke.py holds K3 against
  K1 and K4 against K2 on the same rays), and it also serves the rope
  render path: `Renderer(bvh=<TriBVH>)` and scenes whose leaves do not
  fit the wide leaf row trace through K3 (bvh/traverse.py::intersect_scene).
"""
