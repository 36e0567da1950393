"""tpurt_torch — the PyTorch/CUDA port of tpurt.

The same progressive path tracer as `tpurt/`, written for an NVIDIA
Hopper card: plain tensor code is PyTorch, and the traversal kernels are
hand-written CUDA C++, built with nvcc on first use and bound through
ctypes: closest hit and occlusion over the 16-ary wide BVH
(`csrc/wide_traverse.cu`, the default render path), the multi-walk
variant of the wide walk (`csrc/wide_octet.cu`, selected by
`RenderConfig(kernel=KernelPolicy(octet_closest=N, octet_occlusion=N))`),
over the binary rope BVH (`csrc/rope_traverse.cu`, the rope path,
`Renderer(bvh=<TriBVH>)`), and a step-cost instrument of the wide walk
(`csrc/wide_stepcost.cu`, run by `python -m tpurt_torch.kernel_bench`).

Module names mirror `tpurt/` so each module's counterpart is easy to
find. Entry points take a `device` argument that defaults to "cuda";
asking for "cuda" on a machine without a card raises instead of
falling back to the CPU. The CPU runs only when the caller asks for it
(the tests do), and then every kernel wrapper takes its plain PyTorch
version.
"""

from tpurt_torch.config import DEFAULT_SPONZA_LIGHTS, KernelPolicy, RenderConfig, SphereLight
from tpurt_torch.camera import Camera

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "KernelPolicy",
    "SphereLight",
    "DEFAULT_SPONZA_LIGHTS",
    "Camera",
    "Renderer",
    "__version__",
]


def __getattr__(name):
    if name == "Renderer":
        from tpurt_torch.renderer import Renderer

        return Renderer
    raise AttributeError(name)
