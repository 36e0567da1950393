"""Render configuration: the one config surface for every constant the
reference hard-codes (the counterpart of tpurt/config.py).

Reference sources for the defaults are cited in tpurt/config.py; the
values here are the same. `KernelPolicy` keeps the fields of tpurt's that
change what the card does (the camera-wave sort, the in-kernel cell
masks of closest traces, the multi-walk kernel K5); its TPU step
variants and budgets have no counterpart (see its docstring). tpurt's
compaction knobs (`shade_frac`, `retrace_frac`, `compact_ladder`,
`*_gather`) have no counterpart either: they never changed a rendered
value, and the port compacts with dynamic sizes instead
(integrator/wavefront.py). tpurt's `samples_per_launch` and `t_min` are
left out too: nothing reads them (`spp_per_launch` sets the samples per
launch, and every trace starts at t = 0).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SphereLight:
    """A sphere area light: position + radius, rgb color + intensity."""

    position: Tuple[float, float, float]
    radius: float
    color: Tuple[float, float, float]
    intensity: float


# The three hard-coded lights of the reference composition root.
DEFAULT_SPONZA_LIGHTS = (
    SphereLight((-8.3395, -5.76978, -2.3374), 0.1, (0.8, 0.6, 0.6), 500.0),
    SphereLight((8.9656, -5.76978, -2.6374), 0.1, (0.4, 0.7, 0.6), 500.0),
    SphereLight((155.73348522, -1000.92734623, 140.05059690), 50.0, (0.9, 0.9, 0.7), 1000.0),
)


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Traversal-kernel policy, with tpurt's defaults
    (tpurt/config.py:KernelPolicy). Read per closest/occlusion dispatch:

    - sort_wave0: octant-Morton sort the camera wave too (the integrator's
      `sort_rays=` of wave 0).
    - cell_masks_closest: run the in-kernel decided-cell alpha tests in
      closest traces that ask for `pending` (bvh/traverse.py).
    - octet_closest / octet_occlusion: 0 runs K1 / K2; N in (2, 4, 8) runs
      the multi-walk kernel K5 with each 1024-ray packet split into N
      walks of 1024/N rays (kernels/wide.py).

    tpurt's other fields have no counterpart, and passing one is a
    TypeError: `sort_retrace` (the port always compacts its re-traces,
    which tpurt sorts by the same key), the TPU step variants `pair_*`,
    `dual_*`, `descend_*`, `sup_*`, `sumcol` and `unroll`, and the build
    fields `arity` and `resident_budget_mb` (a VMEM budget).
    convert.policy_from_tpurt carries a tpurt policy across."""

    sort_wave0: bool = False
    cell_masks_closest: bool = True
    octet_closest: int = 0
    octet_occlusion: int = 0


DEFAULT_KERNEL_POLICY = KernelPolicy()


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All render-time knobs. Field defaults replicate the reference."""

    width: int = 640
    height: int = 480
    max_samples: int = 1024
    exposure: float = 3.0
    fov_degrees: float = 45.0
    max_depth: int = 7
    t_max: float = 999999999.0
    ray_offset: float = 0.01
    rr_threshold: float = 0.995
    sky_color: Tuple[float, float, float] = (0.4, 0.5, 0.6)
    eta_i: float = 1.0
    eta_t: float = 1.5
    emissive_untextured_scale: float = 200.0
    # cap on alpha re-traces per ray (the reference's any-hit can skip any
    # number of surfaces; tpurt caps it, and so does the port)
    max_alpha_skips: int = 8
    seed: int = 0
    # render each progressive sample in row bands of this height
    # (0 = whole frame at once); bounds the wavefront state memory
    chunk_rows: int = 0
    # samples per pixel traced in one launch
    spp_per_launch: int = 1
    # fold the BSDF-MIS sample into the bounce ray (see tpurt/config.py)
    fold_bsdf_mis: bool = True
    # traversal-kernel policy (K1/K2 or the multi-walk K5, sorts, masks)
    kernel: KernelPolicy = DEFAULT_KERNEL_POLICY

    @property
    def tan_half_fov(self) -> float:
        return math.tan(math.radians(self.fov_degrees) / 2.0)
