"""The shading block of a wave on the card: S1 "shade and sample" and S2
"MIS and payload" (csrc/shade_wave.cu), bound through ctypes like the
traversal kernels.

integrator/wavefront.py::shade_nee_card runs S1, the shadow trace
(K2 with the alpha recheck, or K3 on the rope path) and S2; CPU tensors
take shade_nee_plain, the PyTorch functions the kernels fuse, which stay
the reference. Every constant reaches the kernels by value, rounded to
float32 on the host as the plain version rounds it (`shade_constants`),
so the shading block makes no copy from the host.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from tpurt_torch.kernels import bsdf as B
from tpurt_torch.kernels import cudalib

_LIB = "shade_wave"
_ARGTYPES = {name: cudalib.argtypes("pppp") for name in ("tpurt_shade_sample", "tpurt_shade_mis")}

# launches of S1 and S2; the plain version on CPU tensors does not count
LAUNCHES = {"shade_sample": 0, "shade_mis": 0}

# the kernels' Consts struct, in order
CONSTANT_NAMES = ("sky_r", "sky_g", "sky_b", "ray_offset", "rr_threshold", "eta_i", "eta_t",
                  "inv_eta_i", "inv_eta_t", "emissive_scale", "t_max", "nl1", "env_pdf2",
                  "inv_env_pdf", "pi", "two_pi", "four_pi", "inv_pi", "inv_2_sqrt_pi",
                  "inv_255", "inv_12_92", "inv_1_055")
# S1's per-lane values for S2: shading normal, hit point, emissive, alpha
AUX = 10


def shade_constants(cfg, num_lights: int) -> np.ndarray:
    """The kernels' constants as float32, each the float32 the plain
    version computes from the same double (a Python float torch rounds,
    np.float32, or recip32). _ENV_PDF = 1 / (2 pi) in doubles, as
    integrator/wavefront.py defines it."""
    env_pdf = 1.0 / (2.0 * B.PI)
    values = (*cfg.sky_color, cfg.ray_offset, cfg.rr_threshold, cfg.eta_i, cfg.eta_t,
              B.recip32(cfg.eta_i), B.recip32(cfg.eta_t), cfg.emissive_untextured_scale,
              cfg.t_max, float(num_lights + 1), env_pdf * env_pdf, B.recip32(env_pdf),
              B.PI, 2.0 * B.PI, 4.0 * B.PI, B.recip32(B.PI), B._INV_2_SQRT_PI, 1.0 / 255.0,
              B.recip32(12.92), B.recip32(1.055))
    return np.array([np.float32(v) for v in values], dtype=np.float32)


class WaveShade(NamedTuple):
    """The block's full-width outputs for a wave of n lanes; a lane left
    out of the block keeps its state and reads 0 in the rest."""

    state: torch.Tensor       # (n,) int64
    miss_inc: torch.Tensor    # (n,) int32
    local_l: torch.Tensor     # (n, 3)
    bounce_dir: torch.Tensor  # (n, 3)
    t_new: torch.Tensor       # (n,)
    killed: torch.Tensor      # (n,) bool
    new_o: torch.Tensor       # (n, 3)
    albedo: torch.Tensor      # (n, 3)
    fold_w: torch.Tensor      # (n,)


class Shadow(NamedTuple):
    """S1's shadow rays (m lanes folded, 2m otherwise: sample 1, then
    sample 2), with what _trace_shadow's sphere test gives them."""

    o: torch.Tensor          # (r, 3)
    d: torch.Tensor          # (r, 3)
    t_min: torch.Tensor      # (r,) zeros
    t_limit: torch.Tensor    # (r,) the sphere hit's t, else t_max
    active: torch.Tensor     # (r,) bool, all true
    ray_class: torch.Tensor  # (r,) int32: pick_env folded, the sample index otherwise
    s_hit: torch.Tensor      # (r,) bool
    s_id: torch.Tensor       # (r,) int32


class Sampled(NamedTuple):
    """S1's outputs: the wave's (local_l and miss_inc still 0), the shadow
    rays, and the per-lane values S2 reads."""

    wave: WaveShade
    shadow: Shadow
    aux: torch.Tensor        # (m, AUX) shading normal, hit point, emissive, alpha
    light: torch.Tensor      # (m,) int32 the picked light (nl picks the envmap)


def _library(dev):
    """The built library and the stream of `dev` to launch on."""
    if dev.type != "cuda":
        raise ValueError(f"the shading kernels run on CUDA tensors, got {dev}")
    return cudalib.load(_LIB, _ARGTYPES), torch.cuda.current_stream(dev).cuda_stream


def _call(fn, ptrs, ints, consts, stream, what):
    p = (ctypes.c_void_p * len(ptrs))(*ptrs)
    i = (ctypes.c_int * len(ints))(*ints)
    c = (ctypes.c_float * len(consts))(*consts.tolist())
    cudalib.launch_check(fn(ctypes.cast(p, ctypes.c_void_p), ctypes.cast(i, ctypes.c_void_p),
                            ctypes.cast(c, ctypes.c_void_p), stream), what)


def _checked(x, name, shape, dtype, dev):
    if x.device != dev:
        raise ValueError(f"{name} is on {x.device}, the wave is on {dev}")
    x = x.contiguous()
    cudalib.check(x, name, shape, dtype)
    return x


def shade_sample(scene, cfg, tex_flags, o, d, state, throughput, hit, si,
                 consts: np.ndarray) -> Sampled:
    """S1 over the lanes `si` of a wave of n lanes: shade_hit,
    nee_directions, bounce_sample, fold_mis_weight and the sphere test of
    the shadow rays, in the plain version's order. Launches on the current
    stream of the wave's card; returns before launching when `si` is
    empty."""
    dev = o.device
    n, m = o.shape[0], si.shape[0]
    nl = scene.lights.shape[0]
    fold = bool(cfg.fold_bsdf_mis)
    o = _checked(o, "o", (n, 3), torch.float32, dev)
    d = _checked(d, "d", (n, 3), torch.float32, dev)
    state = _checked(state, "state", (n,), torch.int64, dev)
    throughput = _checked(throughput, "throughput", (n,), torch.float32, dev)
    t = _checked(hit.t, "hit.t", (n,), torch.float32, dev)
    prim = _checked(hit.prim, "hit.prim", (n,), torch.int32, dev)
    hu = _checked(hit.u, "hit.u", (n,), torch.float32, dev)
    hv = _checked(hit.v, "hit.v", (n,), torch.float32, dev)
    si = _checked(si, "si", (m,), torch.int64, dev)
    rows = _checked(scene.tri_shade_row, "tri_shade_row", (scene.tri_shade_row.shape[0], 40),
                    torch.float32, dev)
    table = _checked(scene.tex_table, "tex_table", (scene.tex_table.shape[0], 10), torch.int32,
                     dev)
    quad = _checked(scene.atlas_quad, "atlas_quad", tuple(scene.atlas_quad.shape), torch.uint8,
                    dev)
    lights = _checked(scene.lights, "lights", (nl, 8), torch.float32, dev)
    if quad.data_ptr() % 16:
        raise ValueError("atlas_quad is not 16-byte aligned")
    flags = sum(1 << k for k, f in enumerate(tex_flags) if f) if table.shape[0] else 0

    # the wave's outputs: the state copied, every other array 0
    z = torch.zeros(14 * n, dtype=torch.float32, device=dev)
    wave = WaveShade(state=state.clone(), miss_inc=torch.zeros(n, dtype=torch.int32, device=dev),
                     local_l=z[0:3 * n].view(n, 3), bounce_dir=z[3 * n:6 * n].view(n, 3),
                     t_new=z[12 * n:13 * n], killed=torch.zeros(n, dtype=torch.bool, device=dev),
                     new_o=z[6 * n:9 * n].view(n, 3), albedo=z[9 * n:12 * n].view(n, 3),
                     fold_w=z[13 * n:14 * n])
    r = m if fold else 2 * m
    f = torch.empty(8 * r + AUX * m, dtype=torch.float32, device=dev)
    i32 = torch.empty(2 * r + m, dtype=torch.int32, device=dev)
    b = torch.empty(2 * r, dtype=torch.bool, device=dev)
    shadow = Shadow(o=f[0:3 * r].view(r, 3), d=f[3 * r:6 * r].view(r, 3), t_min=f[6 * r:7 * r],
                    t_limit=f[7 * r:8 * r], active=b[0:r], ray_class=i32[0:r],
                    s_hit=b[r:2 * r], s_id=i32[r:2 * r])
    out = Sampled(wave=wave, shadow=shadow, aux=f[8 * r:].view(m, AUX), light=i32[2 * r:])
    if m == 0:
        return out
    lib, stream = _library(dev)
    ptrs = [x.data_ptr() for x in (si, o, d, state, throughput, t, prim, hu, hv, rows, table,
                                   quad, lights, wave.state, wave.bounce_dir, wave.t_new,
                                   wave.killed, wave.new_o, wave.albedo, wave.fold_w,
                                   *shadow, out.aux, out.light)]
    ints = [m, rows.shape[0], table.shape[0], quad.shape[0], quad.shape[1], nl, flags, int(fold)]
    _call(lib.tpurt_shade_sample, ptrs, ints, consts, stream, "shade_sample")
    LAUNCHES["shade_sample"] += 1
    return out


def shade_mis(scene, cfg, d, throughput, si, s1: Sampled, blocked, consts: np.ndarray) -> WaveShade:
    """S2: the shadow payload from the trace's `blocked`, the MIS weights
    and the emissive term, written into S1's local_l and miss_inc at the
    lanes `si`. Returns the wave's outputs."""
    dev = d.device
    n, m = d.shape[0], si.shape[0]
    if m == 0:
        return s1.wave
    r = s1.shadow.o.shape[0]
    d = _checked(d, "d", (n, 3), torch.float32, dev)
    throughput = _checked(throughput, "throughput", (n,), torch.float32, dev)
    si = _checked(si, "si", (m,), torch.int64, dev)
    blocked = _checked(blocked, "blocked", (r,), torch.bool, dev)
    lights = _checked(scene.lights, "lights", (scene.lights.shape[0], 8), torch.float32, dev)
    lib, stream = _library(dev)
    sh = s1.shadow
    ptrs = [x.data_ptr() for x in (si, d, throughput, lights, sh.d, sh.s_hit, sh.s_id, blocked,
                                   s1.aux, s1.light, s1.wave.local_l, s1.wave.miss_inc)]
    ints = [m, lights.shape[0], int(bool(cfg.fold_bsdf_mis))]
    _call(lib.tpurt_shade_mis, ptrs, ints, consts, stream, "shade_mis")
    LAUNCHES["shade_mis"] += 1
    return s1.wave
