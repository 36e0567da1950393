"""Wavefront path integrator (the counterpart of
tpurt/integrator/wavefront.py).

The reference's recursive ray-tracing megakernel becomes a loop over
bounce waves on flat per-ray state; every quirk tpurt replicates (cull
masks, the NEE/MIS estimator and its alpha clamps, the depth++-on-miss
of rmiss, Russian roulette discarding the whole hit, the 0.01 offsets,
the alpha-tested any-hit via re-trace) is kept, with the same RNG draw
order, so per-ray results match tpurt's.

Control flow. tpurt's `lax.cond` / `lax.while_loop` with data-dependent
predicates are Python control flow here (each `.any()` is one host
sync). tpurt's fixed-capacity compaction (`retrace_frac`, `shade_frac`,
`compact_ladder`) existed to keep XLA shapes static; the port compacts
with dynamic sizes instead: a wave traces only the rays that are live,
shades only the rays that hit a triangle, and an alpha re-trace or
texture recheck runs only on the rays that need it. Every step is
per-lane, and a lane that is left out is one whose result tpurt masks
away, so the rendered values are unchanged.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from tpurt_torch import rng
from tpurt_torch.bvh.traverse import closest_hit, occlusion_hit
from tpurt_torch.camera import Camera, camera_rays_for_rows
from tpurt_torch.config import RenderConfig
from tpurt_torch.kernels import bsdf as B
from tpurt_torch.kernels.bsdf import _dot, _norm
from tpurt_torch.kernels.intersect import (
    Hit,
    KIND_MISS,
    KIND_TRIANGLE,
    intersect_spheres,
    mask_cell,
)
from tpurt_torch.kernels.lights import pdf_sphere, sample_hemisphere_uniform, sample_sphere
from tpurt_torch.kernels.texture import sample_texture_alpha_quad, sample_texture_quad
from tpurt_torch.kernels.wide import WideKernelBVH
from tpurt_torch.scene.device import DeviceScene
from tpurt_torch.scene.types import NO_TEXTURE
from tpurt_torch.utils.profiling import annotate

_ENV_PDF = 1.0 / (2.0 * B.PI)


class RayStats(NamedTuple):
    """Ray counts of a frame: `physical` = rays traced (the Mrays/s
    numerator); `logical` = rays the reference would dispatch."""

    logical: float
    physical: float


def _nz(mask: torch.Tensor) -> torch.Tensor:
    return torch.nonzero(mask, as_tuple=True)[0]


def _scatter(full: torch.Tensor, idx: torch.Tensor, part: torch.Tensor) -> torch.Tensor:
    out = full.clone()
    out[idx] = part
    return out


def _miss_hit(n, t_max, device) -> Hit:
    return Hit(t=torch.full((n,), float(np.float32(t_max)), dtype=torch.float32, device=device),
               kind=torch.full((n,), KIND_MISS, dtype=torch.int32, device=device),
               prim=torch.full((n,), -1, dtype=torch.int32, device=device),
               u=torch.zeros(n, dtype=torch.float32, device=device),
               v=torch.zeros(n, dtype=torch.float32, device=device))


def _hit_scatter(base: Hit, idx, part: Hit) -> Hit:
    return Hit(*(_scatter(x, idx, y) for x, y in zip(base, part)))


# ---- alpha-tested any-hit ---------------------------------------------------

def _alpha_eval(scene: DeviceScene, u, v, prim, tested) -> torch.Tensor:
    """Exact any-hit alpha test: decided 4x4 cells answer from the fused
    alpha row; the texture tap runs only on undecided cells."""
    row = scene.tri_alpha_row[prim.long()]
    cell = mask_cell(u, v)
    tbit = (row[:, 9].to(torch.int32) >> cell) & 1
    obit = (row[:, 10].to(torch.int32) >> cell) & 1
    undecided = tested & (tbit == 0) & (obit == 0)
    by_tap = torch.zeros_like(tested)
    ui = _nz(undecided)
    if ui.numel():
        r, uu, vv = row[ui], u[ui], v[ui]
        w0 = 1.0 - uu - vv
        uv_u = w0 * r[:, 3] + uu * r[:, 5] + vv * r[:, 7]
        uv_v = w0 * r[:, 4] + uu * r[:, 6] + vv * r[:, 8]
        tex = r[:, 2].to(torch.int32)
        a = sample_texture_alpha_quad(scene.atlas_quad, scene.tex_table, tex, uv_u, uv_v)
        a = torch.where(tex == NO_TEXTURE, torch.ones_like(a), a)
        by_tap[ui] = a < r[:, 1]
    return (tested & (tbit == 1)) | by_tap


def _alpha_rejected(scene: DeviceScene, h: Hit, mask, pending=None) -> torch.Tensor:
    """True where a committed hit must be ignored (albedo alpha below the
    cutoff). `pending`, when the traversal ran its cell tests, already
    says which lanes need the tap. Only those lanes are evaluated."""
    is_tri = h.kind == KIND_TRIANGLE
    prim = torch.clamp(h.prim, 0, scene.tri_pos.shape[0] - 1)
    if pending is None:
        tested = mask & is_tri & scene.tri_alpha[prim.long()]
    else:
        tested = mask & pending
    out = torch.zeros_like(tested)
    idx = _nz(tested)
    if idx.numel():
        out[idx] = _alpha_eval(scene, h.u[idx], h.v[idx], prim[idx], tested[idx])
    return out


def _retrace_tmin(t):
    """t_min just past a rejected hit: t * (1 + 1e-6) + 1e-5."""
    return t * float(np.float32(1.0 + 1e-6)) + float(np.float32(1e-5))


def _trace(scene, bvh, o, d, t_min0, active, include_spheres, cfg: RenderConfig,
           has_alpha: bool, sort_rays: bool = True) -> Hit:
    """Closest hit with the alpha re-trace loop (the reference's any-hit):
    a rejected hit is re-traced from just past it, up to
    cfg.max_alpha_skips times."""
    hit, pending = closest_hit(bvh, scene.lights, o, d, t_min0,
                               cfg.t_max, include_spheres=include_spheres,
                               active=active, sort_rays=sort_rays,
                               return_pending=True, policy=cfg.kernel)
    if not has_alpha:
        return hit
    use_pending = pending is not None
    with annotate("alpha_retrace"):
        rej = _alpha_rejected(scene, hit, active, pending)
        t_min = t_min0
        for _ in range(cfg.max_alpha_skips):
            if not bool(rej.any()):
                break
            t_min = torch.where(rej, _retrace_tmin(hit.t), t_min)
            idx = _nz(rej)
            nh, npend = closest_hit(bvh, scene.lights, o[idx], d[idx],
                                    t_min[idx], cfg.t_max, include_spheres=include_spheres,
                                    active=torch.ones_like(idx, dtype=torch.bool),
                                    sort_rays=sort_rays, return_pending=True,
                                    policy=cfg.kernel)
            hit = _hit_scatter(hit, idx, nh)
            pend_full = None
            if use_pending:
                pend_full = torch.zeros_like(rej)
                pend_full[idx] = npend
            rej = _alpha_rejected(scene, hit, rej, (rej & pend_full) if use_pending else None)
    return hit


def _trace_shadow(scene, bvh, o, d, active, throughput, cfg: RenderConfig,
                  has_alpha: bool, ray_class=None):
    """NEE shadow resolution plus the analytic sphere lights. Over the
    wide tables it is an occlusion query (K2) with the exact alpha recheck
    and occlusion re-trace past texture-rejected hits; on the rope path a
    full closest-hit trace (K3) with the alpha re-trace, as in tpurt.
    Returns (rgb (N, 3), alpha code (N,), is_miss (N,)) in the
    reference's payload protocol."""
    n = o.shape[0]
    dev = o.device
    t_min0 = torch.zeros(n, dtype=torch.float32, device=dev)
    t_max = float(np.float32(cfg.t_max))
    if scene.lights.shape[0] > 0:
        with annotate("shadow_spheres"):
            s_hit, s_t, s_id = intersect_spheres(o, d, scene.lights, t_min0, t_max)
            s_hit = s_hit & active
    else:
        s_hit = torch.zeros(n, dtype=torch.bool, device=dev)
        s_t = torch.full((n,), t_max, dtype=torch.float32, device=dev)
        s_id = torch.zeros(n, dtype=torch.int32, device=dev)
    t_limit = torch.where(s_hit, s_t, torch.full_like(s_t, t_max))
    if isinstance(bvh, WideKernelBVH):
        if ray_class is None:
            ray_class = (torch.arange(n, device=dev) >= (n // 2)).to(torch.int32)
        blocked, hit = occlusion_hit(bvh, o, d, t_min0, t_limit, active, has_alpha,
                                     ray_class=ray_class, policy=cfg.kernel)
        if has_alpha:
            with annotate("occl_recheck"):
                unc = active & ~blocked & (hit.prim >= 0)
                # with mask columns, the kernel's uncertain lanes are exactly the
                # alpha-testable undecided-cell hits: `unc` doubles as pending
                kernel_masks = bvh.use_masks
                rej = _alpha_rejected(scene, hit, unc, unc if kernel_masks else None)
                blocked = blocked | (unc & ~rej)
                t_min = t_min0
                for _ in range(cfg.max_alpha_skips):
                    if not bool(rej.any()):
                        break
                    t_min = torch.where(rej, _retrace_tmin(hit.t), t_min)
                    idx = _nz(rej)
                    b_c, h_c = occlusion_hit(bvh, o[idx], d[idx], t_min[idx], t_limit[idx],
                                             torch.ones_like(idx, dtype=torch.bool),
                                             has_alpha, policy=cfg.kernel)
                    b2 = torch.zeros_like(rej)
                    b2[idx] = b_c
                    hit = _hit_scatter(hit, idx, h_c)
                    unc2 = rej & ~b2 & (hit.prim >= 0)
                    rej2 = _alpha_rejected(scene, hit, unc2, unc2 if kernel_masks else None)
                    blocked = blocked | (rej & b2) | (unc2 & ~rej2)
                    rej = rej2
                # re-trace cap reached: the rejected hit stays a surface (black)
                blocked = blocked | rej
    else:
        # the rope path (tpurt:486-490): a full closest-hit trace with the
        # alpha re-trace; <= commits a surface tied with the sphere, as the
        # closest-hit formulation does (s_hit needed s_t < t)
        hit = _trace(scene, bvh, o, d, t_min0, active, False, cfg, has_alpha,
                     sort_rays=False)
        blocked = active & (hit.kind == KIND_TRIANGLE) & (hit.t <= t_limit)

    with annotate("shadow_payload"):
        sky = torch.tensor(cfg.sky_color, dtype=torch.float32, device=dev)
        if scene.lights.shape[0] > 0:
            light = scene.lights[torch.clamp(s_id, 0, scene.lights.shape[0] - 1).long()]
            light_rgb = light[:, 4:7] * light[:, 7:8] * throughput[:, None]
        else:
            light_rgb = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        sky_rgb = sky[None, :] * throughput[:, None]
        hit_sphere = s_hit & ~blocked
        is_miss = active & ~blocked & ~s_hit
        rgb = torch.where(blocked[:, None], torch.zeros_like(sky_rgb),
                          torch.where(hit_sphere[:, None], light_rgb, sky_rgb))
        a = torch.where(blocked, torch.ones_like(t_limit),
                        torch.where(hit_sphere, torch.zeros_like(t_limit),
                                    torch.full_like(t_limit, -4.0)))
    return rgb, a, is_miss


# ---- shading ----------------------------------------------------------------

class Shade(NamedTuple):
    hit_point: torch.Tensor  # (N, 3)
    shading_n: torch.Tensor  # (N, 3)
    albedo: torch.Tensor     # (N, 3)
    emissive: torch.Tensor   # (N, 3)
    alpha: torch.Tensor      # (N,) Beckmann alpha


def _bary(w0, w1, w2, verts):
    """Barycentric interpolation over (N, 3, C) vertex attributes, summed
    in vertex order."""
    return w0[:, None] * verts[:, 0] + w1[:, None] * verts[:, 1] + w2[:, None] * verts[:, 2]


def _unit(v):
    return v / torch.clamp(_norm(v), min=1e-20)[:, None]


def shade_hit(scene: DeviceScene, cfg: RenderConfig, tex_flags, o, d, hit: Hit) -> Shade:
    """Hit-attribute interpolation + material/texture evaluation from the
    fused (T, 40) shading row (see scene/device.py)."""
    with annotate("shade_attrs"):
        prim = torch.clamp(hit.prim, 0, scene.tri_pos.shape[0] - 1).long()
        srow = scene.tri_shade_row[prim]
        w0 = 1.0 - hit.u - hit.v
        uv = _bary(w0, hit.u, hit.v, srow[:, 0:6].reshape(-1, 3, 2))
        normal = _unit(_bary(w0, hit.u, hit.v, srow[:, 6:15].reshape(-1, 3, 3)))
        if tex_flags[2]:
            tangent4 = _bary(w0, hit.u, hit.v, srow[:, 15:27].reshape(-1, 3, 4))
            tangent = _unit(tangent4[:, :3])
        hit_point = o + hit.t[:, None] * d
        mat_emissive = srow[:, 32:35]

    with annotate("textures"):
        albedo = srow[:, 27:30]
        if tex_flags[0]:
            tex_a = srow[:, 35].to(torch.int32)
            texel_a = sample_texture_quad(scene.atlas_quad, scene.tex_table, tex_a,
                                          uv[:, 0], uv[:, 1])
            albedo = torch.where((tex_a != NO_TEXTURE)[:, None], albedo * texel_a[:, :3], albedo)

        shading_n = normal
        if tex_flags[2]:
            tex_n = srow[:, 37].to(torch.int32)
            nf = srow[:, 31]
            texel_n = sample_texture_quad(scene.atlas_quad, scene.tex_table, tex_n,
                                          uv[:, 0], uv[:, 1])
            nm = (texel_n[:, :3] * 2.0 - 1.0) * nf[:, None]
            bitangent = B._cross(normal, tangent) * tangent4[:, 3:4]
            mapped = nm[:, 0:1] * tangent + nm[:, 1:2] * bitangent + nm[:, 2:3] * normal
            mapped = _unit(mapped)
            use_nm = (tex_n != NO_TEXTURE) & (torch.abs(nf) > 0.001)
            shading_n = torch.where(use_nm[:, None], mapped, normal)

        emissive = mat_emissive * float(np.float32(cfg.emissive_untextured_scale))
        if tex_flags[3]:
            tex_e = srow[:, 38].to(torch.int32)
            texel_e = sample_texture_quad(scene.atlas_quad, scene.tex_table, tex_e,
                                          uv[:, 0], uv[:, 1])
            emissive = torch.where((tex_e != NO_TEXTURE)[:, None],
                                   texel_e[:, :3] * mat_emissive, emissive)

        roughness = srow[:, 30]
        if tex_flags[1]:
            tex_mr = srow[:, 36].to(torch.int32)
            texel_mr = sample_texture_quad(scene.atlas_quad, scene.tex_table, tex_mr,
                                           uv[:, 0], uv[:, 1])
            roughness = roughness * torch.where(tex_mr != NO_TEXTURE, texel_mr[:, 1],
                                                torch.ones_like(roughness))
        alpha = B.roughness_to_alpha(roughness)
    return Shade(hit_point=hit_point, shading_n=shading_n, albedo=albedo,
                 emissive=emissive, alpha=alpha)


@annotate("nee_sample")
def nee_directions(scene: DeviceScene, cfg: RenderConfig, state, sp: Shade, d):
    """Both NEE directions of a hit, in the reference's RNG draw order
    (u_pick, u1, u2, the dead light-index draw, u3, u4).
    Returns (state, nee_o, dir1, dir2, pick_env, lt, wo, al_b)."""
    nl = scene.lights.shape[0]
    nw = d.shape[0]
    state, u_pick = rng.next_rand(state)
    light_idx = torch.clamp((u_pick * float(nl + 1)).to(torch.int32), max=nl)
    pick_env = light_idx >= nl
    state, u1, u2 = rng.next_uniform2(state)
    if nl > 0:
        lt = scene.lights[torch.clamp(light_idx, 0, nl - 1).long()]
        dir_sphere = sample_sphere(sp.hit_point, lt[:, :3], lt[:, 3], u1, u2)
    else:
        lt = torch.zeros((nw, 8), dtype=torch.float32, device=d.device)
        dir_sphere = torch.zeros((nw, 3), dtype=torch.float32, device=d.device)
    dir_hemi = sample_hemisphere_uniform(sp.shading_n, u1, u2)
    dir1 = torch.where(pick_env[:, None], dir_hemi, dir_sphere)
    nee_o = sp.hit_point + float(np.float32(cfg.ray_offset)) * sp.shading_n

    state, _dead = rng.next_rand(state)
    state, u3, u4 = rng.next_uniform2(state)
    wo = -d
    al_b = torch.clamp(sp.alpha, min=0.01)
    micro_n = B.sample_microfacet_distribution(wo, sp.shading_n, al_b, u3, u4)
    micro_n = torch.where((sp.alpha > 0.0)[:, None], micro_n, sp.shading_n)
    dir2 = B.reflect(d, micro_n)
    return state, nee_o, dir1, dir2, pick_env, lt, wo, al_b


def _nee1(scene, cfg, sp: Shade, wo, dir1, pick_env, lt, rgb1, a1):
    """Sample-1 MIS term: weightLight for a light pick, weightLightEnvmap
    for an envmap pick, each with its own alpha clamp."""
    nl = scene.lights.shape[0]
    al_l = torch.clamp(sp.alpha, min=0.00001)
    bsdf_f1 = B.microfacet_bsdf(dir1, wo, sp.shading_n, al_l, cfg.eta_i, cfg.eta_t)
    bsdf_pdf1 = B.pdf_microfacet(dir1, wo, sp.shading_n, al_l)
    if nl > 0:
        light_pdf1 = pdf_sphere(sp.hit_point, dir1, lt[:, :3], lt[:, 3])
    else:
        light_pdf1 = torch.zeros_like(bsdf_pdf1)
    vis1 = torch.clamp(1.0 - torch.clamp(a1, min=0.0), min=0.0)
    cos1 = torch.abs(_dot(dir1, sp.shading_n))
    w_light = (bsdf_f1 * cos1 * vis1
               * B.power_heuristic(1.0, light_pdf1, 1.0, bsdf_pdf1)
               / torch.clamp(light_pdf1, min=1e-30))
    w_light = torch.where((light_pdf1 <= 0.0) | (bsdf_pdf1 <= 0.0),
                          torch.zeros_like(w_light), w_light)
    contrib_light = w_light[:, None] * rgb1

    al_le = torch.clamp(sp.alpha, min=0.001)
    bsdf_fe = B.microfacet_bsdf(dir1, wo, sp.shading_n, al_le, cfg.eta_i, cfg.eta_t)
    bsdf_pdfe = B.pdf_microfacet(dir1, wo, sp.shading_n, al_le)
    vis_env1 = (a1 < -1.0).to(torch.float32)
    w_env = (bsdf_fe * cos1 * vis_env1
             * B.power_heuristic(1.0, _ENV_PDF, 1.0, bsdf_pdfe)
             * B.recip32(_ENV_PDF))
    w_env = torch.where(bsdf_pdfe <= 0.0, torch.zeros_like(w_env), w_env)
    contrib_env = w_env[:, None] * rgb1
    return torch.where(pick_env[:, None], contrib_env, contrib_light)


@annotate("mis_weights")
def mis_contributions(scene, cfg, sp: Shade, wo, dir1, dir2, pick_env, lt, al_b,
                      rgb1, rgb2, a1, a2):
    """Both NEE samples' MIS contributions (the exact two-ray estimator),
    scaled by num_lights + 1."""
    nl = scene.lights.shape[0]
    nee1 = _nee1(scene, cfg, sp, wo, dir1, pick_env, lt, rgb1, a1)
    bsdf_pdf2 = B.pdf_microfacet(dir2, wo, sp.shading_n, al_b)
    vis_env2 = (a2 < -1.0).to(torch.float32)
    w_bsdf = (B.microfacet_weight(dir2, wo, sp.shading_n, al_b) * vis_env2
              * B.power_heuristic(1.0, bsdf_pdf2, 1.0, _ENV_PDF))
    w_bsdf = torch.where(bsdf_pdf2 <= 0.000005, torch.zeros_like(w_bsdf), w_bsdf)
    w_bsdf = torch.where(torch.isnan(dir2).any(dim=-1), torch.zeros_like(w_bsdf), w_bsdf)
    nee2 = w_bsdf[:, None] * rgb2
    return (nee1 + nee2) * float(nl + 1)


@annotate("mis_weights")
def mis_light_contribution(scene, cfg, sp: Shade, wo, dir1, pick_env, lt, rgb1, a1):
    """Sample-1-only MIS term of the folded estimator, scaled by nl + 1."""
    nl = scene.lights.shape[0]
    return _nee1(scene, cfg, sp, wo, dir1, pick_env, lt, rgb1, a1) * float(nl + 1)


def fold_mis_weight(sp: Shade, wo, bounce_dir, al_b):
    """Weight of the folded sample-2 term: weightBSDFEnvmap on the bounce
    direction times the pdf ratio for 0 < alpha < 0.01."""
    pdf_q = B.pdf_microfacet(bounce_dir, wo, sp.shading_n, al_b)
    w = (B.microfacet_weight(bounce_dir, wo, sp.shading_n, al_b)
         * B.power_heuristic(1.0, pdf_q, 1.0, _ENV_PDF))
    w = torch.where(pdf_q <= 0.000005, torch.zeros_like(w), w)
    w = torch.where(torch.isnan(bounce_dir).any(dim=-1), torch.zeros_like(w), w)
    needs_ratio = (sp.alpha > 0.0) & (sp.alpha < 0.01)
    pdf_s = B.pdf_microfacet(bounce_dir, wo, sp.shading_n, torch.clamp(sp.alpha, min=1e-8))
    ratio = torch.where(needs_ratio,
                        torch.where(pdf_s > 0.0, pdf_q / torch.clamp(pdf_s, min=1e-30),
                                    torch.zeros_like(pdf_q)),
                        torch.ones_like(pdf_q))
    return w * ratio


@annotate("bounce")
def bounce_sample(cfg: RenderConfig, state, sp: Shade, wo, d, throughput):
    """Bounce direction + Russian roulette. Returns (state, bounce_dir,
    t_new, killed, offset)."""
    al_b = torch.clamp(sp.alpha, min=0.01)
    state, u5, u6 = rng.next_uniform2(state)
    micro_b = B.sample_microfacet_distribution(wo, sp.shading_n, sp.alpha, u5, u6)
    micro_b = torch.where((sp.alpha > 0.0)[:, None], micro_b, sp.shading_n)
    bounce_dir = B.reflect(d, micro_b)
    t_new = throughput * B.microfacet_weight(bounce_dir, wo, sp.shading_n, al_b)
    rr_w = 1.0 - torch.clamp(t_new, min=float(np.float32(cfg.rr_threshold)))
    state, u_rr = rng.next_rand(state)
    killed = u_rr < rr_w
    t_new = t_new / torch.clamp(1.0 - rr_w, min=1e-30)
    below = _dot(bounce_dir, sp.shading_n) < 0.0
    off = float(np.float32(cfg.ray_offset))
    offset = torch.where(below[:, None],
                         off * (-bounce_dir) / torch.clamp(_norm(bounce_dir), min=1e-20)[:, None],
                         off * sp.shading_n)
    return state, bounce_dir, t_new, killed, offset


# ---- the wave loop ------------------------------------------------------------

def trace_paths(scene: DeviceScene, bvh, o, d, state, *, cfg: RenderConfig,
                has_alpha: bool, return_stats: bool = False,
                tex_flags: Tuple[bool, bool, bool, bool] = (True, True, True, True)):
    """Trace a flat batch of camera rays through the wave loop. Returns
    (N, 3) radiance, and with `return_stats` also RayStats."""
    n = o.shape[0]
    dev = o.device
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones(n, dtype=torch.float32, device=dev)
    albedo_prod = torch.ones((n, 3), dtype=torch.float32, device=dev)
    depth = torch.zeros(n, dtype=torch.int32, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    mis_coeff = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    sky = torch.tensor(cfg.sky_color, dtype=torch.float32, device=dev)
    fold = bool(cfg.fold_bsdf_mis)
    nl = scene.lights.shape[0]
    logical = physical = 0

    def shade_nee(o_s, d_s, state_s, thr_s, hit_s: Hit):
        """The per-hit block of a wave, on triangle-hit lanes only."""
        m = o_s.shape[0]
        tri_s = torch.ones(m, dtype=torch.bool, device=dev)
        sp = shade_hit(scene, cfg, tex_flags, o_s, d_s, hit_s)
        state_s, nee_o, dir1, dir2, pick_env, lt, wo, al_b = nee_directions(
            scene, cfg, state_s, sp, d_s)
        state_s, bounce_dir, t_new, killed, offset = bounce_sample(
            cfg, state_s, sp, wo, d_s, thr_s)
        if fold:
            with annotate("trace_shadow"):
                rgb1, a1, miss1 = _trace_shadow(scene, bvh, nee_o, dir1, tri_s, thr_s,
                                                cfg, has_alpha,
                                                ray_class=pick_env.to(torch.int32))
            miss_inc = miss1.to(torch.int32)
            local_l = sp.emissive + mis_light_contribution(
                scene, cfg, sp, wo, dir1, pick_env, lt, rgb1, a1)
            fold_w = fold_mis_weight(sp, wo, bounce_dir, al_b) * float(nl + 1) * thr_s
        else:
            with annotate("trace_shadow"):
                rgb12, a12, miss12 = _trace_shadow(
                    scene, bvh, torch.cat([nee_o, nee_o]), torch.cat([dir1, dir2]),
                    torch.cat([tri_s, tri_s]), torch.cat([thr_s, thr_s]), cfg, has_alpha)
            miss_inc = miss12[:m].to(torch.int32) + miss12[m:].to(torch.int32)
            local_l = sp.emissive + mis_contributions(
                scene, cfg, sp, wo, dir1, dir2, pick_env, lt, al_b,
                rgb12[:m], rgb12[m:], a12[:m], a12[m:])
            fold_w = torch.zeros(m, dtype=torch.float32, device=dev)
        return (state_s, miss_inc, local_l, bounce_dir, t_new, killed,
                sp.hit_point + offset, sp.albedo, fold_w)

    wave_idx = 0
    while True:
        with annotate(f"wave{wave_idx}"):
            pending = (mis_coeff != 0.0).any(dim=-1)
            trace_act = active | pending
            ti = _nz(trace_act)
            if ti.numel() == 0:
                break
            # trace the live lanes only; the rest keep tpurt's inactive-ray
            # result (a miss at t_max)
            with annotate("trace_closest"):
                hit_c = _trace(scene, bvh, o[ti], d[ti],
                               torch.zeros(ti.numel(), dtype=torch.float32, device=dev),
                               torch.ones(ti.numel(), dtype=torch.bool, device=dev),
                               wave_idx > 0, cfg, has_alpha,
                               sort_rays=wave_idx > 0 or cfg.kernel.sort_wave0)
            hit = _hit_scatter(_miss_hit(n, cfg.t_max, dev), ti, hit_c)

            is_tri = active & (hit.kind == KIND_TRIANGLE)
            n_tri = int(is_tri.sum())
            logical += int(active.sum()) + 2 * n_tri
            physical += ti.numel() + (1 if fold else 2) * n_tri
            is_miss = active & (hit.kind == KIND_MISS)
            zero3 = torch.zeros_like(radiance)
            if fold:
                esc = pending & (hit.kind == KIND_MISS)
                radiance = radiance + torch.where(esc[:, None], mis_coeff * sky[None, :], zero3)
            if wave_idx == 0:
                radiance = radiance + torch.where(is_miss[:, None],
                                                  sky[None, :] * throughput[:, None], zero3)

            si = _nz(is_tri)
            hit_s = Hit(*(x[si] for x in hit))
            outs = shade_nee(o[si], d[si], state[si], throughput[si], hit_s)
            (st_c, mi_c, ll_c, bd_c, tn_c, kl_c, no_c, al_c, fw_c) = outs
            # lanes left out of the shade block are terminated: their rng state
            # is never read again, and every other output is masked below
            state = _scatter(state, si, st_c)
            miss_inc = _scatter(torch.zeros_like(depth), si, mi_c)
            local_l = _scatter(zero3, si, ll_c)
            bounce_dir = _scatter(zero3, si, bd_c)
            t_new = _scatter(torch.zeros_like(throughput), si, tn_c)
            killed = _scatter(torch.zeros_like(active), si, kl_c)
            new_o = _scatter(zero3, si, no_c)
            sh_albedo = _scatter(zero3, si, al_c)
            fold_w = _scatter(torch.zeros_like(throughput), si, fw_c)

            depth = depth + miss_inc
            can_bounce = depth < cfg.max_depth
            depth = depth + is_tri.to(torch.int32)

            with annotate("bounce_resolve"):
                dead_by_rr = is_tri & can_bounce & killed
                add = is_tri & ~dead_by_rr
                radiance = radiance + torch.where(add[:, None],
                                                  albedo_prod * sh_albedo * local_l, zero3)
                mis_coeff = torch.where(add[:, None],
                                        albedo_prod * sh_albedo * fold_w[:, None], zero3)
                cont = is_tri & can_bounce & ~killed
                upd = (cont | add) if fold else cont
                o = torch.where(upd[:, None], new_o, o)
                d = torch.where(upd[:, None], bounce_dir, d)
                albedo_prod = torch.where(cont[:, None], albedo_prod * sh_albedo, albedo_prod)
                throughput = torch.where(cont, t_new, throughput)
                active = cont
            wave_idx += 1

    if return_stats:
        return radiance, RayStats(logical=float(logical), physical=float(physical))
    return radiance


# ---- packet tiling ------------------------------------------------------------

_PACKET_PIXELS = 1024


def tile_shape(rows: int, width: int, packet: int = _PACKET_PIXELS):
    """Squarest (tile_h, tile_w) with tile_h * tile_w == packet dividing
    the band, or None."""
    best = None
    th = 1
    while th <= packet:
        tw = packet // th
        if rows % th == 0 and th <= rows and width % tw == 0 and tw <= width:
            if best is None or (abs(math.log2(th / tw))
                                < abs(math.log2(best[0] / best[1]))):
                best = (th, tw)
        th *= 2
    return best


def tile_pack(x, spp: int, rows: int, width: int, th: int, tw: int):
    """Reorder flat per-ray arrays so each consecutive `packet` slice is
    one (th, tw) pixel tile (coherent neighbours in a traversal batch)."""
    tail = tuple(x.shape[1:])
    x = x.reshape(spp, rows // th, th, width // tw, tw, *tail)
    x = torch.swapaxes(x, 2, 3)
    return x.reshape(spp * rows * width, *tail)


def tile_unpack(x, spp: int, rows: int, width: int, th: int, tw: int):
    """Inverse of tile_pack."""
    tail = tuple(x.shape[1:])
    x = x.reshape(spp, rows // th, width // tw, th, tw, *tail)
    x = torch.swapaxes(x, 2, 3)
    return x.reshape(spp * rows * width, *tail)


def render_rows_stats(scene: DeviceScene, bvh, camera: Camera, sample_index: int,
                      row_start: int, *, rows: int, width: int, height: int,
                      cfg: RenderConfig, has_alpha: bool,
                      tex_flags=(True, True, True, True)):
    """One progressive sample for a band of `rows` image rows, with its
    traced-ray counts. With cfg.spp_per_launch = k > 1, `sample_index`
    counts launches and the result is the mean of k samples. Returns
    ((rows, width, 4) radiance, RayStats)."""
    spp = cfg.spp_per_launch
    dev = scene.tri_pos.device
    o, d, state = camera_rays_for_rows(camera, row_start, rows, width, height,
                                       cfg.tan_half_fov, sample_index, cfg.seed,
                                       spp=spp, device=dev)
    ts = tile_shape(rows, width)
    if ts is not None:
        o, d, state = (tile_pack(x, spp, rows, width, *ts) for x in (o, d, state))
    radiance, stats = trace_paths(scene, bvh, o, d, state, cfg=cfg,
                                  has_alpha=has_alpha, return_stats=True,
                                  tex_flags=tex_flags)
    if ts is not None:
        radiance = tile_unpack(radiance, spp, rows, width, *ts)
    n = rows * width
    if spp > 1:
        radiance = radiance.reshape(spp, n, 3).mean(dim=0)
    img = torch.cat([radiance, torch.ones((n, 1), dtype=torch.float32, device=dev)],
                    dim=-1).reshape(rows, width, 4)
    return img, stats


def render_sample_stats(scene: DeviceScene, bvh, camera: Camera, sample_index: int, *,
                        width: int, height: int, cfg: RenderConfig, has_alpha: bool,
                        chunk_rows: int = 0, tex_flags=(True, True, True, True)):
    """One progressive sample with its traced-ray counts: ((H, W, 4)
    radiance, RayStats), rendered in row bands of `chunk_rows` when that
    is > 0 (bounds the wave state memory). The bands' counts are summed
    in host doubles, as tpurt sums them. RayStats.physical is the Mrays/s
    numerator, .logical the reference-equivalent work (trace_paths)."""
    if chunk_rows <= 0 or chunk_rows >= height:
        bands = [(0, height)]
    else:
        bands = [(r, min(chunk_rows, height - r)) for r in range(0, height, chunk_rows)]
    imgs, total = [], np.zeros(2, np.float64)
    for row, rows in bands:
        img, st = render_rows_stats(scene, bvh, camera, sample_index, row, rows=rows,
                                    width=width, height=height, cfg=cfg,
                                    has_alpha=has_alpha, tex_flags=tex_flags)
        imgs.append(img)
        total += (st.logical, st.physical)
    return torch.cat(imgs, dim=0), RayStats(logical=float(total[0]), physical=float(total[1]))


def render_rows(scene: DeviceScene, bvh, camera: Camera, sample_index: int,
                row_start: int, *, rows: int, width: int, height: int,
                cfg: RenderConfig, has_alpha: bool,
                tex_flags=(True, True, True, True), return_stats: bool = False):
    """One progressive sample for a band of `rows` image rows: (rows,
    width, 4) radiance (and RayStats with `return_stats`, as
    render_rows_stats)."""
    img, stats = render_rows_stats(scene, bvh, camera, sample_index, row_start, rows=rows,
                                   width=width, height=height, cfg=cfg,
                                   has_alpha=has_alpha, tex_flags=tex_flags)
    return (img, stats) if return_stats else img


def render_sample(scene: DeviceScene, bvh, camera: Camera, sample_index: int, *,
                  width: int, height: int, cfg: RenderConfig, has_alpha: bool,
                  chunk_rows: int = 0, tex_flags=(True, True, True, True),
                  return_stats: bool = False):
    """One progressive sample: (H, W, 4) radiance (and RayStats with
    `return_stats`, as render_sample_stats)."""
    img, stats = render_sample_stats(scene, bvh, camera, sample_index, width=width,
                                     height=height, cfg=cfg, has_alpha=has_alpha,
                                     chunk_rows=chunk_rows, tex_flags=tex_flags)
    return (img, stats) if return_stats else img
