"""Brute-force reference integrator, the independent estimator oracle
(the counterpart of tpurt/integrator/oracle.py).

A kernel-free restatement of the reference's recursive megakernel
(shaders/triangle.rchit:60-218, raytrace.rgen:64-76, sphere.rchit:18-19,
raytrace.rmiss:10-11): every trace tests every triangle (no BVH), the
any-hit alpha test runs inside the intersection loop (raytrace.rahit:
53-58) instead of production's re-trace loop, and there is no ray sort,
no compaction, no folded BSDF-MIS and no traversal kernel. Shading
attributes are interpolated from the raw per-triangle arrays, not from
the fused shading rows. It shares with production only the leaf maths
(kernels/bsdf, kernels/lights, kernels/texture, rng, camera) and
re-derives the estimator: payload protocol, NEE/MIS, depth accounting,
Russian roulette, contribution chaining.

RNG: the draws are consumed unconditionally, on production's per-ray
stream, in production's order (the dead light-index draw included), so
exact-mode production (fold_bsdf_mis=False) at the same seed agrees
almost bit for bit, and folded-mode production within Monte-Carlo noise.

The brute force visits the triangles in chunks (rays x chunk <= 2^24
elements) instead of one at a time. Within a chunk every candidate is
tested against the best t at the chunk's start, alpha-rejected
candidates are masked out, and the chunk's least t with the lowest
triangle id among equal t is kept where it is below the best: the
result of tpurt's loop, where a strict t < t_best lets the lowest id win
an exact tie. It runs on the device of the scene's tensors. Its cost is
O(rays x triangles x waves): use it at thumbnail sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from tpurt_torch import rng
from tpurt_torch.camera import Camera, camera_rays_for_rows
from tpurt_torch.config import RenderConfig
from tpurt_torch.integrator.wavefront import _ENV_PDF, _bary, _unit
from tpurt_torch.kernels import bsdf as B
from tpurt_torch.kernels.bsdf import _dot, _norm
from tpurt_torch.kernels.intersect import intersect_spheres, ray_triangle
from tpurt_torch.kernels.lights import pdf_sphere, sample_hemisphere_uniform, sample_sphere
from tpurt_torch.kernels.texture import sample_texture_alpha_quad, sample_texture_quad
from tpurt_torch.scene.device import DeviceScene
from tpurt_torch.scene.types import NO_TEXTURE

# rays x triangles tested at once by the brute force
CHUNK_ELEMENTS = 1 << 24


def _alpha_rejected(scene: DeviceScene, ray, tri, u, v):
    """The any-hit test of candidate hits (ray, tri) at (u, v): True where
    the albedo alpha at the hit uv is below the material cutoff
    (raytrace.rahit:53-58)."""
    uvs = scene.tri_uv[tri]
    uv = _bary(1.0 - u - v, u, v, uvs)
    m = scene.tri_mat[tri].long()
    mats = scene.materials
    tex = mats.tex_albedo[m]
    a = sample_texture_alpha_quad(scene.atlas_quad, scene.tex_table, tex, uv[:, 0], uv[:, 1])
    a = torch.where(tex == NO_TEXTURE, torch.ones_like(a), a)
    return ~(a >= mats.alpha_cutoff[m])


def _bf_closest(scene: DeviceScene, cfg: RenderConfig, o, d, *, include_spheres: bool):
    """Brute-force closest hit with the in-loop any-hit alpha test.
    Returns (t, prim, u, v, is_tri, is_sphere, sphere_id)."""
    n = o.shape[0]
    dev = o.device
    num_tri = scene.tri_pos.shape[0]
    t_min = torch.zeros(n, dtype=torch.float32, device=dev)
    t_best = torch.full((n,), float(np.float32(cfg.t_max)), dtype=torch.float32, device=dev)
    prim_best = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_best = torch.zeros(n, dtype=torch.float32, device=dev)
    v_best = torch.zeros(n, dtype=torch.float32, device=dev)
    # the alpha-tested triangles, once per call (one host copy)
    alpha_ids = torch.nonzero(scene.tri_alpha, as_tuple=True)[0].cpu().numpy()
    chunk = max(1, min(num_tri, CHUNK_ELEMENTS // max(n, 1)))
    for c0 in range(0, num_tri, chunk):
        c1 = min(c0 + chunk, num_tri)
        tri = scene.tri_pos[c0:c1][None]
        hit, t, u, v = ray_triangle(o[:, None, :], d[:, None, :], tri[:, :, 0], tri[:, :, 1],
                                    tri[:, :, 2], t_min[:, None], t_best[:, None])
        cols = alpha_ids[(alpha_ids >= c0) & (alpha_ids < c1)] - c0
        if cols.size:
            cols = torch.from_numpy(cols).to(dev)
            r, k = torch.nonzero(hit[:, cols], as_tuple=True)
            if r.numel():
                kc = cols[k]
                rej = _alpha_rejected(scene, r, kc + c0, u[r, kc], v[r, kc])
                hit[r[rej], kc[rej]] = False
        t_hit = torch.where(hit, t, torch.full_like(t, float("inf")))
        t_chunk = torch.amin(t_hit, dim=1)
        ids = torch.arange(c1 - c0, device=dev)
        first = torch.amin(torch.where(t_hit == t_chunk[:, None], ids[None, :], c1 - c0),
                           dim=1, keepdim=True)
        take = t_chunk < t_best
        t_best = torch.where(take, t_chunk, t_best)
        prim_best = torch.where(take, (first[:, 0] + c0).to(torch.int32), prim_best)
        u_best = torch.where(take, torch.gather(u, 1, first)[:, 0], u_best)
        v_best = torch.where(take, torch.gather(v, 1, first)[:, 0], v_best)

    is_tri = prim_best >= 0
    is_sphere = torch.zeros(n, dtype=torch.bool, device=dev)
    sphere_id = torch.zeros(n, dtype=torch.int32, device=dev)
    if include_spheres and scene.num_lights > 0:
        s_hit, s_t, s_id = intersect_spheres(o, d, scene.lights, t_min, cfg.t_max)
        s_hit = s_hit & (s_t < t_best)
        t_best = torch.where(s_hit, s_t, t_best)
        is_sphere = s_hit
        is_tri = is_tri & ~s_hit
        sphere_id = s_id
    return t_best, prim_best, u_best, v_best, is_tri, is_sphere, sphere_id


def _payload_trace(scene: DeviceScene, cfg: RenderConfig, o, d, throughput):
    """A full trace of an isLightSample ray with the payload protocol:
    surface -> black, a = 1 (triangle.rchit:114-117); light -> rgb *
    intensity * throughput, a = 0 (sphere.rchit:18-19); miss -> sky *
    throughput, a = -4 (raytrace.rmiss:10-11). Returns (rgb (N, 3), a
    (N,), is_miss (N,))."""
    _, _, _, _, is_tri, is_sphere, s_id = _bf_closest(scene, cfg, o, d, include_spheres=True)
    n = o.shape[0]
    sky = torch.tensor(cfg.sky_color, dtype=torch.float32, device=o.device)
    nl = scene.num_lights
    if nl > 0:
        lt = scene.lights[torch.clamp(s_id, 0, nl - 1).long()]
        light_rgb = lt[:, 4:7] * lt[:, 7:8] * throughput[:, None]
    else:
        light_rgb = torch.zeros((n, 3), dtype=torch.float32, device=o.device)
    is_miss = ~is_tri & ~is_sphere
    rgb = torch.where(is_tri[:, None], torch.zeros_like(light_rgb),
                      torch.where(is_sphere[:, None], light_rgb,
                                  sky[None, :] * throughput[:, None]))
    a = torch.where(is_tri, 1.0, torch.where(is_sphere, 0.0, -4.0))
    return rgb, a, is_miss


def _shade(scene: DeviceScene, cfg: RenderConfig, o, d, t, prim, u, v):
    """Attribute interpolation and material evaluation from the raw
    per-triangle arrays (triangle.rchit:120-186). Returns (hit_point,
    shading_n, albedo, emissive, alpha)."""
    mats = scene.materials
    p = torch.clamp(prim, 0, scene.tri_pos.shape[0] - 1).long()
    w0 = 1.0 - u - v
    uv = _bary(w0, u, v, scene.tri_uv[p])
    normal = _unit(_bary(w0, u, v, scene.tri_normal[p]))
    tan4 = _bary(w0, u, v, scene.tri_tangent[p])
    tangent = _unit(tan4[:, :3])

    m = scene.tri_mat[p].long()
    hit_point = o + t[:, None] * d

    albedo = mats.albedo_scale[m][:, :3]
    tex_a = mats.tex_albedo[m]
    texel = sample_texture_quad(scene.atlas_quad, scene.tex_table, tex_a, uv[:, 0], uv[:, 1])
    albedo = torch.where((tex_a != NO_TEXTURE)[:, None], albedo * texel[:, :3], albedo)

    tex_n = mats.tex_normal[m]
    nf = mats.normal_factor[m]
    texel_n = sample_texture_quad(scene.atlas_quad, scene.tex_table, tex_n, uv[:, 0], uv[:, 1])
    nm = (texel_n[:, :3] * 2.0 - 1.0) * nf[:, None]
    bitangent = B._cross(normal, tangent) * tan4[:, 3:4]
    mapped = _unit(nm[:, 0:1] * tangent + nm[:, 1:2] * bitangent + nm[:, 2:3] * normal)
    use_nm = (tex_n != NO_TEXTURE) & (torch.abs(nf) > 0.001)
    shading_n = torch.where(use_nm[:, None], mapped, normal)

    tex_e = mats.tex_emissive[m]
    texel_e = sample_texture_quad(scene.atlas_quad, scene.tex_table, tex_e, uv[:, 0], uv[:, 1])
    mat_e = mats.emissive[m][:, :3]
    emissive = torch.where((tex_e != NO_TEXTURE)[:, None], texel_e[:, :3] * mat_e,
                           mat_e * float(np.float32(cfg.emissive_untextured_scale)))

    tex_mr = mats.tex_mr[m]
    texel_mr = sample_texture_quad(scene.atlas_quad, scene.tex_table, tex_mr, uv[:, 0], uv[:, 1])
    roughness = mats.roughness[m] * torch.where(tex_mr != NO_TEXTURE, texel_mr[:, 1],
                                                torch.ones_like(texel_mr[:, 1]))
    return hit_point, shading_n, albedo, emissive, B.roughness_to_alpha(roughness)


def trace_paths_oracle(scene: DeviceScene, o, d, state, *, cfg: RenderConfig):
    """The full estimator, one wave per recursion level (max_depth + 1
    waves: the camera hit and the bounces). Returns (N, 3) radiance."""
    n = o.shape[0]
    dev = o.device
    nl = scene.num_lights
    sky = torch.tensor(cfg.sky_color, dtype=torch.float32, device=dev)
    off = float(np.float32(cfg.ray_offset))

    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    scale = torch.ones((n, 3), dtype=torch.float32, device=dev)   # product of ancestor albedos
    throughput = torch.ones(n, dtype=torch.float32, device=dev)   # payload.rayThroughput
    depth = torch.zeros(n, dtype=torch.int32, device=dev)         # payload.recursionDepth
    active = torch.ones(n, dtype=torch.bool, device=dev)
    zero3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    for wave in range(cfg.max_depth + 1):
        t, prim, u, v, is_tri, is_sphere, _ = _bf_closest(scene, cfg, o, d,
                                                          include_spheres=wave > 0)
        is_tri = is_tri & active
        is_miss = active & ~is_tri & ~is_sphere
        if wave == 0:
            # the camera miss adds sky * throughput (raytrace.rgen:75); a
            # sphere or miss on a bounce ray adds nothing (triangle.rchit:218)
            radiance = radiance + torch.where(is_miss[:, None],
                                              sky[None, :] * throughput[:, None], zero3)

        hit_point, normal, albedo, emissive, alpha = _shade(scene, cfg, o, d, t, prim, u, v)
        incoming = emissive                                    # triangle.rchit:175-178

        # sampleLight (triangle.rchit:60-111)
        state, u_pick = rng.next_rand(state)
        light_idx = torch.clamp((u_pick * float(nl + 1)).to(torch.int32), max=nl)
        pick_env = light_idx >= nl
        state, u1, u2 = rng.next_uniform2(state)
        if nl > 0:
            lt = scene.lights[torch.clamp(light_idx, 0, nl - 1).long()]
            dir_s = sample_sphere(hit_point, lt[:, :3], lt[:, 3], u1, u2)
        else:
            lt = torch.zeros((n, 8), dtype=torch.float32, device=dev)
            dir_s = zero3
        dir1 = torch.where(pick_env[:, None], sample_hemisphere_uniform(normal, u1, u2), dir_s)
        nee_o = hit_point + off * normal
        rgb1, a1, miss1 = _payload_trace(scene, cfg, nee_o, dir1, throughput)
        depth = depth + (is_tri & miss1).to(torch.int32)       # raytrace.rmiss:10

        wo = -d
        cos1 = torch.abs(_dot(dir1, normal))
        # weightLight (raytrace-common.glsl:51-62), alpha clamp 1e-5
        al = torch.clamp(alpha, min=0.00001)
        f1 = B.microfacet_bsdf(dir1, wo, normal, al, cfg.eta_i, cfg.eta_t)
        p1 = B.pdf_microfacet(dir1, wo, normal, al)
        lp = (pdf_sphere(hit_point, dir1, lt[:, :3], lt[:, 3]) if nl > 0
              else torch.zeros_like(p1))
        vis = torch.clamp(1.0 - torch.clamp(a1, min=0.0), min=0.0)
        w_l = (f1 * cos1 * vis * B.power_heuristic(1.0, lp, 1.0, p1)
               / torch.clamp(lp, min=1e-30))
        w_l = torch.where((lp <= 0.0) | (p1 <= 0.0), torch.zeros_like(w_l), w_l)
        # weightLightEnvmap (raytrace-common.glsl:64-80), alpha clamp 1e-3
        ale = torch.clamp(alpha, min=0.001)
        fe = B.microfacet_bsdf(dir1, wo, normal, ale, cfg.eta_i, cfg.eta_t)
        pe = B.pdf_microfacet(dir1, wo, normal, ale)
        vise = (a1 < -1.0).to(torch.float32)
        w_e = (fe * cos1 * vise * B.power_heuristic(1.0, _ENV_PDF, 1.0, pe)
               * B.recip32(_ENV_PDF))
        w_e = torch.where(pe <= 0.0, torch.zeros_like(w_e), w_e)
        nee = torch.where(pick_env[:, None], w_e[:, None] * rgb1, w_l[:, None] * rgb1)

        # sample the BSDF: always the envmap branch (triangle.rchit:89-108)
        state, _dead = rng.next_rand(state)  # the overridden lightIndex draw
        state, u3, u4 = rng.next_uniform2(state)
        alb = torch.clamp(alpha, min=0.01)
        micro = B.sample_microfacet_distribution(wo, normal, alb, u3, u4)
        micro = torch.where((alpha > 0.0)[:, None], micro, normal)
        dir2 = B.reflect(d, micro)
        rgb2, a2, miss2 = _payload_trace(scene, cfg, nee_o, dir2, throughput)
        depth = depth + (is_tri & miss2).to(torch.int32)
        # weightBSDFEnvmap (raytrace-common.glsl:95-112), alpha clamp 1e-2
        p2 = B.pdf_microfacet(dir2, wo, normal, alb)
        vis2 = (a2 < -1.0).to(torch.float32)
        w_b = (B.microfacet_weight(dir2, wo, normal, alb) * vis2
               * B.power_heuristic(1.0, p2, 1.0, _ENV_PDF))
        w_b = torch.where(p2 <= 0.000005, torch.zeros_like(w_b), w_b)
        w_b = torch.where(torch.isnan(dir2).any(dim=-1), torch.zeros_like(w_b), w_b)
        incoming = incoming + (nee + w_b[:, None] * rgb2) * float(nl + 1)  # :110

        # bounce and Russian roulette (triangle.rchit:192-218)
        can_bounce = depth < cfg.max_depth
        depth = depth + is_tri.to(torch.int32)
        state, u5, u6 = rng.next_uniform2(state)
        micro_b = B.sample_microfacet_distribution(wo, normal, alpha, u5, u6)
        micro_b = torch.where((alpha > 0.0)[:, None], micro_b, normal)
        dir3 = B.reflect(d, micro_b)
        t_new = throughput * B.microfacet_weight(dir3, wo, normal, alb)
        rr_w = 1.0 - torch.clamp(t_new, min=float(np.float32(cfg.rr_threshold)))
        state, u_rr = rng.next_rand(state)
        killed = u_rr < rr_w
        t_new = t_new / torch.clamp(1.0 - rr_w, min=1e-30)
        below = _dot(dir3, normal) < 0.0
        offset = torch.where(below[:, None],
                             off * (-dir3) / torch.clamp(_norm(dir3), min=1e-20)[:, None],
                             off * normal)

        # a Russian-roulette kill drops the whole hit contribution
        # (triangle.rchit:205); a depth-capped hit contributes but stops
        dead_by_rr = is_tri & can_bounce & killed
        add = is_tri & ~dead_by_rr
        radiance = radiance + torch.where(add[:, None], scale * albedo * incoming, zero3)
        cont = is_tri & can_bounce & ~killed
        o = torch.where(cont[:, None], hit_point + offset, o)
        d = torch.where(cont[:, None], dir3, d)
        scale = torch.where(cont[:, None], scale * albedo, scale)
        throughput = torch.where(cont, t_new, throughput)
        active = cont
    return radiance


def render_sample_oracle(scene: DeviceScene, camera: Camera, sample_index: int, *,
                         width: int, height: int, cfg: RenderConfig):
    """One progressive sample through the oracle, on the scene's device.
    The same raygen as production (camera_rays_for_rows), so exact-mode
    production at the same seed shoots the same primary rays. Returns
    (H, W, 3) radiance."""
    o, d, state = camera_rays_for_rows(camera, 0, height, width, height, cfg.tan_half_fov,
                                       sample_index, cfg.seed, device=scene.tri_pos.device)
    return trace_paths_oracle(scene, o, d, state, cfg=cfg).reshape(height, width, 3)
