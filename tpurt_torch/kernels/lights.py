"""Sphere-light and hemisphere sampling + pdfs (the counterpart of
tpurt/kernels/lights.py), with the reference's non-orthonormal tangent
frames kept as they are."""

from __future__ import annotations

import torch

from tpurt_torch.kernels.bsdf import PI, _cross, _dot, _normalize, _where, sqrt_rn


def sample_hemisphere_uniform(normal, u1, u2):
    """sampleHemisphereUniform (sphere-light.glsl:7-27)."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    cond = torch.abs(nx) > torch.abs(ny)
    zero = torch.zeros_like(nx)
    t_main = torch.stack([-ny, zero, nx], dim=-1)
    t_alt = torch.stack([ny, zero, -nz], dim=-1)
    t1 = _normalize(torch.where(cond[..., None], t_main, t_alt))
    t2 = _cross(normal, t1)
    m = sqrt_rn(torch.clamp(1.0 - u1 * u1, min=0.0))
    vx = torch.cos(2.0 * PI * u2) * m
    vy = u1
    vz = -torch.sin(2.0 * PI * u2) * m
    out = vx[..., None] * t1 + vy[..., None] * normal - vz[..., None] * t2
    return _normalize(out)


def sample_sphere(hit_origin, light_pos, radius, u1, u2):
    """sampleSphere (sphere-light.glsl:30-68): cone sampling from outside;
    the inside branch returns the reference's raw local vector."""
    otc = light_pos - hit_origin
    dist2 = _dot(otc, otc)

    r_in = sqrt_rn(torch.clamp(u1 * (1.0 - u1), min=0.0))
    inside_vec = torch.stack(
        [
            2.0 * torch.cos(2.0 * PI * u2) * r_in,
            2.0 * torch.sin(2.0 * PI * u2) * r_in,
            u2 * 2.0 - 1.0,
        ],
        dim=-1,
    )

    sin_theta_max2 = (radius * radius) / torch.clamp(dist2, min=1e-30)
    cos_theta_max = sqrt_rn(torch.clamp(1.0 - sin_theta_max2, min=0.0))
    cos_theta = (1.0 - u1) + u1 * cos_theta_max
    sin_theta = sqrt_rn(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = u2 * 2.0 * PI
    dc = sqrt_rn(torch.clamp(dist2, min=1e-30))
    ds = dc * cos_theta - sqrt_rn(
        torch.clamp(radius * radius - dist2 * sin_theta * sin_theta, min=0.0))
    cos_alpha = (dist2 + radius * radius - ds * ds) / torch.clamp(2.0 * dc * radius, min=1e-30)
    sin_alpha = sqrt_rn(torch.clamp(1.0 - cos_alpha * cos_alpha, min=0.0))
    otc_n = _normalize(otc)

    ox, oy, oz = otc_n[..., 0], otc_n[..., 1], otc_n[..., 2]
    cond = torch.abs(ox) > torch.abs(oy)
    zero = torch.zeros_like(ox)
    o1_main = torch.stack([oy, -ox, zero], dim=-1)
    o1_alt = torch.stack([zero, -oy, oz], dim=-1)
    o1 = _normalize(torch.where(cond[..., None], o1_main, o1_alt))
    o2 = _cross(otc_n, o1)

    point_on_sphere = (
        (sin_alpha * torch.cos(phi))[..., None] * o1
        + torch.abs(cos_alpha)[..., None] * otc_n
        - (sin_alpha * torch.sin(phi))[..., None] * o2
    )
    outside_vec = _normalize(-point_on_sphere * radius[..., None] + light_pos - hit_origin)

    inside = torch.abs(dist2) < radius * radius
    return torch.where(inside[..., None], inside_vec, outside_vec)


def pdf_sphere(hit_origin, sample_dir, light_pos, radius):
    """pdfSphere (sphere-light.glsl:71-92)."""
    otc = light_pos - hit_origin
    cto = hit_origin - light_pos
    dist2 = _dot(otc, otc)
    sd = _dot(sample_dir, cto)
    disc = sd * sd - (_dot(cto, cto) - radius * radius)
    inside = dist2 < radius * radius
    pdf_inside = 1.0 / (4.0 * PI * radius * radius)
    sin_theta_max2 = (radius * radius) / torch.clamp(dist2, min=1e-30)
    cos_theta_max = sqrt_rn(torch.clamp(1.0 - sin_theta_max2, min=0.0))
    pdf_outside = 1.0 / torch.clamp(2.0 * PI * (1.0 - cos_theta_max), min=1e-30)
    pdf = torch.where(inside, pdf_inside, pdf_outside)
    return _where(disc < 0.0, 0.0, pdf)
