"""The plain reference of what one launch of the renderer computes for a
set of pixels: plain PyTorch, no acceleration structure, no ray sort,
no compaction by kernels, no fused tables. It imports nothing of the
program and reads only `SceneArrays` (the benchmark's own generator
output) and the cell's settings.

What it restates, from the original renderer's shaders as the program
documents them:

- the camera: jittered pinhole rays through the frustum corners, from a
  counter-based PCG stream per (seed, sample, pixel);
- closest hits by testing every triangle (Moller-Trumbore, the lowest
  triangle id wins an exact tie), with the alpha-MASK test inside the
  loop: a candidate whose NEAREST texel alpha lies below the material's
  cutoff is no hit; the sphere lights after the triangles, from the
  first bounce on;
- shadow rays: blocked by any triangle hit before the chosen sphere (or
  the sky) that the alpha test does not reject;
- shading from the raw per-vertex attributes: base colour, roughness
  and emission, each times its texture, and a tangent-space normal map;
  textures sampled from the raw RGBA8 images (NEAREST or bilinear at lod
  0, REPEAT / MIRRORED_REPEAT / CLAMP wraps, sRGB decoded unless a
  normal map uses the image);
- the estimator: next-event estimation of one light or the sky (picked
  uniformly), weighted by the power heuristic against the Beckmann
  microfacet BSDF; the BSDF sample's MIS term folded into the bounce ray
  (it adds sky light if the next wave's ray escapes); Russian roulette
  that drops the whole hit; the depth cap with its count of missed
  shadow rays; the renderer's RNG draw order;
- the film: the per-launch running average in float32, NaN painted red;
  the exposure tonemap and 8-bit conversion.

Every function works in the dtype of the scene's tensors, so the same
code in bfloat16 is the control that the comparison must reject.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PI = 3.14159265358979323846
_MASK = 0xFFFFFFFF
_FLT_MIN = 1.1754943508222875e-38
_ENV_PDF = 1.0 / (2.0 * PI)
_INV_2_SQRT_PI = float(np.float32(1.0) / (np.float32(2.0) * np.sqrt(np.float32(PI))))
NO_TEXTURE = 0xFFFF
# rays x triangles tested at once
CHUNK_ELEMENTS = 1 << 24


# ---- scene on the device ------------------------------------------------------

class RefScene(NamedTuple):
    v0: torch.Tensor          # (T, 3)
    e1: torch.Tensor          # (T, 3) v1 - v0
    e2: torch.Tensor          # (T, 3) v2 - v0
    normal: torch.Tensor      # (T, 3, 3)
    tangent: torch.Tensor     # (T, 3, 4)
    uv: torch.Tensor          # (T, 3, 2)
    mat: torch.Tensor         # (T,) long
    alpha_tri: torch.Tensor   # (T,) bool
    albedo: torch.Tensor      # (M, 3)
    roughness: torch.Tensor   # (M,)
    normal_scale: torch.Tensor  # (M,)
    emissive: torch.Tensor    # (M, 3)
    cutoff: torch.Tensor      # (M,)
    tex: torch.Tensor         # (M, 4) long
    texels: torch.Tensor      # (sum of texels, 4) uint8, the images one after another
    tex_info: torch.Tensor    # (NT, 7) long: offset, w, h, filter, wrap_s, wrap_t, srgb
    lights: torch.Tensor      # (L, 8): position, radius, rgb, intensity


def make_scene(arrays, lights, device, dtype=torch.float32) -> RefScene:
    """The reference's tensors from the generator's `SceneArrays` and the
    configuration's lights ([(position, radius, color, intensity)])."""
    pos = np.asarray(arrays.tri_pos, np.float32)
    v0 = pos[:, 0]
    e1 = pos[:, 1] - v0
    e2 = pos[:, 2] - v0

    def f(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device).to(dtype)

    def i(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.int64), device=device)

    info, chunks, offset = [], [], 0
    for img, filt, ws, wt, srgb in arrays.textures:
        h, w = img.shape[:2]
        info.append([offset, w, h, filt, ws, wt, int(srgb)])
        chunks.append(img.reshape(-1, 4))
        offset += h * w
    if not chunks:  # a scene without images: one white texel that no material names
        info.append([0, 1, 1, 0, 0, 0, 0])
        chunks.append(np.full((1, 4), 255, np.uint8))
    texels = np.concatenate(chunks)
    light_rows = np.array([[*p, r, *c, k] for p, r, c, k in lights], np.float32).reshape(-1, 8)
    return RefScene(
        v0=f(v0), e1=f(e1), e2=f(e2), normal=f(arrays.tri_normal),
        tangent=f(arrays.tri_tangent), uv=f(arrays.tri_uv), mat=i(arrays.tri_mat),
        alpha_tri=torch.as_tensor(np.asarray(arrays.mat_alpha_tested)[arrays.tri_mat],
                                  device=device),
        albedo=f(arrays.mat_albedo), roughness=f(arrays.mat_roughness),
        normal_scale=f(arrays.mat_normal_scale), emissive=f(arrays.mat_emissive),
        cutoff=f(arrays.mat_cutoff), tex=i(arrays.mat_tex),
        texels=torch.as_tensor(texels, device=device),
        tex_info=i(np.array(info, np.int64).reshape(-1, 7)), lights=f(light_rows))


# ---- small vector helpers -------------------------------------------------------

def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def recip32(c) -> float:
    """1/c rounded to float32 (a division by a constant is a
    multiplication by its float32 reciprocal in the renderer)."""
    return float(np.float32(1.0) / np.float32(c))


def sqrt_rn(x):
    """The correctly rounded square root."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _norm(v):
    return sqrt_rn(_dot(v, v))


def _normalize(v, eps=1e-20):
    return v / torch.clamp(_norm(v), min=eps)[..., None]


def _ftz(x):
    """Denormals flushed to zero, as the original renderer's arithmetic does."""
    return torch.where(torch.abs(x) < _FLT_MIN, torch.zeros_like(x), x)


def _where(c, a, b, like):
    a = a if isinstance(a, torch.Tensor) else torch.full_like(like, a)
    b = b if isinstance(b, torch.Tensor) else torch.full_like(like, b)
    return torch.where(c, a, b)


def _bary(w0, w1, w2, verts):
    return w0[:, None] * verts[:, 0] + w1[:, None] * verts[:, 1] + w2[:, None] * verts[:, 2]


# ---- random numbers and camera rays ---------------------------------------------

def pcg_hash(x):
    state = ((x & _MASK) * 747796405 + 2891336453) & _MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _MASK
    return (word >> 22) ^ word


def init_state(pixel, sample, seed):
    """The per-ray stream of (seed, sample, pixel): int64 holding u32."""
    h = pcg_hash(torch.full_like(pixel, int(seed) & _MASK))
    h = pcg_hash(h ^ (sample & _MASK))
    return pcg_hash(h ^ (pixel & _MASK))


def next_rand(state, dtype):
    state = pcg_hash(state)
    u = torch.clamp(state.to(torch.float32) * 2.3283064365386963e-10, max=1.0 - 2.0 ** -24)
    return state, u.to(dtype)


def camera_rays(cam, pixel, sample, seed, width, height, fov_degrees, dtype):
    """Jittered primary rays of `pixel` (row-major indices) at `sample`.
    `cam` = (position, phi, theta) as in the configuration."""
    position, phi, theta = cam
    direction = np.array([np.cos(theta) * np.sin(phi), np.sin(theta),
                          np.cos(theta) * np.cos(phi)], np.float32)
    right = np.array([np.sin(phi - np.pi * 0.5), 0.0, np.cos(phi - np.pi * 0.5)], np.float32)
    dev = pixel.device
    cpos = torch.as_tensor(np.asarray(position, np.float32), device=dev).to(dtype)
    cdir = torch.as_tensor(direction, device=dev).to(dtype)
    cright = torch.as_tensor(right, device=dev).to(dtype)
    cup = _cross(cdir, cright)
    state = init_state(pixel, sample, seed)
    state, jx = next_rand(state, dtype)
    state, jy = next_rand(state, dtype)
    px = (pixel % width).to(dtype)
    py = torch.div(pixel, width, rounding_mode="floor").to(dtype)
    point_x = (px + jx - 0.5) * recip32(width) - 0.5
    point_y = (py + jy - 0.5) * recip32(height) - 0.5
    tan_half = np.float32(np.tan(np.radians(fov_degrees) / 2.0))
    sx = float(np.float32(2.0) * tan_half * np.float32(width / height))
    sy = float(np.float32(2.0) * tan_half)
    d = (cdir[None, :] + point_x[:, None] * sx * cright[None, :]
         + point_y[:, None] * sy * cup[None, :])
    d = d / _norm(d)[:, None]
    o = cpos[None, :].expand(pixel.shape[0], 3)
    return o, d, state


# ---- Beckmann microfacet BSDF ---------------------------------------------------

def beckmann_lambda(tan_theta, alpha):
    a = 1.0 / torch.clamp(alpha * torch.abs(tan_theta), min=1e-30)
    val = (1.0 - 1.259 * a + 0.396 * a * a) / (3.535 * a + 2.181 * a * a)
    out = _where(a >= 1.6, 0.0, val, val)
    return _where(torch.isnan(tan_theta), 0.0, out, out)


def beckmann_lambda_r1(tan_theta):
    a = 1.0 / torch.clamp(torch.abs(tan_theta), min=1e-30)
    val = (1.0 - 1.259 * a + 0.396 * a * a) / (3.535 * a + 2.181 * a * a)
    return _where(a >= 1.6, 0.0, val, val)


def smith_g1(tan_theta, alpha):
    g = 1.0 / (1.0 + beckmann_lambda(tan_theta, alpha))
    return _where(torch.isinf(tan_theta), 0.0, g, g)


def smith_g(wi, wo, normal, alpha):
    cos_in = torch.abs(_dot(wi, normal))
    sin_in = sqrt_rn(torch.clamp(1.0 - cos_in * cos_in, min=0.0))
    cos_out = torch.abs(_dot(wo, normal))
    sin_out = sqrt_rn(torch.clamp(1.0 - cos_out * cos_out, min=0.0))
    tan_in = _where(torch.abs(cos_in) < 1e-5, 0.0, sin_in / torch.clamp(cos_in, min=1e-30),
                    cos_in)
    tan_out = _where(torch.abs(cos_out) < 1e-5, 0.0,
                     sin_out / torch.clamp(cos_out, min=1e-30), cos_out)
    return 1.0 / (1.0 + beckmann_lambda(tan_in, alpha) + beckmann_lambda(tan_out, alpha))


def beckmann_d(cos2_theta, sin2_theta, alpha):
    tan2 = torch.abs(sin2_theta / torch.clamp(cos2_theta, min=1e-30))
    a2 = alpha * alpha
    e = _ftz(torch.exp(-tan2 / a2))
    d = _ftz(e / (PI * a2 * torch.clamp(cos2_theta * cos2_theta, min=1e-30)))
    return _where(torch.isinf(tan2) | (cos2_theta <= 0.0), 0.0, d, d)


def erf_approx(x):
    """Abramowitz-Stegun 7.1.26 with the shaders' truncated 1.06104."""
    sign = 1.0 - (x < 0.0).to(x.dtype) * 2.0
    x = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = ((((1.06104 * t - 1.453152027) * t) + 1.421413741) * t - 0.284496736) * t + 0.254829592
    return sign * (1.0 - poly * t * torch.exp(-(x * x)))


def erf_inv_approx(x):
    """Giles' erfinv; the +-0.99 clamp keeps only its first branch."""
    x = torch.clamp(x, -0.99, 0.99)
    w = -torch.log(torch.clamp((1.0 - x) * (1.0 + x), min=1e-30))
    w = w - 2.5
    p = 2.81022636e-08
    for c in (3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
              -0.00125372503, -0.00417768164, 0.246640727, 1.50140941):
        p = c + p * w
    return p * x


def fresnel(cos_theta_i, eta_i, eta_t):
    """Dielectric Fresnel with the eta swap for back-side incidence."""
    flip = cos_theta_i < 0.0
    cur_i = _where(flip, float(eta_t), float(eta_i), cos_theta_i)
    cur_t = _where(flip, float(eta_i), float(eta_t), cos_theta_i)
    ci = torch.abs(cos_theta_i)
    sin_i = sqrt_rn(torch.clamp(1.0 - ci * ci, min=0.0))
    sin_t = cur_i * sin_i * _where(flip, recip32(eta_i), recip32(eta_t), ci)
    cos_t = sqrt_rn(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_par = (cur_t * ci - cur_i * cos_t) / (cur_t * ci + cur_i * cos_t)
    r_perp = (cur_i * ci - cur_t * cos_t) / (cur_i * ci + cur_t * cos_t)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return _where(sin_t >= 1.0, 1.0, f, f)


def power_heuristic(f_pdf, g_pdf):
    """f^2 / (f^2 + g^2) for one sample of each strategy."""
    f2 = _ftz(f_pdf * f_pdf) if isinstance(f_pdf, torch.Tensor) else f_pdf * f_pdf
    g2 = _ftz(g_pdf * g_pdf) if isinstance(g_pdf, torch.Tensor) else g_pdf * g_pdf
    den = torch.clamp(f2 + g2, min=1e-30)
    if not isinstance(f2, torch.Tensor):
        f2 = torch.full_like(den, f2)
    return f2 / den


def roughness_to_alpha(roughness):
    return ((9.12793 * roughness - 16.3381) * roughness + 9.84534) * roughness


def _half(incident, outgoing, normal):
    h = outgoing + incident
    h_len2 = _dot(h, h)
    h = _normalize(h)
    return torch.where((_dot(h, normal) < 0.0)[..., None], -h, h), h_len2


def microfacet_bsdf(incident, outgoing, normal, alpha, eta_i, eta_t):
    cos_i = torch.abs(_dot(incident, normal))
    cos_o = torch.abs(_dot(outgoing, normal))
    h, h_len2 = _half(incident, outgoing, normal)
    degenerate = (h_len2 < 1e-5) | (cos_i == 0.0) | (cos_o == 0.0)
    cos_h_i = torch.abs(_dot(incident, h))
    cos_hn = torch.clamp(_dot(h, normal), 0.0, 1.0)
    sin_hn2 = torch.clamp(1.0 - cos_hn * cos_hn, min=0.0)
    f = fresnel(cos_h_i, eta_i, eta_t)
    d = beckmann_d(cos_hn * cos_hn, sin_hn2, alpha)
    g = smith_g(outgoing, incident, normal, alpha)
    spec = _ftz(_ftz(d * f * g) / torch.clamp(4.0 * cos_i * cos_o, min=1e-30))
    diffuse = torch.clamp(alpha * alpha, max=1.0) * recip32(PI)
    out = spec + diffuse
    return _where(degenerate, 1.0, out, out)


def pdf_microfacet(incident, outgoing, normal, alpha):
    h, h_len2 = _half(incident, outgoing, normal)
    cos_oh_raw = _dot(outgoing, h)
    cos_oh = torch.clamp(torch.abs(cos_oh_raw), max=1.0)
    sin_oh = sqrt_rn(torch.clamp(1.0 - cos_oh * cos_oh, min=0.0))
    cos_hn = torch.clamp(torch.abs(_dot(h, normal)), max=1.0)
    sin_hn2 = torch.clamp(1.0 - cos_hn * cos_hn, min=0.0)
    d = beckmann_d(cos_hn * cos_hn, sin_hn2, alpha)
    g1 = smith_g1(sin_oh / torch.clamp(cos_oh, min=1e-30), alpha)
    pdf = _ftz(_ftz(d * g1 * torch.clamp(cos_oh_raw, min=0.0))
               / torch.clamp(torch.abs(_dot(outgoing, normal)) * 4.0 * cos_oh_raw, min=1e-30))
    return _where(h_len2 < 1e-5, 0.0, pdf, pdf)


def microfacet_weight(incident, outgoing, normal, alpha):
    h, h_len2 = _half(incident, outgoing, normal)
    cos_ih = torch.clamp(torch.abs(_dot(incident, h)), max=1.0)
    sin_ih = sqrt_rn(torch.clamp(1.0 - cos_ih * cos_ih, min=0.0))
    g = smith_g(incident, outgoing, normal, alpha)
    g1 = smith_g1(sin_ih / torch.clamp(cos_ih, min=1e-30), alpha)
    w = g / torch.clamp(g1, min=1e-30) + torch.clamp(alpha * alpha, max=1.0) * recip32(PI)
    return _where(h_len2 < 1e-5, 0.0, w, w)


def sample_microfacet(incident, normal, alpha, u1, u2):
    """Beckmann visible-normal sampling in slope space (the shaders'
    skewed tangent frame kept). Returns the microfacet normal."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    zero = torch.zeros_like(nx)
    main = torch.abs(nx) > -torch.abs(nz)
    t1 = _normalize(torch.where(main[..., None], torch.stack([-ny, nx, zero], dim=-1),
                                torch.stack([ny, -nz, zero], dim=-1)))
    t2 = _cross(normal, t1)
    local = torch.stack([_dot(incident, t1), _dot(incident, normal), _dot(incident, t2)],
                        dim=-1)
    w = _normalize(local)
    w = _normalize(w * torch.stack([alpha, torch.ones_like(alpha), alpha], dim=-1))
    cos_theta = torch.abs(w[..., 1])
    sin_theta = sqrt_rn(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    w1 = w[..., 1]
    tan_theta = sin_theta / torch.where(torch.abs(w1) < 1e-30,
                                        torch.sign(w1) * 1e-30 + 1e-38, w1)
    cot_theta = 1.0 / _where(torch.abs(tan_theta) < 1e-30, 1e-30, tan_theta, tan_theta)
    cos_phi = torch.clamp(w[..., 0] / torch.clamp(sin_theta, min=1e-6), -1.0, 1.0)
    sin_phi = torch.clamp(-w[..., 2] / torch.clamp(sin_theta, min=1e-6), -1.0, 1.0)
    erf_cot = erf_approx(cot_theta)
    c = 1.0 - (1.0 / (1.0 + beckmann_lambda_r1(tan_theta))) * erf_cot
    # branch A: u1 < c
    u1a = u1 / torch.clamp(c, min=1e-30)
    omega1 = _INV_2_SQRT_PI * sin_theta * torch.exp(-torch.clamp(cot_theta * cot_theta, max=80.0))
    omega2 = cos_theta * (0.5 - 0.5 * erf_cot)
    p_a = omega1 / torch.clamp(omega1 + omega2, min=1e-30)
    u1a1 = u1a / torch.clamp(p_a, min=1e-30)
    xm_a1 = -sqrt_rn(torch.clamp(-torch.log(torch.clamp(
        u1a1 * torch.exp(-torch.clamp(cot_theta * cot_theta, max=80.0)), min=1e-38)), min=0.0))
    u1a2 = (u1a - p_a) / torch.clamp(1.0 - p_a, min=1e-30)
    xm_a2 = erf_inv_approx(u1a2 - 1.0 - u1a2 * erf_cot)
    xm_a = torch.where(u1a < p_a, xm_a1, xm_a2)
    # branch B: u1 >= c
    u1b = (u1 - c) / torch.clamp(1.0 - c, min=1e-30)
    xm_b0 = erf_inv_approx((-1.0 + 2.0 * u1b) * erf_cot)
    p_b = (-xm_b0 * sin_theta + cos_theta) / torch.clamp(2.0 * cos_theta, min=1e-30)
    flip = u2 >= p_b
    u2_b = torch.where(flip, (u2 - p_b) / torch.clamp(1.0 - p_b, min=1e-30),
                       u2 / torch.clamp(p_b, min=1e-30))
    xm_b = torch.where(flip, -xm_b0, xm_b0)
    in_a = u1 < c
    x_m = torch.where(in_a, xm_a, xm_b)
    z_m = erf_inv_approx(torch.where(in_a, u2, u2_b) * 2.0 - 1.0)
    slope_x = -(cos_phi * x_m - sin_phi * z_m) * alpha
    slope_y = -(sin_phi * x_m + cos_phi * z_m) * alpha
    h = _normalize(torch.stack([slope_x, torch.ones_like(slope_x), -slope_y], dim=-1))
    return h[..., 0:1] * t1 + h[..., 1:2] * normal + h[..., 2:3] * t2


def reflect(d, n):
    return d - 2.0 * _dot(d, n)[..., None] * n


# ---- sphere lights ----------------------------------------------------------------

def sample_hemisphere_uniform(normal, u1, u2):
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    cond = torch.abs(nx) > torch.abs(ny)
    zero = torch.zeros_like(nx)
    t1 = _normalize(torch.where(cond[..., None], torch.stack([-ny, zero, nx], dim=-1),
                                torch.stack([ny, zero, -nz], dim=-1)))
    t2 = _cross(normal, t1)
    m = sqrt_rn(torch.clamp(1.0 - u1 * u1, min=0.0))
    vx = torch.cos(2.0 * PI * u2) * m
    vz = -torch.sin(2.0 * PI * u2) * m
    return _normalize(vx[..., None] * t1 + u1[..., None] * normal - vz[..., None] * t2)


def sample_sphere(origin, light_pos, radius, u1, u2):
    """Cone sampling of a sphere light seen from outside; from inside,
    the shaders' raw local vector."""
    otc = light_pos - origin
    dist2 = _dot(otc, otc)
    r_in = sqrt_rn(torch.clamp(u1 * (1.0 - u1), min=0.0))
    inside_vec = torch.stack([2.0 * torch.cos(2.0 * PI * u2) * r_in,
                              2.0 * torch.sin(2.0 * PI * u2) * r_in, u2 * 2.0 - 1.0], dim=-1)
    sin_theta_max2 = (radius * radius) / torch.clamp(dist2, min=1e-30)
    cos_theta_max = sqrt_rn(torch.clamp(1.0 - sin_theta_max2, min=0.0))
    cos_theta = (1.0 - u1) + u1 * cos_theta_max
    sin_theta = sqrt_rn(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = u2 * 2.0 * PI
    dc = sqrt_rn(torch.clamp(dist2, min=1e-30))
    ds = dc * cos_theta - sqrt_rn(torch.clamp(radius * radius - dist2 * sin_theta * sin_theta,
                                              min=0.0))
    cos_alpha = (dist2 + radius * radius - ds * ds) / torch.clamp(2.0 * dc * radius, min=1e-30)
    sin_alpha = sqrt_rn(torch.clamp(1.0 - cos_alpha * cos_alpha, min=0.0))
    otc_n = _normalize(otc)
    ox, oy, oz = otc_n[..., 0], otc_n[..., 1], otc_n[..., 2]
    cond = torch.abs(ox) > torch.abs(oy)
    zero = torch.zeros_like(ox)
    o1 = _normalize(torch.where(cond[..., None], torch.stack([oy, -ox, zero], dim=-1),
                                torch.stack([zero, -oy, oz], dim=-1)))
    o2 = _cross(otc_n, o1)
    on_sphere = ((sin_alpha * torch.cos(phi))[..., None] * o1
                 + torch.abs(cos_alpha)[..., None] * otc_n
                 - (sin_alpha * torch.sin(phi))[..., None] * o2)
    outside_vec = _normalize(-on_sphere * radius[..., None] + light_pos - origin)
    inside = torch.abs(dist2) < radius * radius
    return torch.where(inside[..., None], inside_vec, outside_vec)


def pdf_sphere(origin, direction, light_pos, radius):
    otc = light_pos - origin
    cto = origin - light_pos
    dist2 = _dot(otc, otc)
    sd = _dot(direction, cto)
    disc = sd * sd - (_dot(cto, cto) - radius * radius)
    inside = dist2 < radius * radius
    pdf_inside = 1.0 / (4.0 * PI * radius * radius)
    cos_theta_max = sqrt_rn(torch.clamp(1.0 - (radius * radius) / torch.clamp(dist2, min=1e-30),
                                        min=0.0))
    pdf_outside = 1.0 / torch.clamp(2.0 * PI * (1.0 - cos_theta_max), min=1e-30)
    pdf = torch.where(inside, pdf_inside, pdf_outside)
    return _where(disc < 0.0, 0.0, pdf, pdf)


def intersect_spheres(o, d, lights, t_max):
    """Nearest sphere light past t = 0 (the shaders' q-form test, without
    its 1/2 factors). Returns (hit, t, light id)."""
    best_t = torch.full((o.shape[0],), float("inf"), dtype=o.dtype, device=o.device)
    best = torch.zeros(o.shape[0], dtype=torch.long, device=o.device)
    for i in range(lights.shape[0]):
        cto = o - lights[i, :3]
        b = _dot(d, cto)
        c = _dot(cto, cto) - lights[i, 3] * lights[i, 3]
        b2 = 2.0 * b
        disc = b2 * b2 - 4.0 * c
        sq = sqrt_rn(torch.clamp(disc, min=0.0))
        q = torch.where(b > 0.0, -b - sq, -b + sq)
        q_safe = torch.where(q == 0.0, torch.full_like(q, 1e-20), q)
        t = torch.minimum(q, c / q_safe)
        hit = (disc >= 0.0) & (t > 0.0) & (t < t_max)
        t = torch.where(hit, t, torch.full_like(t, float("inf")))
        nearer = t < best_t
        best_t = torch.where(nearer, t, best_t)
        best = torch.where(nearer, torch.full_like(best, i), best)
    return torch.isfinite(best_t), best_t, best


# ---- textures from the raw images ---------------------------------------------------

def _wrap(i, size, mode):
    rep = torch.remainder(i, size)
    m = torch.remainder(i, 2 * size)
    mir = torch.where(m < size, m, 2 * size - 1 - m)
    clamped = torch.minimum(torch.clamp(i, min=0), size - 1)
    return torch.where(mode == 0, rep, torch.where(mode == 1, mir, clamped))


def _texel(scene, info, x, y):
    idx = info[:, 0] + _wrap(y, info[:, 2], info[:, 5]) * info[:, 1] + _wrap(x, info[:, 1],
                                                                             info[:, 4])
    return scene.texels[idx]


def sample_texture(scene: RefScene, tex, u, v):
    """(N, 4) linear texels of texture `tex` at (u, v); rgb sRGB-decoded
    where the image is sRGB."""
    dt = u.dtype
    info = scene.tex_info[torch.clamp(tex, 0, scene.tex_info.shape[0] - 1)]
    linear = info[:, 3] == 1
    x = u * info[:, 1].to(dt)
    y = v * info[:, 2].to(dt)
    x = torch.where(linear, x - 0.5, torch.floor(x))
    y = torch.where(linear, y - 0.5, torch.floor(y))
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    xi, yi = x0.long(), y0.long()

    def fetch(a, b):
        return _texel(scene, info, a, b).to(dt) * (1.0 / 255.0)

    c00, c10, c01, c11 = fetch(xi, yi), fetch(xi + 1, yi), fetch(xi, yi + 1), fetch(xi + 1,
                                                                                  yi + 1)
    out = c00 * (1 - fx) * (1 - fy) + c10 * fx * (1 - fy) + c01 * (1 - fx) * fy + c11 * fx * fy
    rgb = out[:, :3]
    dec = torch.where(rgb <= 0.04045, rgb * recip32(12.92),
                      torch.pow((rgb + 0.055) * recip32(1.055), 2.4))
    rgb = torch.where((info[:, 6] == 1)[:, None], dec, rgb)
    return torch.cat([rgb, out[:, 3:4]], dim=-1)


def texture_alpha(scene: RefScene, tex, u, v):
    """Alpha of the NEAREST texel at (u, v): the any-hit test's tap."""
    dt = u.dtype
    info = scene.tex_info[torch.clamp(tex, 0, scene.tex_info.shape[0] - 1)]
    x = torch.floor(u * info[:, 1].to(dt)).long()
    y = torch.floor(v * info[:, 2].to(dt)).long()
    return _texel(scene, info, x, y)[:, 3].to(dt) * (1.0 / 255.0)


def alpha_rejected(scene: RefScene, tri, u, v):
    """True where the alpha test rejects a hit of triangle `tri` at (u, v)."""
    uv = _bary(1.0 - u - v, u, v, scene.uv[tri])
    m = scene.mat[tri]
    tex = scene.tex[m, 0]
    a = texture_alpha(scene, tex, uv[:, 0], uv[:, 1])
    a = torch.where(tex == NO_TEXTURE, torch.ones_like(a), a)
    return scene.alpha_tri[tri] & (a < scene.cutoff[m])


# ---- every ray against every triangle ------------------------------------------------

def _chunk_hits(scene: RefScene, o, d, c0, c1, t_lo, t_hi):
    """(hit, t, u, v) of every ray against triangles c0:c1, t in (t_lo,
    t_hi), in the traversal kernels' expression order."""
    v0, e1, e2 = (x[c0:c1].T for x in (scene.v0, scene.e1, scene.e2))
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    px = dy * e2[2] - dz * e2[1]
    py = dz * e2[0] - dx * e2[2]
    pz = dx * e2[1] - dy * e2[0]
    det = e1[0] * px + e1[1] * py + e1[2] * pz
    ok = torch.abs(det) > 1e-12
    inv_det = torch.where(ok, torch.reciprocal(torch.where(ok, det, torch.ones_like(det))),
                          torch.zeros_like(det))
    tx, ty, tz = ox - v0[0], oy - v0[1], oz - v0[2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[2] - tz * e1[1]
    qy = tz * e1[0] - tx * e1[2]
    qz = tx * e1[1] - ty * e1[0]
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2[0] * qx + e2[1] * qy + e2[2] * qz) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > t_lo[:, None]) & (t < t_hi[:, None])
    cols = torch.nonzero(scene.alpha_tri[c0:c1], as_tuple=True)[0]
    if cols.numel():
        r, k = torch.nonzero(hit[:, cols], as_tuple=True)
        if r.numel():
            kc = cols[k]
            rej = alpha_rejected(scene, kc + c0, u[r, kc], v[r, kc])
            hit[r[rej], kc[rej]] = False
    return hit, t, u, v


def closest_hit(scene: RefScene, o, d, t_max, include_spheres):
    """(t, triangle id or -1, u, v, sphere hit?, sphere id) of each ray."""
    n = o.shape[0]
    num = scene.v0.shape[0]
    t_best = torch.full((n,), t_max, dtype=o.dtype, device=o.device)
    prim = torch.full((n,), -1, dtype=torch.long, device=o.device)
    u_best = torch.zeros_like(t_best)
    v_best = torch.zeros_like(t_best)
    t_lo = torch.zeros_like(t_best)
    chunk = max(1, min(num, CHUNK_ELEMENTS // max(n, 1)))
    for c0 in range(0, num, chunk):
        c1 = min(c0 + chunk, num)
        hit, t, u, v = _chunk_hits(scene, o, d, c0, c1, t_lo, t_best)
        t_hit = torch.where(hit, t, torch.full_like(t, float("inf")))
        t_chunk = torch.amin(t_hit, dim=1)
        ids = torch.arange(c1 - c0, device=o.device)
        first = torch.amin(torch.where(t_hit == t_chunk[:, None], ids[None, :], c1 - c0),
                           dim=1, keepdim=True)
        take = t_chunk < t_best
        t_best = torch.where(take, t_chunk, t_best)
        prim = torch.where(take, first[:, 0] + c0, prim)
        u_best = torch.where(take, torch.gather(u, 1, first)[:, 0], u_best)
        v_best = torch.where(take, torch.gather(v, 1, first)[:, 0], v_best)
    s_hit = torch.zeros(n, dtype=torch.bool, device=o.device)
    s_id = torch.zeros(n, dtype=torch.long, device=o.device)
    if include_spheres and scene.lights.shape[0]:
        s_hit, s_t, s_id = intersect_spheres(o, d, scene.lights, t_max)
        s_hit = s_hit & (s_t < t_best)
        t_best = torch.where(s_hit, s_t, t_best)
        prim = torch.where(s_hit, torch.full_like(prim, -1), prim)
    return t_best, prim, u_best, v_best, s_hit, s_id


def occluded(scene: RefScene, o, d, t_limit):
    """True where a triangle that the alpha test keeps lies in (0, t_limit)."""
    n = o.shape[0]
    num = scene.v0.shape[0]
    blocked = torch.zeros(n, dtype=torch.bool, device=o.device)
    t_lo = torch.zeros_like(t_limit)
    chunk = max(1, min(num, CHUNK_ELEMENTS // max(n, 1)))
    for c0 in range(0, num, chunk):
        c1 = min(c0 + chunk, num)
        hit, _, _, _ = _chunk_hits(scene, o, d, c0, c1, t_lo, t_limit)
        blocked = blocked | hit.any(dim=1)
    return blocked


# ---- the estimator -------------------------------------------------------------------

class Settings(NamedTuple):
    """The renderer's settings that the estimator reads (its defaults
    are the original renderer's)."""

    max_depth: int = 7
    t_max: float = 999999999.0
    ray_offset: float = 0.01
    rr_threshold: float = 0.995
    sky: tuple = (0.4, 0.5, 0.6)
    eta_i: float = 1.0
    eta_t: float = 1.5
    emissive_untextured_scale: float = 200.0


def _shade(scene: RefScene, o, d, t, prim, u, v):
    """Hit point, shading normal, albedo, emission and Beckmann alpha."""
    w0 = 1.0 - u - v
    uv = _bary(w0, u, v, scene.uv[prim])
    normal = _normalize(_bary(w0, u, v, scene.normal[prim]))
    tan4 = _bary(w0, u, v, scene.tangent[prim])
    tangent = _normalize(tan4[:, :3])
    hit_point = o + t[:, None] * d
    m = scene.mat[prim]
    tex = scene.tex[m]
    albedo = scene.albedo[m]
    texel = sample_texture(scene, tex[:, 0], uv[:, 0], uv[:, 1])
    albedo = torch.where((tex[:, 0] != NO_TEXTURE)[:, None], albedo * texel[:, :3], albedo)
    nf = scene.normal_scale[m]
    texel_n = sample_texture(scene, tex[:, 2], uv[:, 0], uv[:, 1])
    nm = (texel_n[:, :3] * 2.0 - 1.0) * nf[:, None]
    bitangent = _cross(normal, tangent) * tan4[:, 3:4]
    mapped = _normalize(nm[:, 0:1] * tangent + nm[:, 1:2] * bitangent + nm[:, 2:3] * normal)
    use_nm = (tex[:, 2] != NO_TEXTURE) & (torch.abs(nf) > 0.001)
    shading_n = torch.where(use_nm[:, None], mapped, normal)
    mat_e = scene.emissive[m]
    texel_e = sample_texture(scene, tex[:, 3], uv[:, 0], uv[:, 1])
    emissive = torch.where((tex[:, 3] != NO_TEXTURE)[:, None], texel_e[:, :3] * mat_e,
                           mat_e * float(np.float32(200.0)))
    texel_mr = sample_texture(scene, tex[:, 1], uv[:, 0], uv[:, 1])
    roughness = scene.roughness[m] * torch.where(tex[:, 1] != NO_TEXTURE, texel_mr[:, 1],
                                                 torch.ones_like(texel_mr[:, 1]))
    return hit_point, shading_n, albedo, emissive, roughness_to_alpha(roughness)


def _shadow(scene: RefScene, cfg: Settings, o, d, throughput):
    """The NEE ray's payload: (rgb, code 1 blocked / 0 light / -4 sky,
    missed everything?)."""
    t_max = float(np.float32(cfg.t_max))
    nl = scene.lights.shape[0]
    if nl:
        s_hit, s_t, s_id = intersect_spheres(o, d, scene.lights, t_max)
    else:
        s_hit = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        s_t = torch.full_like(throughput, t_max)
        s_id = torch.zeros(o.shape[0], dtype=torch.long, device=o.device)
    t_limit = torch.where(s_hit, s_t, torch.full_like(s_t, t_max))
    blocked = occluded(scene, o, d, t_limit)
    sky = torch.tensor(cfg.sky, dtype=o.dtype, device=o.device)
    if nl:
        light = scene.lights[torch.clamp(s_id, 0, nl - 1)]
        light_rgb = light[:, 4:7] * light[:, 7:8] * throughput[:, None]
    else:
        light_rgb = torch.zeros_like(o)
    sky_rgb = sky[None, :] * throughput[:, None]
    hit_sphere = s_hit & ~blocked
    is_miss = ~blocked & ~s_hit
    rgb = torch.where(blocked[:, None], torch.zeros_like(sky_rgb),
                      torch.where(hit_sphere[:, None], light_rgb, sky_rgb))
    a = torch.where(blocked, torch.ones_like(t_limit),
                    torch.where(hit_sphere, torch.zeros_like(t_limit),
                                torch.full_like(t_limit, -4.0)))
    return rgb, a, is_miss


def _shade_and_nee(scene: RefScene, cfg: Settings, o, d, state, thr, t, prim, u, v):
    """The per-hit block: shading, the light sample and its MIS weight,
    the bounce, Russian roulette and the folded BSDF weight."""
    dt = o.dtype
    nl = scene.lights.shape[0]
    n = o.shape[0]
    off = float(np.float32(cfg.ray_offset))
    hit_point, sn, albedo, emissive, alpha = _shade(scene, o, d, t, prim, u, v)
    # the light sample: pick, two uniforms, the dead pick of the BSDF
    # sample and its two uniforms
    state, u_pick = next_rand(state, dt)
    light_idx = torch.clamp((u_pick * float(nl + 1)).to(torch.int32), max=nl).long()
    pick_env = light_idx >= nl
    state, u1 = next_rand(state, dt)
    state, u2 = next_rand(state, dt)
    if nl:
        lt = scene.lights[torch.clamp(light_idx, 0, nl - 1)]
        dir_sphere = sample_sphere(hit_point, lt[:, :3], lt[:, 3], u1, u2)
    else:
        lt = torch.zeros((n, 8), dtype=dt, device=o.device)
        dir_sphere = torch.zeros_like(o)
    dir1 = torch.where(pick_env[:, None], sample_hemisphere_uniform(sn, u1, u2), dir_sphere)
    nee_o = hit_point + off * sn
    for _ in range(3):
        state, _unused = next_rand(state, dt)
    wo = -d
    al_b = torch.clamp(alpha, min=0.01)
    # the bounce and Russian roulette
    state, u5 = next_rand(state, dt)
    state, u6 = next_rand(state, dt)
    micro = sample_microfacet(wo, sn, alpha, u5, u6)
    micro = torch.where((alpha > 0.0)[:, None], micro, sn)
    bounce = reflect(d, micro)
    t_new = thr * microfacet_weight(bounce, wo, sn, al_b)
    rr_w = 1.0 - torch.clamp(t_new, min=float(np.float32(cfg.rr_threshold)))
    state, u_rr = next_rand(state, dt)
    killed = u_rr < rr_w
    t_new = t_new / torch.clamp(1.0 - rr_w, min=1e-30)
    below = _dot(bounce, sn) < 0.0
    offset = torch.where(below[:, None], off * (-bounce) / torch.clamp(_norm(bounce),
                                                                       min=1e-20)[:, None],
                         off * sn)
    # the light sample's ray and its MIS weight
    rgb1, a1, miss1 = _shadow(scene, cfg, nee_o, dir1, thr)
    al_l = torch.clamp(alpha, min=0.00001)
    f1 = microfacet_bsdf(dir1, wo, sn, al_l, cfg.eta_i, cfg.eta_t)
    p1 = pdf_microfacet(dir1, wo, sn, al_l)
    lp = pdf_sphere(hit_point, dir1, lt[:, :3], lt[:, 3]) if nl else torch.zeros_like(p1)
    vis1 = torch.clamp(1.0 - torch.clamp(a1, min=0.0), min=0.0)
    cos1 = torch.abs(_dot(dir1, sn))
    w_light = f1 * cos1 * vis1 * power_heuristic(lp, p1) / torch.clamp(lp, min=1e-30)
    w_light = torch.where((lp <= 0.0) | (p1 <= 0.0), torch.zeros_like(w_light), w_light)
    al_e = torch.clamp(alpha, min=0.001)
    fe = microfacet_bsdf(dir1, wo, sn, al_e, cfg.eta_i, cfg.eta_t)
    pe = pdf_microfacet(dir1, wo, sn, al_e)
    w_env = fe * cos1 * (a1 < -1.0).to(dt) * power_heuristic(_ENV_PDF, pe) * recip32(_ENV_PDF)
    w_env = torch.where(pe <= 0.0, torch.zeros_like(w_env), w_env)
    nee = torch.where(pick_env[:, None], w_env[:, None] * rgb1, w_light[:, None] * rgb1)
    local = emissive + nee * float(nl + 1)
    # the BSDF sample's MIS weight, folded into the bounce ray
    pdf_q = pdf_microfacet(bounce, wo, sn, al_b)
    w = microfacet_weight(bounce, wo, sn, al_b) * power_heuristic(pdf_q, _ENV_PDF)
    w = torch.where(pdf_q <= 0.000005, torch.zeros_like(w), w)
    w = torch.where(torch.isnan(bounce).any(dim=-1), torch.zeros_like(w), w)
    needs_ratio = (alpha > 0.0) & (alpha < 0.01)
    pdf_s = pdf_microfacet(bounce, wo, sn, torch.clamp(alpha, min=1e-8))
    ratio = torch.where(needs_ratio, torch.where(pdf_s > 0.0, pdf_q / torch.clamp(pdf_s, min=1e-30),
                                                 torch.zeros_like(pdf_q)),
                        torch.ones_like(pdf_q))
    fold_w = w * ratio * float(nl + 1) * thr
    return (state, miss1.to(torch.long), local, bounce, t_new, killed, hit_point + offset,
            albedo, fold_w)


def radiance(scene: RefScene, cfg: Settings, o, d, state):
    """(N, 3) radiance of the camera rays (o, d) with their streams."""
    n = o.shape[0]
    dev, dt = o.device, o.dtype
    t_max = float(np.float32(cfg.t_max))
    out = torch.zeros((n, 3), dtype=dt, device=dev)
    throughput = torch.ones(n, dtype=dt, device=dev)
    albedo_prod = torch.ones((n, 3), dtype=dt, device=dev)
    depth = torch.zeros(n, dtype=torch.long, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    mis_coeff = torch.zeros((n, 3), dtype=dt, device=dev)
    sky = torch.tensor(cfg.sky, dtype=dt, device=dev)
    wave = 0
    while True:
        pending = (mis_coeff != 0.0).any(dim=-1)
        ti = torch.nonzero(active | pending, as_tuple=True)[0]
        if ti.numel() == 0:
            break
        t_c, prim_c, u_c, v_c, sph_c, _ = closest_hit(scene, o[ti], d[ti], t_max, wave > 0)
        tri_full = torch.zeros(n, dtype=torch.bool, device=dev)
        miss_full = torch.zeros(n, dtype=torch.bool, device=dev)
        tri_full[ti] = prim_c >= 0
        miss_full[ti] = (prim_c < 0) & ~sph_c
        is_tri = active & tri_full
        is_miss = active & miss_full
        zero3 = torch.zeros_like(out)
        out = out + torch.where((pending & miss_full)[:, None], mis_coeff * sky[None, :], zero3)
        if wave == 0:
            out = out + torch.where(is_miss[:, None], sky[None, :] * throughput[:, None], zero3)
        si = torch.nonzero(is_tri, as_tuple=True)[0]
        pos = torch.full((n,), -1, dtype=torch.long, device=dev)
        pos[ti] = torch.arange(ti.numel(), device=dev)
        k = pos[si]
        (st, miss_inc, local, bounce, t_new, killed, new_o, alb, fold_w) = _shade_and_nee(
            scene, cfg, o[si], d[si], state[si], throughput[si], t_c[k], prim_c[k], u_c[k],
            v_c[k])
        state = state.clone()
        state[si] = st

        def full(part, like):
            x = torch.zeros_like(like)
            x[si] = part
            return x

        depth = depth + full(miss_inc, depth)
        can_bounce = depth < cfg.max_depth
        depth = depth + is_tri.to(torch.long)
        killed = full(killed, active)
        dead_by_rr = is_tri & can_bounce & killed
        add = is_tri & ~dead_by_rr
        alb = full(alb, out)
        out = out + torch.where(add[:, None], albedo_prod * alb * full(local, out), zero3)
        mis_coeff = torch.where(add[:, None], albedo_prod * alb * full(fold_w, throughput)[:, None],
                                zero3)
        cont = is_tri & can_bounce & ~killed
        upd = cont | add
        o = torch.where(upd[:, None], full(new_o, out), o)
        d = torch.where(upd[:, None], full(bounce, out), d)
        albedo_prod = torch.where(cont[:, None], albedo_prod * alb, albedo_prod)
        throughput = torch.where(cont, full(t_new, throughput), throughput)
        active = cont
        wave += 1
    return out


def launch_radiance(scene: RefScene, cfg: Settings, cam, pixels, samples, seed, width,
                    height, fov_degrees):
    """Radiance of each (pixel, sample) pair: (N, 3)."""
    o, d, state = camera_rays(cam, pixels, samples, seed, width, height, fov_degrees,
                              scene.v0.dtype)
    return radiance(scene, cfg, o, d, state)


# ---- the film -------------------------------------------------------------------------

def accumulate(prev, new, count):
    """The per-launch running average: prev*(1-1/N) + new/N in float32
    once N > 1, NaN pixels painted red. `new` is (N, 3); the result
    (N, 3)."""
    c = np.float32(count)
    inv = float(np.float32(1.0) / c)
    out = prev * float(np.float32(1.0) - np.float32(inv)) + new * inv if c > 1.0 else new.clone()
    red = torch.tensor([1.0, 0.0, 0.0], dtype=out.dtype, device=out.device)
    return torch.where(torch.isnan(out).any(dim=-1, keepdim=True), red, out)


def tonemap_srgb8(accum, exposure):
    """The exposure tonemap, gamma 1/2.2, then 8 bits, as the viewer
    shows a frame: (N, 3) uint8 on the host."""
    mapped = 1.0 - torch.exp(-accum * float(np.float32(exposure)))
    mapped = torch.pow(torch.clamp(mapped, 0.0, 1.0), float(np.float32(1.0 / 2.2)))
    arr = mapped.detach().float().cpu().numpy()
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
