"""Beckmann microfacet BSDF (the counterpart of tpurt/kernels/bsdf.py):
distribution, masking, Fresnel, visible-normal sampling, pdf and weight,
with every quirk of the reference kept (the truncated A&S `erf`, the
dead erfinv branch, the skewed sampling frame, the diffuse floor).

Dot products, cross products and norms are written out component by
component, in the order XLA evaluates tpurt's `jnp.sum(a * b, -1)`, so
they round the same on the CPU and on the card (a library reduction may
sum in another order there).
"""

from __future__ import annotations

import numpy as np
import torch

from tpurt_torch.utils.profiling import host_sync

PI = 3.14159265358979323846
_FLT_MIN = 1.1754943508222875e-38  # smallest normal float32
# 1 / (2 sqrt(pi)) evaluated in float32, as tpurt's `jnp.sqrt(PI)` does
_INV_2_SQRT_PI = float(np.float32(1.0) / (np.float32(2.0) * np.sqrt(np.float32(PI))))


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def recip32(c) -> float:
    """1/c rounded to float32. XLA compiles tpurt's division by a constant,
    `x / c`, as the multiplication `x * recip32(c)` (its algebraic
    simplifier inverts constant divisors), so the port writes that
    multiplication where tpurt divides by a constant that is not a power
    of two."""
    return float(np.float32(1.0) / np.float32(c))


def sqrt_rn(x):
    """The IEEE-754 float32 square root (correctly rounded), which XLA and
    the card's sqrtf compute. PyTorch's CPU float32 sqrt is off by an ulp
    on about 0.7% of inputs; the float64 root rounded to float32 is exact
    (rounding a square root from 53 bits to 24 is innocuous)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _norm(v):
    return sqrt_rn(_dot(v, v))


def _normalize(v, eps=1e-20):
    return v / torch.clamp(_norm(v), min=eps)[..., None]


def _ftz(x):
    """Flush float32 denormals to zero. tpurt's backends do so for every
    operation (the TPU has no denormals; XLA's CPU backend runs with
    flush-to-zero), PyTorch does not, on the CPU or the card. Where an
    underflowing Beckmann term decides a branch (a pdf that is denormal in
    PyTorch is 0 in tpurt, and `pdf <= 0` then drops the whole MIS term),
    the port flushes explicitly."""
    return torch.where(torch.abs(x) < _FLT_MIN, torch.zeros_like(x), x)


def _where(c, a, b):
    """torch.where that accepts Python floats on either side; each float
    is a copy from the host, which waits for the stream on a card."""
    if not isinstance(a, torch.Tensor):
        with host_sync("scalar_h2d"):
            a = torch.tensor(a, dtype=torch.float32, device=c.device)
    if not isinstance(b, torch.Tensor):
        with host_sync("scalar_h2d"):
            b = torch.tensor(b, dtype=torch.float32, device=c.device)
    return torch.where(c, a, b)


def beckmann_lambda(tan_theta, alpha):
    a = 1.0 / torch.clamp(alpha * torch.abs(tan_theta), min=1e-30)
    val = (1.0 - 1.259 * a + 0.396 * a * a) / (3.535 * a + 2.181 * a * a)
    out = _where(a >= 1.6, 0.0, val)
    return _where(torch.isnan(tan_theta), 0.0, out)


def beckmann_lambda_r1(tan_theta):
    a = 1.0 / torch.clamp(torch.abs(tan_theta), min=1e-30)
    val = (1.0 - 1.259 * a + 0.396 * a * a) / (3.535 * a + 2.181 * a * a)
    return _where(a >= 1.6, 0.0, val)


def smith_g1(tan_theta, alpha):
    g = 1.0 / (1.0 + beckmann_lambda(tan_theta, alpha))
    return _where(torch.isinf(tan_theta), 0.0, g)


def smith_g1_r1(tan_theta):
    return 1.0 / (1.0 + beckmann_lambda_r1(tan_theta))


def smith_g(wi, wo, normal, alpha):
    cos_in = torch.abs(_dot(wi, normal))
    sin_in = sqrt_rn(torch.clamp(1.0 - cos_in * cos_in, min=0.0))
    cos_out = torch.abs(_dot(wo, normal))
    sin_out = sqrt_rn(torch.clamp(1.0 - cos_out * cos_out, min=0.0))
    tan_in = _where(torch.abs(cos_in) < 1e-5, 0.0, sin_in / torch.clamp(cos_in, min=1e-30))
    tan_out = _where(torch.abs(cos_out) < 1e-5, 0.0, sin_out / torch.clamp(cos_out, min=1e-30))
    return 1.0 / (1.0 + beckmann_lambda(tan_in, alpha) + beckmann_lambda(tan_out, alpha))


def beckmann_d(cos2_theta, sin2_theta, alpha):
    tan2 = torch.abs(sin2_theta / torch.clamp(cos2_theta, min=1e-30))
    a2 = alpha * alpha
    e = _ftz(torch.exp(-tan2 / a2))
    d = _ftz(e / (PI * a2 * torch.clamp(cos2_theta * cos2_theta, min=1e-30)))
    return _where(torch.isinf(tan2) | (cos2_theta <= 0.0), 0.0, d)


def erf_approx(x):
    """Abramowitz-Stegun 7.1.26 with the reference's truncated 1.06104."""
    sign = 1.0 - (x < 0.0).to(x.dtype) * 2.0
    x = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = ((((1.06104 * t - 1.453152027) * t) + 1.421413741) * t - 0.284496736) * t + 0.254829592
    return sign * (1.0 - poly * t * torch.exp(-(x * x)))


def erf_inv_approx(x):
    """Giles erfinv; the +-0.99 clamp keeps only the first branch live."""
    x = torch.clamp(x, -0.99, 0.99)
    w = -torch.log(torch.clamp((1.0 - x) * (1.0 + x), min=1e-30))
    w = w - 2.5
    p = 2.81022636e-08
    p = 3.43273939e-07 + p * w
    p = -3.5233877e-06 + p * w
    p = -4.39150654e-06 + p * w
    p = 0.00021858087 + p * w
    p = -0.00125372503 + p * w
    p = -0.00417768164 + p * w
    p = 0.246640727 + p * w
    p = 1.50140941 + p * w
    return p * x


def fresnel(cos_theta_i, eta_i=1.0, eta_t=1.5):
    """Dielectric Fresnel with eta swap for back-side incidence."""
    flip = cos_theta_i < 0.0
    cur_eta_i = _where(flip, float(eta_t), float(eta_i))
    cur_eta_t = _where(flip, float(eta_i), float(eta_t))
    ci = torch.abs(cos_theta_i)
    sin_i = sqrt_rn(torch.clamp(1.0 - ci * ci, min=0.0))
    sin_t = cur_eta_i * sin_i * _where(flip, recip32(eta_i), recip32(eta_t))
    cos_t = sqrt_rn(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_par = (cur_eta_t * ci - cur_eta_i * cos_t) / (cur_eta_t * ci + cur_eta_i * cos_t)
    r_perp = (cur_eta_i * ci - cur_eta_t * cos_t) / (cur_eta_i * ci + cur_eta_t * cos_t)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return _where(sin_t >= 1.0, 1.0, f)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """f^2 / (f^2 + g^2). A Python-float numerator is made a tensor first:
    torch evaluates `float / tensor` as `tensor.reciprocal() * float`,
    which rounds twice."""
    a = nf * f_pdf
    b = ng * g_pdf
    f2 = _ftz(a * a) if isinstance(a, torch.Tensor) else a * a
    g2 = _ftz(b * b) if isinstance(b, torch.Tensor) else b * b
    den = torch.clamp(f2 + g2, min=1e-30)
    if not isinstance(f2, torch.Tensor):
        f2 = torch.full_like(den, f2)
    return f2 / den


def roughness_to_alpha(roughness):
    return ((9.12793 * roughness - 16.3381) * roughness + 9.84534) * roughness


def microfacet_bsdf(incident, outgoing, normal, alpha, eta_i=1.0, eta_t=1.5):
    cos_i = torch.abs(_dot(incident, normal))
    cos_o = torch.abs(_dot(outgoing, normal))
    h = outgoing + incident
    h_len2 = _dot(h, h)
    degenerate = (h_len2 < 1e-5) | (cos_i == 0.0) | (cos_o == 0.0)
    h = _normalize(h)
    h = torch.where((_dot(h, normal) < 0.0)[..., None], -h, h)
    cos_h_i = torch.abs(_dot(incident, h))
    cos_hn = torch.clamp(_dot(h, normal), 0.0, 1.0)
    sin_hn2 = torch.clamp(1.0 - cos_hn * cos_hn, min=0.0)
    f = fresnel(cos_h_i, eta_i, eta_t)
    d = beckmann_d(cos_hn * cos_hn, sin_hn2, alpha)
    g = smith_g(outgoing, incident, normal, alpha)
    spec = _ftz(_ftz(d * f * g) / torch.clamp(4.0 * cos_i * cos_o, min=1e-30))
    diffuse = torch.clamp(alpha * alpha, max=1.0) * recip32(PI)
    return _where(degenerate, 1.0, spec + diffuse)


def pdf_microfacet(incident, outgoing, normal, alpha):
    h = outgoing + incident
    h_len2 = _dot(h, h)
    h = _normalize(h)
    h = torch.where((_dot(h, normal) < 0.0)[..., None], -h, h)
    cos_oh_raw = _dot(outgoing, h)
    cos_oh = torch.clamp(torch.abs(cos_oh_raw), max=1.0)
    sin_oh = sqrt_rn(torch.clamp(1.0 - cos_oh * cos_oh, min=0.0))
    cos_hn = torch.clamp(torch.abs(_dot(h, normal)), max=1.0)
    sin_hn2 = torch.clamp(1.0 - cos_hn * cos_hn, min=0.0)
    d = beckmann_d(cos_hn * cos_hn, sin_hn2, alpha)
    g1 = smith_g1(sin_oh / torch.clamp(cos_oh, min=1e-30), alpha)
    pdf = _ftz(_ftz(d * g1 * torch.clamp(cos_oh_raw, min=0.0))
               / torch.clamp(torch.abs(_dot(outgoing, normal)) * 4.0 * cos_oh_raw, min=1e-30))
    return _where(h_len2 < 1e-5, 0.0, pdf)


def microfacet_weight(incident, outgoing, normal, alpha):
    h = outgoing + incident
    h_len2 = _dot(h, h)
    h = _normalize(h)
    h = torch.where((_dot(h, normal) < 0.0)[..., None], -h, h)
    cos_ih = torch.clamp(torch.abs(_dot(incident, h)), max=1.0)
    sin_ih = sqrt_rn(torch.clamp(1.0 - cos_ih * cos_ih, min=0.0))
    g = smith_g(incident, outgoing, normal, alpha)
    g1 = smith_g1(sin_ih / torch.clamp(cos_ih, min=1e-30), alpha)
    w = g / torch.clamp(g1, min=1e-30) + torch.clamp(alpha * alpha, max=1.0) * recip32(PI)
    return _where(h_len2 < 1e-5, 0.0, w)


def _sample_frame(normal):
    """Tangent frame of sampleMicrofacetDistribution; the `else` arm is
    reachable only when n.x == 0 and n.z == 0."""
    nx, ny, nz = normal[..., 0], normal[..., 1], normal[..., 2]
    main = torch.abs(nx) > -torch.abs(nz)
    zero = torch.zeros_like(nx)
    t_main = torch.stack([-ny, nx, zero], dim=-1)
    t_alt = torch.stack([ny, -nz, zero], dim=-1)
    t1 = _normalize(torch.where(main[..., None], t_main, t_alt))
    t2 = _cross(normal, t1)
    return t1, t2


def sample_microfacet_distribution(incident, normal, alpha, u1, u2):
    """Beckmann visible-normal sampling in slope space; returns the
    sampled microfacet normal."""
    t1, t2 = _sample_frame(normal)
    local = torch.stack([_dot(incident, t1), _dot(incident, normal),
                         _dot(incident, t2)], dim=-1)
    w = _normalize(local)
    w = _normalize(w * torch.stack([alpha, torch.ones_like(alpha), alpha], dim=-1))

    cos_theta = torch.abs(w[..., 1])
    sin_theta = sqrt_rn(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    w1 = w[..., 1]
    tan_theta = sin_theta / torch.where(torch.abs(w1) < 1e-30,
                                        torch.sign(w1) * 1e-30 + 1e-38, w1)
    cot_theta = 1.0 / _where(torch.abs(tan_theta) < 1e-30, 1e-30, tan_theta)

    cos_phi = torch.clamp(w[..., 0] / torch.clamp(sin_theta, min=1e-6), -1.0, 1.0)
    sin_phi = torch.clamp(-w[..., 2] / torch.clamp(sin_theta, min=1e-6), -1.0, 1.0)

    erf_cot = erf_approx(cot_theta)
    c = 1.0 - smith_g1_r1(tan_theta) * erf_cot

    # branch A: U1 < c
    u1a = u1 / torch.clamp(c, min=1e-30)
    omega1 = _INV_2_SQRT_PI * sin_theta * torch.exp(
        -torch.clamp(cot_theta * cot_theta, max=80.0))
    omega2 = cos_theta * (0.5 - 0.5 * erf_cot)
    p_a = omega1 / torch.clamp(omega1 + omega2, min=1e-30)
    u1a1 = u1a / torch.clamp(p_a, min=1e-30)
    xm_a1 = -sqrt_rn(
        torch.clamp(-torch.log(torch.clamp(u1a1 * torch.exp(
            -torch.clamp(cot_theta * cot_theta, max=80.0)), min=1e-38)), min=0.0)
    )
    u1a2 = (u1a - p_a) / torch.clamp(1.0 - p_a, min=1e-30)
    xm_a2 = erf_inv_approx(u1a2 - 1.0 - u1a2 * erf_cot)
    xm_a = torch.where(u1a < p_a, xm_a1, xm_a2)
    u2_a = u2

    # branch B: U1 >= c
    u1b = (u1 - c) / torch.clamp(1.0 - c, min=1e-30)
    xm_b0 = erf_inv_approx((-1.0 + 2.0 * u1b) * erf_cot)
    p_b = (-xm_b0 * sin_theta + cos_theta) / torch.clamp(2.0 * cos_theta, min=1e-30)
    flip = u2 >= p_b
    u2_b = torch.where(flip, (u2 - p_b) / torch.clamp(1.0 - p_b, min=1e-30),
                       u2 / torch.clamp(p_b, min=1e-30))
    xm_b = torch.where(flip, -xm_b0, xm_b0)

    in_a = u1 < c
    x_m = torch.where(in_a, xm_a, xm_b)
    u2_final = torch.where(in_a, u2_a, u2_b)
    z_m = erf_inv_approx(u2_final * 2.0 - 1.0)

    slope_x = -(cos_phi * x_m - sin_phi * z_m) * alpha
    slope_y = -(sin_phi * x_m + cos_phi * z_m) * alpha

    h_local = _normalize(
        torch.stack([slope_x, torch.ones_like(slope_x), -slope_y], dim=-1))
    return (h_local[..., 0:1] * t1 + h_local[..., 1:2] * normal
            + h_local[..., 2:3] * t2)


def reflect(d, n):
    """GLSL reflect: d - 2*dot(d, n)*n."""
    return d - 2.0 * _dot(d, n)[..., None] * n
