// A wave's shading block for Hopper (sm_90a) in two kernels: S1 "shade
// and sample" and S2 "MIS and payload", with the shadow trace between
// them left to the traversal kernels (K2 plus the alpha recheck, or K3 on
// the rope path).
//
// Replaces no TPU kernel. tpurt leaves this block to XLA, which fuses it
// into a few loops; the port's plain version
// (integrator/wavefront.py::shade_nee_plain) issues it as ~3,000 small
// PyTorch ops a wave, and the host's issue of those ops, not the card,
// set the pace of a sample. These two kernels fuse that glue.
//
//   S1, one thread per triangle-hit lane of the wave: the barycentric
//       attributes of the fused (T, 40) shading row, the base-colour,
//       metallic-roughness, normal and emissive taps of the quad atlas
//       (the scene's tex_flags pick which), normal mapping; both NEE
//       directions in the reference's RNG draw order (u_pick, u1, u2, the
//       dead light-index draw, u3, u4), the bounce direction, its weight,
//       Russian roulette (u5, u6, u_rr) and the offset; the folded
//       sample-2 weight; the sphere-light test of every shadow ray. It
//       writes the shadow rays (m lanes folded, 2m otherwise: sample 1
//       then sample 2, as the plain version's torch.cat), their t_limit,
//       ray class, sphere hit and light id, the per-lane values S2 reads,
//       and the wave's full-width state, bounce direction, weight,
//       roulette, new origin, albedo and folded weight at the lane's index.
//   S2, one thread per lane: the shadow payload from the trace's blocked
//       flags, the MIS weights (the folded sample-1 estimator or the exact
//       two-ray one) and the emissive term; it writes local_l and miss_inc
//       at the lane's index.
//
// Arithmetic. float32 throughout, built with --fmad=false and without
// fast math, each expression in the plain version's operation order: the
// component-wise dots, the float32 reciprocals of constant divisors
// (recip32), flush-to-zero where the plain version flushes (_ftz), the
// IEEE square root (sqrt_rn), the reference's A&S erf and skewed sampling
// frame, torch's NaN-propagating clamps. Every configuration constant
// and every constant the plain version derives on the host (2 pi, 1/255,
// the env pdf's square) arrives by value, rounded to float32 as the plain
// version rounds it (kernels/shade.py::shade_constants); a literal is the
// float32 rounding of the plain version's double (F below). The
// transcendental functions are libdevice's expf, logf, sinf, cosf and
// powf, which PyTorch's own elementwise kernels call.
//
// Bound. A lane reads and writes about 0.5 KB (its hit, ray, RNG state and
// throughput, the 160-byte shading row, four 16-byte texel quads and their
// table rows, the shadow rays and S1's per-lane values), so at 3.35 TB/s a
// 262,144-lane wave is bound near 40 us; the block is bound by memory.
//
// Design. One thread a lane, no shared memory and no barrier: the
// lane's work is straight-line code with data-dependent selects. A
// select of the plain version whose one side the lane does not take is
// not computed (the light-pick branches of the NEE direction and of the
// MIS term, the unused texture taps, sample 2 when folded), which
// changes no value. The texture kinds and the fold choice are runtime
// flags, the same for every thread of a launch. The library also builds
// as plain C++ (no __CUDACC__): the same lane functions then run in a
// host loop, for checking the arithmetic without a card.

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <math.h>
#define SW_FN __device__ __forceinline__
#else
#include <cmath>
#define SW_FN static inline
using std::isfinite;
using std::isinf;
using std::isnan;
#endif

namespace {

// a literal as the plain version's float32 rounding of the double
#define F(x) ((float)(x))

constexpr int NO_TEXTURE = 0xFFFF;
constexpr int WRAP_REPEAT = 0;
constexpr int WRAP_MIRRORED_REPEAT = 1;
constexpr int FILTER_LINEAR = 1;
constexpr float FLT_MIN_NORMAL = 1.1754943508222875e-38f;  // 2^-126

// The constants, in kernels/shade.py::CONSTANT_NAMES order.
struct Consts {
  float sky[3];
  float ray_offset, rr_threshold, eta_i, eta_t, inv_eta_i, inv_eta_t;
  float emissive_scale, t_max, nl1, env_pdf2, inv_env_pdf;
  float pi, two_pi, four_pi, inv_pi, inv_2_sqrt_pi, inv_255, inv_12_92, inv_1_055;
};
constexpr int N_CONSTS = 22;

struct V3 {
  float x, y, z;
};

SW_FN V3 v3(float x, float y, float z) { V3 r = {x, y, z}; return r; }
SW_FN V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
SW_FN V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
SW_FN V3 mul(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
SW_FN V3 scale(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
SW_FN V3 divs(V3 a, float s) { return v3(a.x / s, a.y / s, a.z / s); }
SW_FN V3 neg(V3 a) { return v3(-a.x, -a.y, -a.z); }
SW_FN V3 load3(const float* p) { return v3(p[0], p[1], p[2]); }
SW_FN void store3(float* p, V3 a) { p[0] = a.x; p[1] = a.y; p[2] = a.z; }

SW_FN float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
SW_FN V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

// torch.clamp and torch.minimum on the card: a NaN passes through
SW_FN float cmin(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
SW_FN float cmax(float x, float hi) { return isnan(x) ? x : fminf(x, hi); }
SW_FN float clampf(float x, float lo, float hi) { return isnan(x) ? x : fminf(fmaxf(x, lo), hi); }
SW_FN float minimum(float a, float b) { return isnan(a) ? a : (isnan(b) ? b : fminf(a, b)); }
SW_FN int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }
SW_FN float ftz(float x) { return fabsf(x) < FLT_MIN_NORMAL ? 0.0f : x; }
SW_FN float signf(float x) { return (float)((0.0f < x) - (x < 0.0f)); }

SW_FN float norm(V3 v) { return sqrtf(dot(v, v)); }
SW_FN V3 normalize(V3 v, float eps) { return divs(v, cmin(norm(v), eps)); }
SW_FN V3 normalize(V3 v) { return normalize(v, F(1e-20)); }
SW_FN V3 reflect(V3 d, V3 n) { return sub(d, scale(n, 2.0f * dot(d, n))); }

// ---- RNG (rng.py) -----------------------------------------------------------

SW_FN uint32_t pcg_hash(uint32_t x) {
  uint32_t state = x * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

SW_FN float next_rand(uint32_t& state) {
  state = pcg_hash(state);
  return cmax((float)state * F(2.3283064365386963e-10), F(1.0 - 5.9604644775390625e-08));
}

// ---- the Beckmann BSDF (kernels/bsdf.py) -------------------------------------

SW_FN float lambda_val(float a) {
  return ((1.0f - F(1.259) * a) + (F(0.396) * a) * a) / (F(3.535) * a + (F(2.181) * a) * a);
}

SW_FN float beckmann_lambda(float tan_theta, float alpha) {
  float a = 1.0f / cmin(alpha * fabsf(tan_theta), F(1e-30));
  float out = a >= F(1.6) ? 0.0f : lambda_val(a);
  return isnan(tan_theta) ? 0.0f : out;
}

SW_FN float beckmann_lambda_r1(float tan_theta) {
  float a = 1.0f / cmin(fabsf(tan_theta), F(1e-30));
  return a >= F(1.6) ? 0.0f : lambda_val(a);
}

SW_FN float smith_g1(float tan_theta, float alpha) {
  float g = 1.0f / (1.0f + beckmann_lambda(tan_theta, alpha));
  return isinf(tan_theta) ? 0.0f : g;
}

SW_FN float smith_g1_r1(float tan_theta) { return 1.0f / (1.0f + beckmann_lambda_r1(tan_theta)); }

SW_FN float smith_g(V3 wi, V3 wo, V3 n, float alpha) {
  float cos_in = fabsf(dot(wi, n));
  float sin_in = sqrtf(cmin(1.0f - cos_in * cos_in, 0.0f));
  float cos_out = fabsf(dot(wo, n));
  float sin_out = sqrtf(cmin(1.0f - cos_out * cos_out, 0.0f));
  float tan_in = fabsf(cos_in) < F(1e-5) ? 0.0f : sin_in / cmin(cos_in, F(1e-30));
  float tan_out = fabsf(cos_out) < F(1e-5) ? 0.0f : sin_out / cmin(cos_out, F(1e-30));
  return 1.0f / ((1.0f + beckmann_lambda(tan_in, alpha)) + beckmann_lambda(tan_out, alpha));
}

SW_FN float beckmann_d(const Consts& c, float cos2, float sin2, float alpha) {
  float tan2 = fabsf(sin2 / cmin(cos2, F(1e-30)));
  float a2 = alpha * alpha;
  float e = ftz(expf(-tan2 / a2));
  float d = ftz(e / ((a2 * c.pi) * cmin(cos2 * cos2, F(1e-30))));
  return (isinf(tan2) || cos2 <= 0.0f) ? 0.0f : d;
}

SW_FN float erf_approx(float x) {
  float sign = 1.0f - (x < 0.0f ? 1.0f : 0.0f) * 2.0f;
  x = fabsf(x);
  float t = 1.0f / (1.0f + F(0.3275911) * x);
  float poly = (((((F(1.06104) * t - F(1.453152027)) * t) + F(1.421413741)) * t
                 - F(0.284496736)) * t) + F(0.254829592);
  return sign * (1.0f - (poly * t) * expf(-(x * x)));
}

SW_FN float erf_inv_approx(float x) {
  x = clampf(x, F(-0.99), F(0.99));
  float w = -logf(cmin((1.0f - x) * (1.0f + x), F(1e-30)));
  w = w - 2.5f;
  float p = w * F(2.81022636e-08);
  p = p + F(3.43273939e-07);
  p = p * w + F(-3.5233877e-06);
  p = p * w + F(-4.39150654e-06);
  p = p * w + F(0.00021858087);
  p = p * w + F(-0.00125372503);
  p = p * w + F(-0.00417768164);
  p = p * w + F(0.246640727);
  p = p * w + F(1.50140941);
  return p * x;
}

SW_FN float fresnel(const Consts& c, float cos_theta_i) {
  bool flip = cos_theta_i < 0.0f;
  float cei = flip ? c.eta_t : c.eta_i;
  float cet = flip ? c.eta_i : c.eta_t;
  float ci = fabsf(cos_theta_i);
  float sin_i = sqrtf(cmin(1.0f - ci * ci, 0.0f));
  float sin_t = (cei * sin_i) * (flip ? c.inv_eta_i : c.inv_eta_t);
  float cos_t = sqrtf(cmin(1.0f - sin_t * sin_t, 0.0f));
  float r_par = (cet * ci - cei * cos_t) / (cet * ci + cei * cos_t);
  float r_perp = (cei * ci - cet * cos_t) / (cei * ci + cet * cos_t);
  float f = 0.5f * (r_par * r_par + r_perp * r_perp);
  return sin_t >= 1.0f ? 1.0f : f;
}

// power_heuristic(1, f_pdf, 1, g_pdf) with both pdfs per lane
SW_FN float power_heuristic(float f_pdf, float g_pdf) {
  float f2 = ftz(f_pdf * f_pdf);
  float g2 = ftz(g_pdf * g_pdf);
  return f2 / cmin(f2 + g2, F(1e-30));
}

SW_FN float roughness_to_alpha(float r) {
  return ((F(9.12793) * r - F(16.3381)) * r + F(9.84534)) * r;
}

// the half vector of microfacet_bsdf/pdf_microfacet/microfacet_weight:
// (normalised, flipped to the normal's side), and |o + i|^2
SW_FN V3 half_vector(V3 incident, V3 outgoing, V3 n, float& h_len2) {
  V3 h = add(outgoing, incident);
  h_len2 = dot(h, h);
  h = normalize(h);
  return dot(h, n) < 0.0f ? neg(h) : h;
}

SW_FN float microfacet_bsdf(const Consts& c, V3 incident, V3 outgoing, V3 n, float alpha) {
  float cos_i = fabsf(dot(incident, n));
  float cos_o = fabsf(dot(outgoing, n));
  float h_len2;
  V3 h = half_vector(incident, outgoing, n, h_len2);
  bool degenerate = (h_len2 < F(1e-5)) || (cos_i == 0.0f) || (cos_o == 0.0f);
  float cos_h_i = fabsf(dot(incident, h));
  float cos_hn = clampf(dot(h, n), 0.0f, 1.0f);
  float sin_hn2 = cmin(1.0f - cos_hn * cos_hn, 0.0f);
  float f = fresnel(c, cos_h_i);
  float d = beckmann_d(c, cos_hn * cos_hn, sin_hn2, alpha);
  float g = smith_g(outgoing, incident, n, alpha);
  float spec = ftz(ftz((d * f) * g) / cmin((cos_i * 4.0f) * cos_o, F(1e-30)));
  float diffuse = cmax(alpha * alpha, 1.0f) * c.inv_pi;
  return degenerate ? 1.0f : spec + diffuse;
}

SW_FN float pdf_microfacet(const Consts& c, V3 incident, V3 outgoing, V3 n, float alpha) {
  float h_len2;
  V3 h = half_vector(incident, outgoing, n, h_len2);
  float cos_oh_raw = dot(outgoing, h);
  float cos_oh = cmax(fabsf(cos_oh_raw), 1.0f);
  float sin_oh = sqrtf(cmin(1.0f - cos_oh * cos_oh, 0.0f));
  float cos_hn = cmax(fabsf(dot(h, n)), 1.0f);
  float sin_hn2 = cmin(1.0f - cos_hn * cos_hn, 0.0f);
  float d = beckmann_d(c, cos_hn * cos_hn, sin_hn2, alpha);
  float g1 = smith_g1(sin_oh / cmin(cos_oh, F(1e-30)), alpha);
  float pdf = ftz(ftz((d * g1) * cmin(cos_oh_raw, 0.0f))
                  / cmin((fabsf(dot(outgoing, n)) * 4.0f) * cos_oh_raw, F(1e-30)));
  return h_len2 < F(1e-5) ? 0.0f : pdf;
}

SW_FN float microfacet_weight(const Consts& c, V3 incident, V3 outgoing, V3 n, float alpha) {
  float h_len2;
  V3 h = half_vector(incident, outgoing, n, h_len2);
  float cos_ih = cmax(fabsf(dot(incident, h)), 1.0f);
  float sin_ih = sqrtf(cmin(1.0f - cos_ih * cos_ih, 0.0f));
  float g = smith_g(incident, outgoing, n, alpha);
  float g1 = smith_g1(sin_ih / cmin(cos_ih, F(1e-30)), alpha);
  float w = g / cmin(g1, F(1e-30)) + cmax(alpha * alpha, 1.0f) * c.inv_pi;
  return h_len2 < F(1e-5) ? 0.0f : w;
}

// Beckmann visible-normal sampling in slope space, in the skewed frame
SW_FN V3 sample_microfacet(const Consts& c, V3 incident, V3 n, float alpha, float u1,
                           float u2) {
  bool main_arm = fabsf(n.x) > -fabsf(n.z);
  V3 t1 = normalize(main_arm ? v3(-n.y, n.x, 0.0f) : v3(n.y, -n.z, 0.0f));
  V3 t2 = cross(n, t1);
  V3 w = normalize(v3(dot(incident, t1), dot(incident, n), dot(incident, t2)));
  w = normalize(v3(w.x * alpha, w.y * 1.0f, w.z * alpha));

  float cos_theta = fabsf(w.y);
  float sin_theta = sqrtf(cmin(1.0f - cos_theta * cos_theta, 0.0f));
  float w1 = w.y;
  float tan_theta =
      sin_theta / (fabsf(w1) < F(1e-30) ? signf(w1) * F(1e-30) + F(1e-38) : w1);
  float cot_theta = 1.0f / (fabsf(tan_theta) < F(1e-30) ? F(1e-30) : tan_theta);

  float cos_phi = clampf(w.x / cmin(sin_theta, F(1e-6)), -1.0f, 1.0f);
  float sin_phi = clampf(-w.z / cmin(sin_theta, F(1e-6)), -1.0f, 1.0f);

  float erf_cot = erf_approx(cot_theta);
  float cc = 1.0f - smith_g1_r1(tan_theta) * erf_cot;
  bool in_a = u1 < cc;
  float x_m, u2_final;
  if (in_a) {
    float u1a = u1 / cmin(cc, F(1e-30));
    float e80 = expf(-cmax(cot_theta * cot_theta, 80.0f));
    float omega1 = (c.inv_2_sqrt_pi * sin_theta) * e80;
    float omega2 = cos_theta * (0.5f - 0.5f * erf_cot);
    float p_a = omega1 / cmin(omega1 + omega2, F(1e-30));
    if (u1a < p_a) {
      float u1a1 = u1a / cmin(p_a, F(1e-30));
      x_m = -sqrtf(cmin(-logf(cmin(u1a1 * e80, F(1e-38))), 0.0f));
    } else {
      float u1a2 = (u1a - p_a) / cmin(1.0f - p_a, F(1e-30));
      x_m = erf_inv_approx((u1a2 - 1.0f) - u1a2 * erf_cot);
    }
    u2_final = u2;
  } else {
    float u1b = (u1 - cc) / cmin(1.0f - cc, F(1e-30));
    float xm_b0 = erf_inv_approx((u1b * 2.0f + -1.0f) * erf_cot);
    float p_b = (-xm_b0 * sin_theta + cos_theta) / cmin(cos_theta * 2.0f, F(1e-30));
    bool flip = u2 >= p_b;
    u2_final = flip ? (u2 - p_b) / cmin(1.0f - p_b, F(1e-30)) : u2 / cmin(p_b, F(1e-30));
    x_m = flip ? -xm_b0 : xm_b0;
  }
  float z_m = erf_inv_approx(u2_final * 2.0f - 1.0f);

  float slope_x = -(cos_phi * x_m - sin_phi * z_m) * alpha;
  float slope_y = -(sin_phi * x_m + cos_phi * z_m) * alpha;
  V3 h = normalize(v3(slope_x, 1.0f, -slope_y));
  return add(add(scale(t1, h.x), scale(n, h.y)), scale(t2, h.z));
}

// ---- sphere lights (kernels/lights.py, kernels/intersect.py) ----------------

SW_FN V3 sample_hemisphere_uniform(const Consts& c, V3 n, float u1, float u2) {
  bool cond = fabsf(n.x) > fabsf(n.y);
  V3 t1 = normalize(cond ? v3(-n.y, 0.0f, n.x) : v3(n.y, 0.0f, -n.z));
  V3 t2 = cross(n, t1);
  float m = sqrtf(cmin(1.0f - u1 * u1, 0.0f));
  float vx = cosf(u2 * c.two_pi) * m;
  float vy = u1;
  float vz = -sinf(u2 * c.two_pi) * m;
  return normalize(sub(add(scale(t1, vx), scale(n, vy)), scale(t2, vz)));
}

SW_FN V3 sample_sphere(const Consts& c, V3 hit, V3 lp, float radius, float u1, float u2) {
  V3 otc = sub(lp, hit);
  float dist2 = dot(otc, otc);
  if (fabsf(dist2) < radius * radius) {  // inside: the reference's raw local vector
    float r_in = sqrtf(cmin(u1 * (1.0f - u1), 0.0f));
    return v3((cosf(u2 * c.two_pi) * 2.0f) * r_in, (sinf(u2 * c.two_pi) * 2.0f) * r_in,
              u2 * 2.0f - 1.0f);
  }
  float stm2 = (radius * radius) / cmin(dist2, F(1e-30));
  float ctm = sqrtf(cmin(1.0f - stm2, 0.0f));
  float cos_theta = (1.0f - u1) + u1 * ctm;
  float sin_theta = sqrtf(cmin(1.0f - cos_theta * cos_theta, 0.0f));
  float phi = (u2 * 2.0f) * c.pi;
  float dc = sqrtf(cmin(dist2, F(1e-30)));
  float ds = dc * cos_theta
             - sqrtf(cmin(radius * radius - (dist2 * sin_theta) * sin_theta, 0.0f));
  float cos_alpha = ((dist2 + radius * radius) - ds * ds) / cmin((dc * 2.0f) * radius, F(1e-30));
  float sin_alpha = sqrtf(cmin(1.0f - cos_alpha * cos_alpha, 0.0f));
  V3 on = normalize(otc);
  bool cond = fabsf(on.x) > fabsf(on.y);
  V3 o1 = normalize(cond ? v3(on.y, -on.x, 0.0f) : v3(0.0f, -on.y, on.z));
  V3 o2 = cross(on, o1);
  V3 pos = sub(add(scale(o1, sin_alpha * cosf(phi)), scale(on, fabsf(cos_alpha))),
               scale(o2, sin_alpha * sinf(phi)));
  return normalize(sub(add(scale(neg(pos), radius), lp), hit));
}

SW_FN float pdf_sphere(const Consts& c, V3 hit, V3 dir, V3 lp, float radius) {
  V3 otc = sub(lp, hit);
  V3 cto = sub(hit, lp);
  float dist2 = dot(otc, otc);
  float sd = dot(dir, cto);
  float disc = sd * sd - (dot(cto, cto) - radius * radius);
  float pdf;
  if (dist2 < radius * radius) {
    pdf = 1.0f / ((radius * c.four_pi) * radius);
  } else {
    float stm2 = (radius * radius) / cmin(dist2, F(1e-30));
    float ctm = sqrtf(cmin(1.0f - stm2, 0.0f));
    pdf = 1.0f / cmin((1.0f - ctm) * c.two_pi, F(1e-30));
  }
  return disc < 0.0f ? 0.0f : pdf;
}

// ray_sphere_reference over every light: the first light of least t
SW_FN void intersect_spheres(const float* lights, int nl, float t_max, V3 o, V3 d, bool& hit,
                             float& t_best, int& best) {
  t_best = INFINITY;
  best = 0;
  for (int l = 0; l < nl; ++l) {
    const float* lt = lights + 8 * l;
    V3 cto = sub(o, load3(lt));
    float r = lt[3];
    float b = dot(d, cto);
    float cq = dot(cto, cto) - r * r;
    float b2 = 2.0f * b;
    float disc = b2 * b2 - 4.0f * cq;
    float sqrt_disc = sqrtf(cmin(disc, 0.0f));
    float q = b > 0.0f ? -b - sqrt_disc : -b + sqrt_disc;
    float q_safe = q == 0.0f ? F(1e-20) : q;
    float t = minimum(q, cq / q_safe);
    bool h = (disc >= 0.0f) && (t > 0.0f) && (t < t_max);
    float ti = h ? t : INFINITY;
    if (ti < t_best) {
      t_best = ti;
      best = l;
    }
  }
  hit = isfinite(t_best);
}

// ---- textures (kernels/texture.py) ----------------------------------------------

SW_FN float wrap_f32(float x, float size, int mode) {
  float r = x - floorf(x / size) * size;
  r = r < 0.0f ? r + size : (r >= size ? r - size : r);
  float period = 2.0f * size;
  float m = x - floorf(x / period) * period;
  m = m < 0.0f ? m + period : (m >= period ? m - period : m);
  float mir = m < size ? m : (period - 1.0f) - m;
  float clamped = minimum(cmin(x, 0.0f), size - 1.0f);
  return mode == WRAP_REPEAT ? r : (mode == WRAP_MIRRORED_REPEAT ? mir : clamped);
}

SW_FN float srgb_to_linear(const Consts& c, float x) {
  return x <= F(0.04045) ? x * c.inv_12_92 : powf((x + F(0.055)) * c.inv_1_055, 2.4f);
}

struct Tex {
  const int* table;
  int n_tex;
  const unsigned char* quad;
  int qh, qw;
};

// sample_texture_quad: one 16-byte quad row, bilinear or nearest at lod 0
SW_FN void tex_quad(const Consts& c, const Tex& tx, int tex_id, float u, float v,
                    float out[4]) {
  const int* row = tx.table + 10 * clampi(tex_id, 0, tx.n_tex - 1);
  float wf = (float)row[2], hf = (float)row[3];
  int filt = row[6];
  float x = u * wf, y = v * hf;
  x = filt == FILTER_LINEAR ? x - 0.5f : floorf(x);
  y = filt == FILTER_LINEAR ? y - 0.5f : floorf(y);
  float x0 = floorf(x), y0 = floorf(y);
  float fx = x - x0, fy = y - y0;
  int xw = (int)wrap_f32(x0, cmin(wf, 1.0f), row[4]) + row[8];
  int yw = (int)wrap_f32(y0, cmin(hf, 1.0f), row[5]) + row[9];
  int idx = clampi(yw * tx.qw + xw, 0, tx.qh * tx.qw - 1);
  unsigned char b[16];
#ifdef __CUDACC__
  *reinterpret_cast<uint4*>(b) = __ldg(reinterpret_cast<const uint4*>(tx.quad) + idx);
#else
  memcpy(b, tx.quad + 16 * (size_t)idx, 16);
#endif
  float gx = 1.0f - fx, gy = 1.0f - fy;
  for (int k = 0; k < 4; ++k) {
    float c00 = (float)b[k] * c.inv_255, c10 = (float)b[4 + k] * c.inv_255;
    float c01 = (float)b[8 + k] * c.inv_255, c11 = (float)b[12 + k] * c.inv_255;
    out[k] = (((c00 * gx) * gy + (c10 * fx) * gy) + (c01 * gx) * fy) + (c11 * fx) * fy;
  }
  if (row[7] > 0) {
    for (int k = 0; k < 3; ++k) out[k] = srgb_to_linear(c, out[k]);
  }
}

// ---- S1 and S2 ------------------------------------------------------------------

// per-lane values S1 leaves for S2: shading normal, hit point, emissive,
// Beckmann alpha
constexpr int AUX = 10;

struct SampleArgs {
  // the wave's full-width arrays, read at the lane's index
  const int64_t* si;
  const float* o;
  const float* d;
  const int64_t* state_in;
  const float* thr;
  const float* hit_t;
  const int* hit_prim;
  const float* hit_u;
  const float* hit_v;
  // the scene
  const float* shade_row;
  const int* tex_table;
  const unsigned char* atlas_quad;
  const float* lights;
  // full-width outputs, written at the lane's index
  int64_t* state_out;
  float* bounce_dir;
  float* t_new;
  unsigned char* killed;
  float* new_o;
  float* albedo;
  float* fold_w;
  // the shadow rays (m lanes folded, 2m otherwise)
  float* sh_o;
  float* sh_d;
  float* sh_tmin;
  float* sh_tlimit;
  unsigned char* sh_active;
  int* ray_class;
  unsigned char* s_hit;
  int* s_id;
  // for S2
  float* aux;
  int* aux_light;
  // sizes and flags
  int m, n_tri, n_tex, qh, qw, nl, tex_flags, fold;
  Consts c;
};
constexpr int SAMPLE_PTRS = 30;
constexpr int SAMPLE_INTS = 8;

struct MisArgs {
  const int64_t* si;
  const float* d;
  const float* thr;
  const float* lights;
  const float* sh_d;
  const unsigned char* s_hit;
  const int* s_id;
  const unsigned char* blocked;
  const float* aux;
  const int* aux_light;
  float* local_l;
  int* miss_inc;
  int m, nl, fold;
  Consts c;
};
constexpr int MIS_PTRS = 12;
constexpr int MIS_INTS = 3;

SW_FN V3 bary3(float w0, float u, float v, const float* a, const float* b, const float* cc) {
  return v3((w0 * a[0] + u * b[0]) + v * cc[0], (w0 * a[1] + u * b[1]) + v * cc[1],
            (w0 * a[2] + u * b[2]) + v * cc[2]);
}

SW_FN void shade_sample_lane(const SampleArgs& p, int i) {
  const Consts& c = p.c;
  const int64_t lane = p.si[i];
  const V3 o = load3(p.o + 3 * lane), d = load3(p.d + 3 * lane);
  const float thr = p.thr[lane];

  // shade_hit: attributes from the fused shading row
  const float t = p.hit_t[lane], u = p.hit_u[lane], v = p.hit_v[lane];
  const float* r = p.shade_row + 40 * (int64_t)clampi(p.hit_prim[lane], 0, p.n_tri - 1);
  const float w0 = (1.0f - u) - v;
  const float uv_u = (w0 * r[0] + u * r[2]) + v * r[4];
  const float uv_v = (w0 * r[1] + u * r[3]) + v * r[5];
  const V3 normal = normalize(bary3(w0, u, v, r + 6, r + 9, r + 12));
  const V3 hp = add(o, scale(d, t));
  const V3 mat_emissive = load3(r + 32);
  const Tex tx = {p.tex_table, p.n_tex, p.atlas_quad, p.qh, p.qw};
  float texel[4];

  V3 albedo = load3(r + 27);
  if (p.tex_flags & 1) {
    int tex = (int)r[35];
    if (tex != NO_TEXTURE) {
      tex_quad(c, tx, tex, uv_u, uv_v, texel);
      albedo = mul(albedo, v3(texel[0], texel[1], texel[2]));
    }
  }
  V3 sn = normal;
  if (p.tex_flags & 4) {
    int tex = (int)r[37];
    float nf = r[31];
    if (tex != NO_TEXTURE && fabsf(nf) > F(0.001)) {
      float tw = (w0 * r[18] + u * r[22]) + v * r[26];
      V3 tangent = normalize(v3((w0 * r[15] + u * r[19]) + v * r[23],
                                (w0 * r[16] + u * r[20]) + v * r[24],
                                (w0 * r[17] + u * r[21]) + v * r[25]));
      tex_quad(c, tx, tex, uv_u, uv_v, texel);
      V3 nm = scale(v3(texel[0] * 2.0f - 1.0f, texel[1] * 2.0f - 1.0f, texel[2] * 2.0f - 1.0f),
                    nf);
      V3 bitangent = scale(cross(normal, tangent), tw);
      sn = normalize(add(add(scale(tangent, nm.x), scale(bitangent, nm.y)), scale(normal, nm.z)));
    }
  }
  V3 emissive = scale(mat_emissive, c.emissive_scale);
  if (p.tex_flags & 8) {
    int tex = (int)r[38];
    if (tex != NO_TEXTURE) {
      tex_quad(c, tx, tex, uv_u, uv_v, texel);
      emissive = mul(v3(texel[0], texel[1], texel[2]), mat_emissive);
    }
  }
  float roughness = r[30];
  if (p.tex_flags & 2) {
    int tex = (int)r[36];
    if (tex != NO_TEXTURE) {
      tex_quad(c, tx, tex, uv_u, uv_v, texel);
      roughness = roughness * texel[1];
    }
  }
  const float alpha = roughness_to_alpha(roughness);

  // nee_directions
  uint32_t st = (uint32_t)p.state_in[lane];
  const float u_pick = next_rand(st);
  int light_idx = (int)(u_pick * c.nl1);
  light_idx = light_idx > p.nl ? p.nl : light_idx;
  const bool pick_env = light_idx >= p.nl;
  const float u1 = next_rand(st);
  const float u2 = next_rand(st);
  V3 dir1;
  if (pick_env) {
    dir1 = sample_hemisphere_uniform(c, sn, u1, u2);
  } else {
    const float* lt = p.lights + 8 * clampi(light_idx, 0, p.nl - 1);
    dir1 = sample_sphere(c, hp, load3(lt), lt[3], u1, u2);
  }
  const V3 nee_o = add(hp, scale(sn, c.ray_offset));
  next_rand(st);  // the reference's dead light-index draw
  const float u3 = next_rand(st);
  const float u4 = next_rand(st);
  const V3 wo = neg(d);
  const float al_b = cmin(alpha, F(0.01));
  V3 dir2 = v3(0.0f, 0.0f, 0.0f);
  if (!p.fold) {
    V3 micro_n = alpha > 0.0f ? sample_microfacet(c, wo, sn, al_b, u3, u4) : sn;
    dir2 = reflect(d, micro_n);
  }

  // bounce_sample
  const float u5 = next_rand(st);
  const float u6 = next_rand(st);
  const V3 micro_b = alpha > 0.0f ? sample_microfacet(c, wo, sn, alpha, u5, u6) : sn;
  const V3 bd = reflect(d, micro_b);
  float t_new = thr * microfacet_weight(c, bd, wo, sn, al_b);
  const float rr_w = 1.0f - cmin(t_new, c.rr_threshold);
  const float u_rr = next_rand(st);
  const bool killed = u_rr < rr_w;
  t_new = t_new / cmin(1.0f - rr_w, F(1e-30));
  const V3 offset = dot(bd, sn) < 0.0f
                        ? divs(scale(neg(bd), c.ray_offset), cmin(norm(bd), F(1e-20)))
                        : scale(sn, c.ray_offset);

  // fold_mis_weight, scaled by nl + 1 and the throughput
  float fold_w = 0.0f;
  if (p.fold) {
    float pdf_q = pdf_microfacet(c, bd, wo, sn, al_b);
    float f2 = ftz(pdf_q * pdf_q);
    float w = microfacet_weight(c, bd, wo, sn, al_b) * (f2 / cmin(f2 + c.env_pdf2, F(1e-30)));
    w = pdf_q <= F(0.000005) ? 0.0f : w;
    w = (isnan(bd.x) || isnan(bd.y) || isnan(bd.z)) ? 0.0f : w;
    float ratio = 1.0f;
    if (alpha > 0.0f && alpha < F(0.01)) {
      float pdf_s = pdf_microfacet(c, bd, wo, sn, cmin(alpha, F(1e-8)));
      ratio = pdf_s > 0.0f ? pdf_q / cmin(pdf_s, F(1e-30)) : 0.0f;
    }
    fold_w = ((w * ratio) * c.nl1) * thr;
  }

  p.state_out[lane] = (int64_t)st;
  store3(p.bounce_dir + 3 * lane, bd);
  p.t_new[lane] = t_new;
  p.killed[lane] = killed;
  store3(p.new_o + 3 * lane, add(hp, offset));
  store3(p.albedo + 3 * lane, albedo);
  p.fold_w[lane] = fold_w;

  // the shadow rays and their sphere-light test
  const int rays = p.fold ? 1 : 2;
  for (int s = 0; s < rays; ++s) {
    const int k = i + s * p.m;
    const V3 dir = s == 0 ? dir1 : dir2;
    bool s_hit = false;
    float s_t = c.t_max;
    int s_id = 0;
    if (p.nl > 0) intersect_spheres(p.lights, p.nl, c.t_max, nee_o, dir, s_hit, s_t, s_id);
    store3(p.sh_o + 3 * k, nee_o);
    store3(p.sh_d + 3 * k, dir);
    p.sh_tmin[k] = 0.0f;
    p.sh_tlimit[k] = s_hit ? s_t : c.t_max;
    p.sh_active[k] = 1;
    p.ray_class[k] = p.fold ? (int)pick_env : s;
    p.s_hit[k] = s_hit;
    p.s_id[k] = s_id;
  }
  float* a = p.aux + AUX * i;
  store3(a, sn);
  store3(a + 3, hp);
  store3(a + 6, emissive);
  a[9] = alpha;
  p.aux_light[i] = light_idx;
}

// _trace_shadow's payload of shadow ray k: rgb, alpha code, miss
SW_FN V3 payload(const MisArgs& p, int k, float thr, float& a, int& miss) {
  const bool blocked = p.blocked[k] != 0;
  const bool s_hit = p.s_hit[k] != 0;
  const bool hit_sphere = s_hit && !blocked;
  miss = (!blocked && !s_hit) ? 1 : 0;
  a = blocked ? 1.0f : (hit_sphere ? 0.0f : -4.0f);
  if (blocked) return v3(0.0f, 0.0f, 0.0f);
  if (hit_sphere) {
    const float* lt = p.lights + 8 * clampi(p.s_id[k], 0, p.nl - 1);
    return scale(scale(load3(lt + 4), lt[7]), thr);
  }
  return scale(v3(p.c.sky[0], p.c.sky[1], p.c.sky[2]), thr);
}

// _nee1: the sample-1 MIS term of the light or the envmap pick
SW_FN V3 nee1(const MisArgs& p, V3 sn, V3 hp, float alpha, V3 wo, V3 dir1, int light_idx,
              V3 rgb1, float a1) {
  const Consts& c = p.c;
  const float cos1 = fabsf(dot(dir1, sn));
  if (light_idx >= p.nl) {
    const float al_le = cmin(alpha, F(0.001));
    const float bsdf_fe = microfacet_bsdf(c, dir1, wo, sn, al_le);
    const float bsdf_pdfe = pdf_microfacet(c, dir1, wo, sn, al_le);
    const float vis_env1 = a1 < -1.0f ? 1.0f : 0.0f;
    const float g2 = ftz(bsdf_pdfe * bsdf_pdfe);
    const float ph = c.env_pdf2 / cmin(g2 + c.env_pdf2, F(1e-30));
    float w_env = (((bsdf_fe * cos1) * vis_env1) * ph) * c.inv_env_pdf;
    w_env = bsdf_pdfe <= 0.0f ? 0.0f : w_env;
    return scale(rgb1, w_env);
  }
  const float al_l = cmin(alpha, F(0.00001));
  const float bsdf_f1 = microfacet_bsdf(c, dir1, wo, sn, al_l);
  const float bsdf_pdf1 = pdf_microfacet(c, dir1, wo, sn, al_l);
  const float* lt = p.lights + 8 * clampi(light_idx, 0, p.nl - 1);
  const float light_pdf1 = pdf_sphere(c, hp, dir1, load3(lt), lt[3]);
  const float vis1 = cmin(1.0f - cmin(a1, 0.0f), 0.0f);
  float w_light = (((bsdf_f1 * cos1) * vis1) * power_heuristic(light_pdf1, bsdf_pdf1))
                  / cmin(light_pdf1, F(1e-30));
  w_light = (light_pdf1 <= 0.0f || bsdf_pdf1 <= 0.0f) ? 0.0f : w_light;
  return scale(rgb1, w_light);
}

SW_FN void shade_mis_lane(const MisArgs& p, int i) {
  const Consts& c = p.c;
  const int64_t lane = p.si[i];
  const V3 d = load3(p.d + 3 * lane);
  const V3 wo = neg(d);
  const float thr = p.thr[lane];
  const float* a = p.aux + AUX * i;
  const V3 sn = load3(a), hp = load3(a + 3), emissive = load3(a + 6);
  const float alpha = a[9];
  const int light_idx = p.aux_light[i];

  float a1;
  int miss1;
  const V3 rgb1 = payload(p, i, thr, a1, miss1);
  V3 nee = nee1(p, sn, hp, alpha, wo, load3(p.sh_d + 3 * i), light_idx, rgb1, a1);
  int miss = miss1;
  if (!p.fold) {
    float a2;
    int miss2;
    const V3 rgb2 = payload(p, i + p.m, thr, a2, miss2);
    const V3 dir2 = load3(p.sh_d + 3 * (i + p.m));
    const float al_b = cmin(alpha, F(0.01));
    const float bsdf_pdf2 = pdf_microfacet(c, dir2, wo, sn, al_b);
    const float vis_env2 = a2 < -1.0f ? 1.0f : 0.0f;
    const float f2 = ftz(bsdf_pdf2 * bsdf_pdf2);
    float w_bsdf = (microfacet_weight(c, dir2, wo, sn, al_b) * vis_env2)
                   * (f2 / cmin(f2 + c.env_pdf2, F(1e-30)));
    w_bsdf = bsdf_pdf2 <= F(0.000005) ? 0.0f : w_bsdf;
    w_bsdf = (isnan(dir2.x) || isnan(dir2.y) || isnan(dir2.z)) ? 0.0f : w_bsdf;
    nee = add(nee, scale(rgb2, w_bsdf));
    miss += miss2;
  }
  store3(p.local_l + 3 * lane, add(emissive, scale(nee, c.nl1)));
  p.miss_inc[lane] = miss;
}

void fill_consts(Consts& c, const float* consts) { memcpy(&c, consts, sizeof(Consts)); }

void fill_sample(SampleArgs& p, void* const* ptrs, const int* ints, const float* consts) {
  void** q = reinterpret_cast<void**>(&p);
  for (int k = 0; k < SAMPLE_PTRS; ++k) q[k] = ptrs[k];
  p.m = ints[0];
  p.n_tri = ints[1];
  p.n_tex = ints[2];
  p.qh = ints[3];
  p.qw = ints[4];
  p.nl = ints[5];
  p.tex_flags = ints[6];
  p.fold = ints[7];
  fill_consts(p.c, consts);
}

void fill_mis(MisArgs& p, void* const* ptrs, const int* ints, const float* consts) {
  void** q = reinterpret_cast<void**>(&p);
  for (int k = 0; k < MIS_PTRS; ++k) q[k] = ptrs[k];
  p.m = ints[0];
  p.nl = ints[1];
  p.fold = ints[2];
  fill_consts(p.c, consts);
}

static_assert(sizeof(Consts) == N_CONSTS * sizeof(float), "Consts is packed floats");
static_assert(offsetof(SampleArgs, m) == SAMPLE_PTRS * sizeof(void*), "pointers first");
static_assert(offsetof(MisArgs, m) == MIS_PTRS * sizeof(void*), "pointers first");

#ifdef __CUDACC__
constexpr int BLOCK = 128;

__global__ void __launch_bounds__(BLOCK) shade_sample(const SampleArgs p) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < p.m) shade_sample_lane(p, i);
}

__global__ void __launch_bounds__(BLOCK) shade_mis(const MisArgs p) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < p.m) shade_mis_lane(p, i);
}
#endif

}  // namespace

// Entry points: the pointers, ints and constants are host arrays in the
// order of the Args structs (kernels/shade.py builds them); the launch
// goes on `stream`. Each returns cudaGetLastError() after its launch.
extern "C" {

#ifdef __CUDACC__
int tpurt_shade_sample(void* const* ptrs, const int* ints, const float* consts, void* stream) {
  SampleArgs p;
  fill_sample(p, ptrs, ints, consts);
  if (p.m > 0)
    shade_sample<<<(p.m + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

int tpurt_shade_mis(void* const* ptrs, const int* ints, const float* consts, void* stream) {
  MisArgs p;
  fill_mis(p, ptrs, ints, consts);
  if (p.m > 0) shade_mis<<<(p.m + BLOCK - 1) / BLOCK, BLOCK, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
#else
int tpurt_shade_sample(void* const* ptrs, const int* ints, const float* consts, void*) {
  SampleArgs p;
  fill_sample(p, ptrs, ints, consts);
  for (int i = 0; i < p.m; ++i) shade_sample_lane(p, i);
  return 0;
}

int tpurt_shade_mis(void* const* ptrs, const int* ints, const float* consts, void*) {
  MisArgs p;
  fill_mis(p, ptrs, ints, consts);
  for (int i = 0; i < p.m; ++i) shade_mis_lane(p, i);
  return 0;
}
#endif

}  // extern "C"
