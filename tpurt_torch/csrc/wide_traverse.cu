// Wide-BVH ray traversal for Hopper (sm_90a): closest hit (K1) and
// occlusion (K2) in one templated kernel.
//
// Replaces tpurt/kernels/pallas_wide.py:1500 _wide_packets running
// _wide_kernel with occlusion=False (K1, reached through
// traverse_packets) and occlusion=True (K2, reached through
// occlusion_packets). It reads the card tables that
// kernels/wide.py::card_tables copies out of tpurt's rows once per BVH,
// laid out for 16-byte loads:
//
//   node row (per octant, W rows of arity x 32 B): child s is two words,
//     [lo.x lo.y lo.z link] and [hi.x hi.y hi.z kind], link and kind as
//     int bits; children sorted near to far, empty slots (kind 0) last;
//   leaf row (G x 48 B): triangle k is three words, [v0.xyz, id],
//     [e1.xyz, alpha mask] and [e2.xyz, opaque mask], e1 = v1 - v0 and
//     e2 = v2 - v0 taken in f32 (the same bits as the subtraction the
//     plain version does), masks 0 where the table has no such column.
//
// Contract and order. One thread per ray; the ray walks the node rows of
// its own direction octant in the order of the plain version
// (kernels/wide.py::traverse_plain): depth first, a node's hit children
// nearest slot first, each box tested against the ray's t_best of that
// visit. The slab test and the Moller-Trumbore test repeat its expression
// order and the library is built with --fmad=false, so t, prim and the
// flag (pending in K1 with cell masks, blocked in K2) are bit-equal to it.
// The order is part of the contract: K2's blocked flag and t/prim on a
// pending ray, and K1's prim on an exact-t tie, depend on which hit is
// met first.
//
// Alpha re-trace (the Alpha instantiations, for scenes with alpha-MASK
// materials). After its walk the thread does for its own ray what the
// host loops of integrator/wavefront.py (_trace, _shadow_blocked) do for
// it: the alpha test of the committed hit (with cell masks K1's pending
// flag, else DeviceScene.tri_alpha; then the decided cells of the fused
// alpha row, else the NEAREST tap of the quad atlas); on a rejection it
// walks again from the wide root with t_min = t * (1 + 1e-6) + 1e-5 (two
// roundings) and t_best reset to its t_limit, at most max_skips times,
// after which a rejected hit stands as a surface (K1) or blocks (K2). K1
// applies closest_hit's sphere-light test after each walk, at that walk's
// t_min, in intersect_spheres' expression order; a sphere hit ends the
// ray untested. K2 ends a ray at a definite blocker and blocks it at an
// uncertain hit the test passes. So t, prim, u, v, kind and the flag are,
// ray by ray, the host loop's bit for bit; the loop's compaction and sort
// only changed which rays shared a warp (kernels/wide.py::alpha_walk_plain
// is the full-width plain version). Each launch also writes the most
// re-traces any of its rays took, which is the number of passes the host
// loop ran, and whether a ray ended at the cap still rejected (atomicMax
// and atomicOr, one of each per converged group of a warp).
//
// Design, against what held the first version back:
//  1. Scalar, unaligned loads (tpurt's rows keep boxes at a 24-byte
//     stride and links/kinds as floats in separate lanes): a child box is
//     now two 16-byte __ldg loads that carry its link and kind, and a
//     triangle three, with the edges precomputed. A node's slots are
//     loaded four at a time, so the loads of a group are in flight
//     together, and the walk stops after the first group that ends in an
//     empty slot.
//  2. One push per hit child onto a 256-int local stack: a node visit now
//     pushes one entry, (row, hit mask | leaf mask << 16), and a pop takes
//     the lowest set bit, the nearest hit child. That is exactly the
//     plain version's far-first per-child push. The stack holds at most
//     one entry per internal level of the wide tree; the host computes
//     that depth bound from the collapse and sizes the stack with it. The
//     entries live in dynamic shared memory laid out [depth][thread], so a
//     warp's 8-byte entries fall on distinct banks; keeping the top entry
//     in registers instead took more registers and measured no faster
//     (PERF.md). An entry past the bound ORs cudalib's wide-stack bit into
//     the card's error word and ends the ray.
//  3. The if-if loop that ran node and leaf steps of one warp one after
//     the other: the walk is while-while (Aila & Laine, HPG 2009): node
//     steps until the next entry is a leaf, then that leaf and any leaves
//     that follow it. Each thread keeps its own order; only the way the
//     warp converges changes. K2 leaves after the whole leaf that found a
//     definite blocker, as before, since the remaining triangles of that
//     leaf still update t/prim.
// No barrier is taken in the walk, so a thread that finishes early
// strands nobody.
//
// Bound. A box test is ~25 f32 operations and a triangle test ~60, so at
// the bench's shapes the work is bound by operations against the
// 67 TFLOP/s f32 rate; the card tables (about 30 MB at the bench's
// 215,296 triangles) fit the 50 MB L2. What the kernel pays for is an
// incoherent, divergent walk, not the arithmetic (PERF.md records its
// time beside the bound computed from the plain version's test counts).
// With the alpha re-trace a ray's work is its walks summed, and a warp
// waits for its slowest ray: up to max_skips + 1 walks, each with one
// texel load, against a host pass loop that waited on the host for every
// pass.
//
// Plain C interface for ctypes: pointers and the stream come in as
// void*, each entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kEnd = INT_MIN;           // the walk is over
constexpr int kWordsPerChild = 2;       // float4 words per child slot
constexpr int kWordsPerTri = 3;         // float4 words per triangle
constexpr int kSlotGroup = 4;           // child slots loaded together
constexpr int kDefaultSharedBytes = 48 * 1024;

// The hit-mask stack of one thread: entries (row, hit | leaf << 16), each
// with a bit left, at most `cap` of them.
struct MaskStack {
  int2* base;  // this thread's column of the [depth][thread] array
  int cap;
  int sp;

  __device__ __forceinline__ MaskStack(int2* shared, int cap_)
      : base(shared + threadIdx.x), cap(cap_), sp(0) {}

  // false when the entry does not fit under the bound
  __device__ __forceinline__ bool push(int row, unsigned bits) {
    if (sp >= cap) return false;
    base[sp * kThreads] = make_int2(row, (int)bits);
    ++sp;
    return true;
  }

  // the nearest hit child left: its node row, slot and whether it is a
  // leaf; false when the stack is empty
  __device__ __forceinline__ bool pop(int& row, int& slot, bool& leaf) {
    if (sp == 0) return false;
    int2& top = base[(sp - 1) * kThreads];
    const unsigned bits = (unsigned)top.y;
    row = top.x;
    slot = __ffs(bits) - 1;
    leaf = (bits >> (16 + slot)) & 1u;
    const unsigned rest = bits & ~(0x10001u << slot);
    if (rest == 0u) {
      --sp;
    } else {
      top.y = (int)rest;
    }
    return true;
  }
};

// The alpha test's tables (DeviceScene's) and the re-trace cap, read by
// the Alpha instantiations only (the others get a zeroed copy).
struct AlphaArgs {
  const unsigned char* tri_alpha;   // (T,) bool: the triangle is alpha tested
  const float* alpha_row;           // (T, 11) DeviceScene.tri_alpha_row
  const int* tex_table;             // (NT, 10) DeviceScene.tex_table
  const unsigned char* atlas_quad;  // (QH x QW, 16) DeviceScene.atlas_quad
  const float* lights;              // (nl, 8), K1's sphere test
  const unsigned char* active;      // (n,) bool, K1's sphere test
  float* u_out;                     // (n,) the committed triangle's barycentrics
  float* v_out;
  int* kind_out;                    // (n,) KIND_MISS, KIND_TRIANGLE or (K1) KIND_SPHERE
  int* counters;                    // [most re-traces of a lane, a lane capped still rejected], or null
  int n_tri, n_tex, qh, qw;
  int nl;                           // lights K1 tests (0: no sphere test)
  int max_skips;
  float t_max;
};

constexpr int kKindMiss = 0, kKindTriangle = 1, kKindSphere = 2;
constexpr int kNoTexture = 0xFFFF;
constexpr int kWrapRepeat = 0, kWrapMirrored = 1;
constexpr int kAlphaRow = 11, kTexRow = 10;
constexpr float kInv255 = (float)(1.0 / 255.0);
// wavefront._retrace_tmin: t * (1 + 1e-6) + 1e-5, two roundings
constexpr float kRetraceScale = (float)(1.0 + 1e-6);
constexpr float kRetraceBias = (float)1e-5;

// torch.clamp(x, min=lo) and torch.minimum: a NaN passes
__device__ __forceinline__ float clamp_lo(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// texture._wrap_f32
__device__ __forceinline__ float wrap_f32(float x, float size, int mode) {
  float r = x - floorf(x / size) * size;
  r = r < 0.0f ? r + size : (r >= size ? r - size : r);
  const float period = 2.0f * size;
  float m = x - floorf(x / period) * period;
  m = m < 0.0f ? m + period : (m >= period ? m - period : m);
  const float mir = m < size ? m : (period - 1.0f) - m;
  const float clamped = minimum(clamp_lo(x, 0.0f), size - 1.0f);
  return mode == kWrapRepeat ? r : (mode == kWrapMirrored ? mir : clamped);
}

__device__ __forceinline__ int clamp_prim(const AlphaArgs& al, int prim) {
  return min(max(prim, 0), al.n_tri - 1);
}

// DeviceScene.tri_alpha at the hit's clamped triangle id
__device__ __forceinline__ bool alpha_tested(const AlphaArgs& al, int prim) {
  return __ldg(al.tri_alpha + clamp_prim(al, prim)) != 0;
}

// wavefront._alpha_eval for one tested hit: the decided cells of the
// fused alpha row (intersect.mask_cell), else the single NEAREST tap of
// texture.sample_texture_alpha_quad, NO_TEXTURE reading as opaque, below
// the cutoff
__device__ bool alpha_rejected(const AlphaArgs& al, int prim, float u, float v) {
  const float* row = al.alpha_row + (size_t)clamp_prim(al, prim) * kAlphaRow;
  const int cu = min(max((int)fminf(fmaxf(u * 4.0f, 0.0f), 4.0f), 0), 3);
  const int cv = min(max((int)fminf(fmaxf(v * 4.0f, 0.0f), 4.0f), 0), 3);
  const int cell = cu * 4 + cv;
  if (((int)__ldg(row + 9) >> cell) & 1) return true;
  if (((int)__ldg(row + 10) >> cell) & 1) return false;
  const float w0 = (1.0f - u) - v;
  const float uv_u = (w0 * __ldg(row + 3) + u * __ldg(row + 5)) + v * __ldg(row + 7);
  const float uv_v = (w0 * __ldg(row + 4) + u * __ldg(row + 6)) + v * __ldg(row + 8);
  const int tex = (int)__ldg(row + 2);
  float a = 1.0f;
  if (tex != kNoTexture) {
    const int* tr = al.tex_table + (size_t)min(max(tex, 0), al.n_tex - 1) * kTexRow;
    const float wf = clamp_lo((float)__ldg(tr + 2), 1.0f);
    const float hf = clamp_lo((float)__ldg(tr + 3), 1.0f);
    const int xw = (int)wrap_f32(floorf(uv_u * wf), wf, __ldg(tr + 4)) + __ldg(tr + 8);
    const int yw = (int)wrap_f32(floorf(uv_v * hf), hf, __ldg(tr + 5)) + __ldg(tr + 9);
    const int idx = min(max(yw * al.qw + xw, 0), al.qh * al.qw - 1);
    a = (float)__ldg(al.atlas_quad + 16 * (size_t)idx + 3) * kInv255;
  }
  return a < __ldg(row + 1);
}

// intersect.intersect_spheres from t_min: ray_sphere_reference over every
// light in its expression order, the first light of least t
__device__ void nearest_sphere(const AlphaArgs& al, float ox, float oy, float oz, float dx,
                               float dy, float dz, float t_min, bool& hit, float& t_best,
                               int& best) {
  t_best = INFINITY;
  best = 0;
  for (int l = 0; l < al.nl; ++l) {
    const float* lt = al.lights + 8 * l;
    const float cx = ox - __ldg(lt), cy = oy - __ldg(lt + 1), cz = oz - __ldg(lt + 2);
    const float r = __ldg(lt + 3);
    const float b = dx * cx + dy * cy + dz * cz;
    const float cq = (cx * cx + cy * cy + cz * cz) - r * r;
    const float b2 = 2.0f * b;
    const float disc = b2 * b2 - 4.0f * cq;
    const float sqrt_disc = sqrtf(clamp_lo(disc, 0.0f));
    const float q = b > 0.0f ? -b - sqrt_disc : -b + sqrt_disc;
    const float q_safe = q == 0.0f ? (float)1e-20 : q;
    const float t = minimum(q, cq / q_safe);
    const float ti = (disc >= 0.0f && t > t_min && t < al.t_max) ? t : INFINITY;
    if (ti < t_best) {
      t_best = ti;
      best = l;
    }
  }
  hit = isfinite(t_best);
}

template <bool Occlusion, bool Masks, bool Alpha>
__global__ void __launch_bounds__(kThreads)
wide_walk(const float4* __restrict__ card_nodes, int n_wide, int arity,
          const float4* __restrict__ card_leaves, int group,
          const float* __restrict__ o, const float* __restrict__ d,
          const float* __restrict__ t_min_in, const float* __restrict__ t_limit_in,
          float* __restrict__ t_out, int* __restrict__ prim_out,
          float* __restrict__ flag_out, int n, int all_definite, int depth_bound,
          int* __restrict__ err, const AlphaArgs al) {
  extern __shared__ int2 stack_mem[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
  float t_min = t_min_in[i];
  const float tiny = 1e-20f;
  // sign / max(|d|, 1e-20), as pallas_wide.py:544-547
  const float inv_x = (dx >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dx), tiny);
  const float inv_y = (dy >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dy), tiny);
  const float inv_z = (dz >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dz), tiny);
  const int oct = (dx < 0.0f ? 4 : 0) + (dy < 0.0f ? 2 : 0) + (dz < 0.0f ? 1 : 0);
  const int row_words = arity * kWordsPerChild;
  const float4* nodes = card_nodes + (size_t)oct * n_wide * row_words;

  float t_best;
  int prim;
  float flag;  // blocked (K2) or pending (K1 with cell masks)
  float hit_u, hit_v;  // Alpha: the committed triangle's barycentrics
  int hit_kind = kKindMiss;  // Alpha
  int retraces = 0;  // Alpha: walks after the first
  bool capped = false;  // Alpha: the last walk's hit was still rejected
  bool overflow = false;

  // one walk from the wide root over (t_min, t_limit]; with Alpha, again
  // from just past each hit the alpha test rejects, as the host loop does
  for (;;) {
    t_best = t_limit_in[i];
    prim = -1;
    flag = 0.0f;
    hit_u = hit_v = 0.0f;
    MaskStack stack(stack_mem, depth_bound);

    // next entry: a node row (>= 0), a leaf as -(leaf + 1), or kEnd
    auto next = [&]() -> int {
      int row, slot;
      bool leaf;
      if (!stack.pop(row, slot, leaf)) return kEnd;
      const int link = __float_as_int(
          __ldg(&nodes[(size_t)row * row_words + kWordsPerChild * slot].w));
      return leaf ? -(link + 1) : link;
    };

    int c = 0;  // the wide root
    while (c != kEnd) {
      // ---- node steps, until the next entry is a leaf ----
      while (c >= 0) {
        const float4* row = nodes + (size_t)c * row_words;
        unsigned hit = 0u, leaf = 0u;
        for (int s0 = 0; s0 < arity; s0 += kSlotGroup) {
          float4 lo[kSlotGroup], hi[kSlotGroup];
#pragma unroll
          for (int j = 0; j < kSlotGroup; ++j) {
            if (s0 + j < arity) {
              lo[j] = __ldg(row + kWordsPerChild * (s0 + j));
              hi[j] = __ldg(row + kWordsPerChild * (s0 + j) + 1);
            } else {
              hi[j].w = __int_as_float(0);
            }
          }
#pragma unroll
          for (int j = 0; j < kSlotGroup; ++j) {
            const int kind = __float_as_int(hi[j].w);
            if (kind == 0) continue;  // empty: its inverted box passes the slab test
            const float t0x = (lo[j].x - ox) * inv_x;
            const float t0y = (lo[j].y - oy) * inv_y;
            const float t0z = (lo[j].z - oz) * inv_z;
            const float t1x = (hi[j].x - ox) * inv_x;
            const float t1y = (hi[j].y - oy) * inv_y;
            const float t1z = (hi[j].z - oz) * inv_z;
            const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                   fmaxf(fminf(t0z, t1z), t_min));
            const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                   fminf(fmaxf(t0z, t1z), t_best));
            if (tn <= tf) {
              hit |= 1u << (s0 + j);
              if (kind == 2) leaf |= 1u << (s0 + j);
            }
          }
          // empty slots trail: a group that ends in one is the last
          if (__float_as_int(hi[kSlotGroup - 1].w) == 0) break;
        }
        if (hit != 0u && !stack.push(c, hit | (leaf << 16))) {
          overflow = true;
          c = kEnd;
          break;
        }
        c = next();
      }

      // ---- leaf steps, while the next entry is a leaf ----
      while (c < 0 && c != kEnd) {
        const float4* tri = card_leaves + (size_t)(-c - 1) * group * kWordsPerTri;
        for (int k = 0; k < group; ++k) {
          const float4 w0 = __ldg(tri + kWordsPerTri * k);
          const float4 w1 = __ldg(tri + kWordsPerTri * k + 1);
          const float4 w2 = __ldg(tri + kWordsPerTri * k + 2);
          const float v0x = w0.x, v0y = w0.y, v0z = w0.z;
          const float e1x = w1.x, e1y = w1.y, e1z = w1.z;
          const float e2x = w2.x, e2y = w2.y, e2z = w2.z;
          const float px = dy * e2z - dz * e2y;
          const float py = dz * e2x - dx * e2z;
          const float pz = dx * e2y - dy * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const bool ok = fabsf(det) > 1e-12f;
          const float inv_det = ok ? 1.0f / det : 0.0f;
          const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
          const float u = (tx * px + ty * py + tz * pz) * inv_det;
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float vv = (dx * qx + dy * qy + dz * qz) * inv_det;
          const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          const bool hit = ok && u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f &&
                           t > t_min && t < t_best;
          if (!hit) continue;
          bool testable = false;
          if (Masks) {
            const int m = __float_as_int(w1.w);
            const int cu = min(max((int)(u * 4.0f), 0), 3);
            const int cv = min(max((int)(vv * 4.0f), 0), 3);
            const int cell = cu * 4 + cv;
            if ((m >> cell) & 1) continue;  // decided-transparent cell
            const int om = __float_as_int(w2.w);  // 0 without an opaque column
            testable = ((m >> 16) & 1) == 1 && ((om >> cell) & 1) == 0;
          }
          t_best = t;
          prim = __float_as_int(w0.w);
          if (Alpha) {
            hit_u = u;
            hit_v = vv;
          }
          if (Occlusion) {
            if (Masks ? !testable : all_definite) flag = 1.0f;
          } else if (Masks) {
            flag = testable ? 1.0f : 0.0f;
          }
        }
        c = (Occlusion && flag != 0.0f) ? kEnd : next();
      }
    }
    if (!Alpha || overflow) break;

    // ---- Alpha: the host loop's test of this walk's hit ----
    bool rejected;
    if (Occlusion) {
      // _shadow_blocked: a definite blocker ends the ray, a miss leaves it
      // unblocked, an uncertain hit the test passes blocks it
      if (flag != 0.0f || prim < 0) break;
      rejected = (Masks || alpha_tested(al, prim)) && alpha_rejected(al, prim, hit_u, hit_v);
      if (!rejected) {
        flag = 1.0f;
        break;
      }
    } else {
      // closest_hit's miss and sphere lights, then _alpha_rejected
      hit_kind = prim >= 0 ? kKindTriangle : kKindMiss;
      if (prim < 0) t_best = al.t_max;
      if (al.nl > 0 && al.active[i]) {
        bool s_hit;
        float s_t;
        int s_id;
        nearest_sphere(al, ox, oy, oz, dx, dy, dz, t_min, s_hit, s_t, s_id);
        if (s_hit && s_t < t_best) {  // a sphere hit is never alpha tested
          t_best = s_t;
          prim = s_id;
          hit_kind = kKindSphere;
          flag = 0.0f;
        }
      }
      const bool tested = Masks ? flag != 0.0f
                                : hit_kind == kKindTriangle && alpha_tested(al, prim);
      rejected = tested && alpha_rejected(al, prim, hit_u, hit_v);
      if (!rejected) break;
    }
    if (retraces == al.max_skips) {  // the cap: the rejected hit stands (K2: blocks)
      capped = true;
      if (Occlusion) flag = 1.0f;
      break;
    }
    t_min = t_best * kRetraceScale + kRetraceBias;
    ++retraces;
  }
  if (overflow) {
    atomicOr(err, 1);  // cudalib.ERR_WIDE_STACK
    return;
  }
  t_out[i] = t_best;
  prim_out[i] = prim;
  flag_out[i] = flag;
  if (Alpha) {
    al.u_out[i] = hit_u;
    al.v_out[i] = hit_v;
    al.kind_out[i] = Occlusion ? (prim >= 0 ? kKindTriangle : kKindMiss) : hit_kind;
    if (al.counters != nullptr) {  // one atomic per converged group of the warp
      const unsigned group_mask = __activemask();
      const int most = __reduce_max_sync(group_mask, retraces);
      const unsigned any_capped = __reduce_or_sync(group_mask, capped ? 1u : 0u);
      if ((int)(threadIdx.x & 31) == __ffs(group_mask) - 1) {
        if (most > 0) atomicMax(al.counters, most);
        if (any_capped) atomicOr(al.counters + 1, 1);
      }
    }
  }
}

template <bool Occlusion, bool Masks, bool Alpha>
int launch_walk(const void* card_nodes, int n_wide, int arity, const void* card_leaves,
                int group, const void* o, const void* d, const void* t_min,
                const void* t_limit, void* t_out, void* prim_out, void* flag_out, int n,
                int all_definite, int depth_bound, void* err, void* stream,
                const AlphaArgs& al) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = (size_t)kThreads * depth_bound * sizeof(int2);
  auto kernel = wide_walk<Occlusion, Masks, Alpha>;
  if (smem > (size_t)kDefaultSharedBytes) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)card_nodes, n_wide, arity, (const float4*)card_leaves, group,
      (const float*)o, (const float*)d, (const float*)t_min, (const float*)t_limit,
      (float*)t_out, (int*)prim_out, (float*)flag_out, n, all_definite, depth_bound,
      (int*)err, al);
  return (int)cudaGetLastError();
}

template <bool Occlusion, bool Alpha>
int launch(const void* card_nodes, int n_wide, int arity, const void* card_leaves,
           int group, const void* o, const void* d, const void* t_min, const void* t_limit,
           void* t_out, void* prim_out, void* flag_out, int n, int apply_masks,
           int all_definite, int depth_bound, void* err, void* stream,
           const AlphaArgs& al) {
  if (n <= 0) return 0;
  auto* fn = apply_masks ? &launch_walk<Occlusion, true, Alpha>
                         : &launch_walk<Occlusion, false, Alpha>;
  return fn(card_nodes, n_wide, arity, card_leaves, group, o, d, t_min, t_limit, t_out,
            prim_out, flag_out, n, all_definite, depth_bound, err, stream, al);
}

// the AlphaArgs of an entry point's trailing arguments
AlphaArgs alpha_args(const void* tri_alpha, const void* alpha_row, const void* tex_table,
                     const void* atlas_quad, const void* lights, const void* active,
                     void* u_out, void* v_out, void* kind_out, void* counters, int n_tri,
                     int n_tex, int qh, int qw, int nl, int max_skips, float t_max) {
  AlphaArgs al;
  al.tri_alpha = (const unsigned char*)tri_alpha;
  al.alpha_row = (const float*)alpha_row;
  al.tex_table = (const int*)tex_table;
  al.atlas_quad = (const unsigned char*)atlas_quad;
  al.lights = (const float*)lights;
  al.active = (const unsigned char*)active;
  al.u_out = (float*)u_out;
  al.v_out = (float*)v_out;
  al.kind_out = (int*)kind_out;
  al.counters = (int*)counters;
  al.n_tri = n_tri;
  al.n_tex = n_tex;
  al.qh = qh;
  al.qw = qw;
  al.nl = nl;
  al.max_skips = max_skips;
  al.t_max = t_max;
  return al;
}

}  // namespace

extern "C" {

int tpurt_wide_closest(const void* card_nodes, int n_wide, int arity,
                       const void* card_leaves, int group, const void* o, const void* d,
                       const void* t_min, const void* t_limit, void* t_out,
                       void* prim_out, void* flag_out, int n, int apply_masks,
                       int all_definite, int depth_bound, void* err, void* stream) {
  return launch<false, false>(card_nodes, n_wide, arity, card_leaves, group, o, d, t_min,
                              t_limit, t_out, prim_out, flag_out, n, apply_masks,
                              all_definite, depth_bound, err, stream, AlphaArgs{});
}

int tpurt_wide_occlusion(const void* card_nodes, int n_wide, int arity,
                         const void* card_leaves, int group, const void* o,
                         const void* d, const void* t_min, const void* t_limit,
                         void* t_out, void* prim_out, void* flag_out, int n,
                         int apply_masks, int all_definite, int depth_bound, void* err,
                         void* stream) {
  return launch<true, false>(card_nodes, n_wide, arity, card_leaves, group, o, d, t_min,
                             t_limit, t_out, prim_out, flag_out, n, apply_masks,
                             all_definite, depth_bound, err, stream, AlphaArgs{});
}

// K1/K2 with the in-kernel alpha re-trace: the arguments of the two above,
// then the AlphaArgs fields in their order
int tpurt_wide_closest_alpha(const void* card_nodes, int n_wide, int arity,
                             const void* card_leaves, int group, const void* o,
                             const void* d, const void* t_min, const void* t_limit,
                             void* t_out, void* prim_out, void* flag_out, int n,
                             int apply_masks, int all_definite, int depth_bound, void* err,
                             void* stream, const void* tri_alpha, const void* alpha_row,
                             const void* tex_table, const void* atlas_quad,
                             const void* lights, const void* active, void* u_out,
                             void* v_out, void* kind_out, void* counters, int n_tri,
                             int n_tex, int qh, int qw, int nl, int max_skips, float t_max) {
  return launch<false, true>(
      card_nodes, n_wide, arity, card_leaves, group, o, d, t_min, t_limit, t_out, prim_out,
      flag_out, n, apply_masks, all_definite, depth_bound, err, stream,
      alpha_args(tri_alpha, alpha_row, tex_table, atlas_quad, lights, active, u_out, v_out,
                 kind_out, counters, n_tri, n_tex, qh, qw, nl, max_skips, t_max));
}

int tpurt_wide_occlusion_alpha(const void* card_nodes, int n_wide, int arity,
                               const void* card_leaves, int group, const void* o,
                               const void* d, const void* t_min, const void* t_limit,
                               void* t_out, void* prim_out, void* flag_out, int n,
                               int apply_masks, int all_definite, int depth_bound,
                               void* err, void* stream, const void* tri_alpha,
                               const void* alpha_row, const void* tex_table,
                               const void* atlas_quad, const void* lights,
                               const void* active, void* u_out, void* v_out,
                               void* kind_out, void* counters, int n_tri, int n_tex, int qh,
                               int qw, int nl, int max_skips, float t_max) {
  return launch<true, true>(
      card_nodes, n_wide, arity, card_leaves, group, o, d, t_min, t_limit, t_out, prim_out,
      flag_out, n, apply_masks, all_definite, depth_bound, err, stream,
      alpha_args(tri_alpha, alpha_row, tex_table, atlas_quad, lights, active, u_out, v_out,
                 kind_out, counters, n_tri, n_tex, qh, qw, nl, max_skips, t_max));
}

}  // extern "C"
