// Step-cost instrument of the wide-BVH walk for Hopper (sm_90a): K6.
//
// Replaces tpurt/kernels/pallas_wide.py::stepcost_packets running
// _stepcost_kernel, reached through kernel_bench --stepcost (here
// python -m tpurt_torch.kernel_bench --stepcost K). tpurt's instrument
// runs its production step (one 1024-ray packet per program) for exactly
// `steps` steps with each phase switched on or off, so the differences
// between configurations give the cost of each phase per step. The
// port's production step is K1's per-ray walk (wide_traverse.cu), so
// this kernel instruments that walk: one thread per ray, its own octant,
// a local-memory stack, exactly `steps` pops, restarting from the root
// whenever the stack is empty (tpurt :1231-1238).
//
// Phases, each a template bool so a phase that is off is compiled out
// and replaced by constants, as in tpurt (:1312-1315):
//   DoBox      the slab tests of the node's child boxes; off: hit mask 0x5
//   DoExtract  the load of the 16 links and 16 kinds; off: kind 1, link 0
//   DoPush     the stack writes (far-first, capped at the stack's size);
//              off: nothing is pushed
//   DoLeaf     the G triangle tests of a leaf (no cell masks)
// tpurt's do_collapse and collapse_mode time the TPU's cross-lane
// hit-mask collapse; a walk with one thread per ray has no collapse, so
// there is no such phase here.
//
// Outputs t, prim and acc. acc (uint32, written as int32) carries every
// phase that is on into the output, so the compiler cannot remove it:
// extract adds kind[0] + link[arity-1], box XORs the hit mask, and with
// push off the mask is added. With every phase on the walk is K1's
// closest-hit walk without cell masks, so once `steps` covers a ray's
// walk, t and prim equal K1's bit for bit (the restarted walk commits
// nothing: hits need t < t_best). The plain version
// (kernels/wide.py::stepcost_plain) fixes all three outputs for every
// combination of phases; --fmad=false keeps t bit-equal to it.
//
// Bound. What it costs per step is what it measures; the bound PERF.md
// sets beside it is K1's, from the tests the plain version counts.
//
// Plain C interface for ctypes; the entry point returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kMaxStack = 256;
constexpr int kMaxArity = 16;
constexpr int kThreads = 128;

template <bool DoBox, bool DoExtract, bool DoPush, bool DoLeaf>
__global__ void __launch_bounds__(kThreads)
wide_stepcost(const float* __restrict__ node_rows, int n_wide,
              const float* __restrict__ tri_rows, int row_width,
              const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ t_min_in,
              const float* __restrict__ t_limit_in,
              float* __restrict__ t_out, int* __restrict__ prim_out,
              int* __restrict__ acc_out, int n, int group, int arity,
              int id_base, int steps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float t_min = t_min_in[i];
  const float tiny = 1e-20f;
  const float inv_x = (dx >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dx), tiny);
  const float inv_y = (dy >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dy), tiny);
  const float inv_z = (dz >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dz), tiny);
  const int oct = (dx < 0.0f ? 4 : 0) + (dy < 0.0f ? 2 : 0) + (dz < 0.0f ? 1 : 0);
  const float* nodes = node_rows + (size_t)oct * n_wide * kLane;
  const int link0 = 6 * arity, kind0 = 7 * arity;

  float t_best = t_limit_in[i];
  int prim = -1;
  uint32_t acc = 0u;
  int stack[kMaxStack];
  int sp = 0;
  stack[sp++] = 0;  // wide root

  for (int step = 0; step < steps; ++step) {
    int entry = 0;  // an empty stack restarts at the root
    if (sp > 0) entry = stack[--sp];
    if (entry >= 0) {
      const float* row = nodes + (size_t)entry * kLane;
      int kinds[kMaxArity], links[kMaxArity];
#pragma unroll
      for (int s = 0; s < kMaxArity; ++s) {
        if (DoExtract) {
          kinds[s] = s < arity ? (int)__ldg(row + kind0 + s) : 0;
          links[s] = s < arity ? (int)__ldg(row + link0 + s) : 0;
        } else {
          kinds[s] = s < arity ? 1 : 0;
          links[s] = 0;
        }
      }
      if (DoExtract) {
        int last = 0;  // links[arity - 1] without a dynamic register index
#pragma unroll
        for (int s = 0; s < kMaxArity; ++s)
          if (s == arity - 1) last = links[s];
        acc += (uint32_t)(kinds[0] + last);
      }
      unsigned mask = 0x5u;
      if (DoBox) {
        mask = 0u;
#pragma unroll
        for (int s = 0; s < kMaxArity; ++s) {
          if (kinds[s] <= 0) continue;
          const float* b = row + 6 * s;
          const float t0x = (__ldg(b + 0) - ox) * inv_x;
          const float t0y = (__ldg(b + 1) - oy) * inv_y;
          const float t0z = (__ldg(b + 2) - oz) * inv_z;
          const float t1x = (__ldg(b + 3) - ox) * inv_x;
          const float t1y = (__ldg(b + 4) - oy) * inv_y;
          const float t1z = (__ldg(b + 5) - oz) * inv_z;
          const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                 fmaxf(fminf(t0z, t1z), t_min));
          const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                 fminf(fmaxf(t0z, t1z), t_best));
          if (tn <= tf) mask |= 1u << s;
        }
        acc ^= mask;
      }
      if (DoPush) {
#pragma unroll
        for (int s = kMaxArity - 1; s >= 0; --s) {
          if (((mask >> s) & 1u) && kinds[s] > 0 && sp < kMaxStack)
            stack[sp++] = kinds[s] == 2 ? -(links[s] + 1) : links[s];
        }
      } else {
        acc += mask;
      }
    } else if (DoLeaf) {
      const float* row = tri_rows + (size_t)(-entry - 1) * row_width;
      for (int k = 0; k < group; ++k) {
        const float* v = row + 9 * k;
        const float v0x = __ldg(v + 0), v0y = __ldg(v + 1), v0z = __ldg(v + 2);
        const float e1x = __ldg(v + 3) - v0x, e1y = __ldg(v + 4) - v0y,
                    e1z = __ldg(v + 5) - v0z;
        const float e2x = __ldg(v + 6) - v0x, e2y = __ldg(v + 7) - v0y,
                    e2z = __ldg(v + 8) - v0z;
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
        if (ok && u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f && t > t_min &&
            t < t_best) {
          t_best = t;
          prim = (int)__ldg(row + id_base + k);
        }
      }
    }
  }
  t_out[i] = t_best;
  prim_out[i] = prim;
  acc_out[i] = (int)acc;
}

template <bool B, bool E, bool P, bool L>
void run(int blocks, cudaStream_t stream, const float* node_rows, int n_wide,
         const float* tri_rows, int row_width, const float* o, const float* d,
         const float* t_min, const float* t_limit, float* t_out, int* prim_out,
         int* acc_out, int n, int group, int arity, int id_base, int steps) {
  wide_stepcost<B, E, P, L><<<blocks, kThreads, 0, stream>>>(
      node_rows, n_wide, tri_rows, row_width, o, d, t_min, t_limit, t_out,
      prim_out, acc_out, n, group, arity, id_base, steps);
}

}  // namespace

extern "C" {

int tpurt_stepcost(const void* node_rows, int n_wide, const void* tri_rows,
                   int row_width, const void* o, const void* d,
                   const void* t_min, const void* t_limit, void* t_out,
                   void* prim_out, void* acc_out, int n, int group, int arity,
                   int id_base, int steps, int do_box, int do_extract,
                   int do_push, int do_leaf, void* stream) {
  if (n <= 0) return 0;
  if (arity > kMaxArity || arity < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + kThreads - 1) / kThreads;
  const int phases = (do_box ? 8 : 0) | (do_extract ? 4 : 0) |
                     (do_push ? 2 : 0) | (do_leaf ? 1 : 0);
  auto s = (cudaStream_t)stream;
  const float* nr = (const float*)node_rows;
  const float* tr = (const float*)tri_rows;
  const float* po = (const float*)o;
  const float* pd = (const float*)d;
  const float* tm = (const float*)t_min;
  const float* tl = (const float*)t_limit;
  float* to = (float*)t_out;
  int* pr = (int*)prim_out;
  int* ac = (int*)acc_out;
#define TPURT_STEPCOST_CASE(k, B, E, P, L)                                   \
  case k:                                                                    \
    run<B, E, P, L>(blocks, s, nr, n_wide, tr, row_width, po, pd, tm, tl, to, \
                    pr, ac, n, group, arity, id_base, steps);                \
    break;
  // the five configurations of kernel_bench (wide.STEPCOST_CONFIGS), each
  // dropping one phase more: full, -leaf, -push, -extract, -box
  switch (phases) {
    TPURT_STEPCOST_CASE(15, true, true, true, true)
    TPURT_STEPCOST_CASE(14, true, true, true, false)
    TPURT_STEPCOST_CASE(12, true, true, false, false)
    TPURT_STEPCOST_CASE(8, true, false, false, false)
    TPURT_STEPCOST_CASE(0, false, false, false, false)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TPURT_STEPCOST_CASE
  return (int)cudaGetLastError();
}

}  // extern "C"
