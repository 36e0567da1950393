// Step-cost instrument of the wide-BVH walk for Hopper (sm_90a): K6.
//
// Replaces tpurt/kernels/pallas_wide.py:1384 stepcost_packets running
// _stepcost_kernel, reached through kernel_bench --stepcost (here
// python -m tpurt_torch.kernel_bench --stepcost K). tpurt's instrument
// runs its production step (one 1024-ray packet per program) for exactly
// `steps` steps with each phase switched on or off, so the differences
// between configurations give the cost of each phase per step. The
// port's production step is K1's walk (wide_traverse.cu), so this kernel
// instruments that walk as it is: one thread per ray, the node rows of
// its own octant in the card tables of kernels/wide.py::card_tables
// (16-byte words, child s = [lo.xyz link][hi.xyz kind], triangle k =
// [v0.xyz id][e1.xyz alpha][e2.xyz opaque]), slots loaded four at a time,
// and K1's hit-mask stack in dynamic shared memory laid out
// [depth][thread]: a node visit pushes one entry (row, hit mask | leaf
// mask << 16), a pop takes the lowest set bit. Each ray makes exactly
// `steps` visits, restarting at the root whenever the stack is empty
// (tpurt :1231-1238).
//
// Phases, each a template bool so a phase that is off is compiled out
// and replaced by constants, as in tpurt (:1312-1315):
//   DoBox      the slab tests of the node's child slots; off: hit mask 0x5
//   DoExtract  the link and kind words: the kinds that skip empty slots
//              and end the slot loop, and the accumulator's kind[0] +
//              link[arity-1]; off: every slot below `arity` counts as an
//              internal child (kind 1, link 0)
//   DoPush     writing the hit-mask entry; off: nothing is pushed, so
//              every step visits the root
//   DoLeaf     the G triangle tests of a leaf (no cell masks)
// tpurt's do_collapse and collapse_mode time the TPU's cross-lane
// hit-mask collapse; a walk with one thread per ray has none. The host
// builds and takes only the five combinations of kernel_bench
// (wide.STEPCOST_CONFIGS): full, -leaf, -push, -extract, -box.
//
// Outputs t, prim and acc. acc (uint32, written as int32) carries every
// phase that is on into the output, so the compiler cannot remove it:
// extract adds kind[0] + link[arity-1], box XORs the hit mask, and with
// push off the mask is added.
//
// Why the hit-mask stack gives the plain version's visits. The plain
// version (kernels/wide.py::stepcost_plain) pushes one entry per hit
// child onto a per-ray stack capped at MAX_STACK entries. In the five
// configurations the two visit the same sequence:
//  - push on (full, -leaf): box and extract are on too, so every walk is
//    a real walk of the BVH, in which one entry per hit child, far first,
//    and one hit-mask entry per node, lowest bit first, pop the same
//    children in the same order (K1's argument, walked in Python by
//    tests/test_torch_wide_card.py). The per-child stack then never holds
//    more than the topology's stack bound, which the host checks against
//    MAX_STACK, so the cap is never reached; the hit-mask stack holds at
//    most `depth_bound` entries (past it the kernel ORs cudalib's
//    wide-stack bit into the error word and ends the ray).
//  - push off (-push, -extract, -box): nothing is pushed, so after the
//    root's first visit the plain stack is empty and every step restarts
//    at the root; here the stack is always empty and every step visits
//    the root.
// tests/test_torch_octet_card.py walks this instrument in Python against
// stepcost_plain in all five configurations. With every phase on the walk
// is K1's closest-hit walk without cell masks, so once `steps` covers a
// ray's walk, t and prim equal K1's bit for bit (the restarted walk
// commits nothing: hits need t < t_best). --fmad=false keeps t bit-equal.
//
// Bound. What it costs per step is what it measures; the bound set beside
// it (kernel_bench.traversal_bound) is K1's, from the tests the plain
// version counts.
//
// Plain C interface for ctypes; the entry point returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWordsPerChild = 2;  // float4 words per child slot
constexpr int kWordsPerTri = 3;    // float4 words per triangle
constexpr int kSlotGroup = 4;      // child slots loaded together
constexpr int kDefaultSharedBytes = 48 * 1024;

template <bool DoBox, bool DoExtract, bool DoPush, bool DoLeaf>
__global__ void __launch_bounds__(kThreads)
wide_stepcost(const float4* __restrict__ card_nodes, int n_wide, int arity,
              const float4* __restrict__ card_leaves, int group,
              const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ t_min_in, const float* __restrict__ t_limit_in,
              float* __restrict__ t_out, int* __restrict__ prim_out,
              int* __restrict__ acc_out, int n, int steps, int depth_bound,
              int* __restrict__ err) {
  // a push needs the kinds and links of a real walk (see the header)
  static_assert(!DoPush || (DoBox && DoExtract), "push needs box and extract");
  extern __shared__ int2 stack_mem[];  // [depth][thread], with DoPush
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
  const int row_words = arity * kWordsPerChild;
  const float4* nodes = card_nodes + (size_t)oct * n_wide * row_words;

  float t_best = t_limit_in[i];
  int prim = -1;
  uint32_t acc = 0u;
  int2* stack = stack_mem + threadIdx.x;  // entry k at stack[k * kThreads]
  int sp = 0;

  for (int step = 0; step < steps; ++step) {
    int c = 0;  // the node row or leaf to visit; an empty stack restarts at the root
    bool leaf = false;
    if (DoPush && sp > 0) {
      int2& top = stack[(sp - 1) * kThreads];
      const unsigned bits = (unsigned)top.y;
      const int slot = __ffs(bits) - 1;
      leaf = (bits >> (16 + slot)) & 1u;
      c = __float_as_int(__ldg(&nodes[(size_t)top.x * row_words + kWordsPerChild * slot].w));
      const unsigned rest = bits & ~(0x10001u << slot);
      if (rest == 0u) {
        --sp;
      } else {
        top.y = (int)rest;
      }
    }
    if (!leaf) {
      const float4* row = nodes + (size_t)c * row_words;
      if (DoExtract) {
        acc += (uint32_t)(__float_as_int(__ldg(&row[1].w)) +
                          __float_as_int(__ldg(&row[kWordsPerChild * (arity - 1)].w)));
      }
      unsigned mask = 0x5u, leaf_kind = 0u;
      if (DoBox) {
        mask = 0u;
        for (int s0 = 0; s0 < arity; s0 += kSlotGroup) {
          float4 lo[kSlotGroup], hi[kSlotGroup];
#pragma unroll
          for (int j = 0; j < kSlotGroup; ++j) {
            if (s0 + j < arity) {
              lo[j] = __ldg(row + kWordsPerChild * (s0 + j));
              hi[j] = __ldg(row + kWordsPerChild * (s0 + j) + 1);
            }
          }
#pragma unroll
          for (int j = 0; j < kSlotGroup; ++j) {
            if (s0 + j >= arity) break;
            if (DoExtract) {
              const int kind = __float_as_int(hi[j].w);
              if (kind == 0) continue;  // empty: its inverted box passes the slab test
              if (kind == 2) leaf_kind |= 1u << (s0 + j);
            }
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
            if (tn <= tf) mask |= 1u << (s0 + j);
          }
          // empty slots trail: a group that ends in one is the last
          if (DoExtract && s0 + kSlotGroup <= arity &&
              __float_as_int(hi[kSlotGroup - 1].w) == 0)
            break;
        }
        acc ^= mask;
      }
      if (DoPush) {
        if (mask != 0u) {
          if (sp >= depth_bound) {
            atomicOr(err, 1);  // cudalib.ERR_WIDE_STACK; the ray ends
            return;
          }
          stack[sp * kThreads] = make_int2(c, (int)(mask | ((mask & leaf_kind) << 16)));
          ++sp;
        }
      } else {
        acc += mask;
      }
    } else if (DoLeaf) {
      const float4* tri = card_leaves + (size_t)c * group * kWordsPerTri;
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
        if (ok && u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f && t > t_min && t < t_best) {
          t_best = t;
          prim = __float_as_int(w0.w);
        }
      }
    }
  }
  t_out[i] = t_best;
  prim_out[i] = prim;
  acc_out[i] = (int)acc;
}

template <bool B, bool E, bool P, bool L>
int run(int n, cudaStream_t stream, const float4* card_nodes, int n_wide, int arity,
        const float4* card_leaves, int group, const float* o, const float* d,
        const float* t_min, const float* t_limit, float* t_out, int* prim_out,
        int* acc_out, int steps, int depth_bound, int* err) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = P ? (size_t)kThreads * depth_bound * sizeof(int2) : 0;
  auto kernel = wide_stepcost<B, E, P, L>;
  if (smem > (size_t)kDefaultSharedBytes) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(card_nodes, n_wide, arity, card_leaves, group,
                                              o, d, t_min, t_limit, t_out, prim_out,
                                              acc_out, n, steps, depth_bound, err);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tpurt_stepcost(const void* card_nodes, int n_wide, int arity, const void* card_leaves,
                   int group, const void* o, const void* d, const void* t_min,
                   const void* t_limit, void* t_out, void* prim_out, void* acc_out, int n,
                   int steps, int do_box, int do_extract, int do_push, int do_leaf,
                   int depth_bound, void* err, void* stream) {
  if (n <= 0) return 0;
  if (arity < 1 || arity > 16 || depth_bound < 1) return (int)cudaErrorInvalidValue;
  const int phases = (do_box ? 8 : 0) | (do_extract ? 4 : 0) |
                     (do_push ? 2 : 0) | (do_leaf ? 1 : 0);
  auto s = (cudaStream_t)stream;
  auto* cn = (const float4*)card_nodes;
  auto* cl = (const float4*)card_leaves;
  auto* po = (const float*)o;
  auto* pd = (const float*)d;
  auto* tm = (const float*)t_min;
  auto* tl = (const float*)t_limit;
  auto* to = (float*)t_out;
  auto* pr = (int*)prim_out;
  auto* ac = (int*)acc_out;
  auto* er = (int*)err;
#define TPURT_STEPCOST_CASE(k, B, E, P, L)                                              \
  case k:                                                                               \
    return run<B, E, P, L>(n, s, cn, n_wide, arity, cl, group, po, pd, tm, tl, to, pr,  \
                           ac, steps, depth_bound, er);
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
}

}  // extern "C"
