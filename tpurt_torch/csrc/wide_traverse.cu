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
//
// Plain C interface for ctypes: pointers and the stream come in as
// void*, each entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <limits.h>
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

template <bool Occlusion, bool Masks>
__global__ void __launch_bounds__(kThreads)
wide_walk(const float4* __restrict__ card_nodes, int n_wide, int arity,
          const float4* __restrict__ card_leaves, int group,
          const float* __restrict__ o, const float* __restrict__ d,
          const float* __restrict__ t_min_in, const float* __restrict__ t_limit_in,
          float* __restrict__ t_out, int* __restrict__ prim_out,
          float* __restrict__ flag_out, int n, int all_definite, int depth_bound,
          int* __restrict__ err) {
  extern __shared__ int2 stack_mem[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float t_min = t_min_in[i];
  const float tiny = 1e-20f;
  // sign / max(|d|, 1e-20), as pallas_wide.py:544-547
  const float inv_x = (dx >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dx), tiny);
  const float inv_y = (dy >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dy), tiny);
  const float inv_z = (dz >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dz), tiny);
  const int oct = (dx < 0.0f ? 4 : 0) + (dy < 0.0f ? 2 : 0) + (dz < 0.0f ? 1 : 0);
  const int row_words = arity * kWordsPerChild;
  const float4* nodes = card_nodes + (size_t)oct * n_wide * row_words;

  float t_best = t_limit_in[i];
  int prim = -1;
  float flag = 0.0f;  // blocked (K2) or pending (K1 with cell masks)

  MaskStack stack(stack_mem, depth_bound);
  bool overflow = false;

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
        if (Occlusion) {
          if (Masks ? !testable : all_definite) flag = 1.0f;
        } else if (Masks) {
          flag = testable ? 1.0f : 0.0f;
        }
      }
      c = (Occlusion && flag != 0.0f) ? kEnd : next();
    }
  }
  if (overflow) {
    atomicOr(err, 1);  // cudalib.ERR_WIDE_STACK
    return;
  }
  t_out[i] = t_best;
  prim_out[i] = prim;
  flag_out[i] = flag;
}

template <bool Occlusion, bool Masks>
int launch_walk(const void* card_nodes, int n_wide, int arity, const void* card_leaves,
                int group, const void* o, const void* d, const void* t_min,
                const void* t_limit, void* t_out, void* prim_out, void* flag_out, int n,
                int all_definite, int depth_bound, void* err, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const size_t smem = (size_t)kThreads * depth_bound * sizeof(int2);
  auto kernel = wide_walk<Occlusion, Masks>;
  if (smem > (size_t)kDefaultSharedBytes) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float4*)card_nodes, n_wide, arity, (const float4*)card_leaves, group,
      (const float*)o, (const float*)d, (const float*)t_min, (const float*)t_limit,
      (float*)t_out, (int*)prim_out, (float*)flag_out, n, all_definite, depth_bound,
      (int*)err);
  return (int)cudaGetLastError();
}

template <bool Occlusion>
int launch(const void* card_nodes, int n_wide, int arity, const void* card_leaves,
           int group, const void* o, const void* d, const void* t_min, const void* t_limit,
           void* t_out, void* prim_out, void* flag_out, int n, int apply_masks,
           int all_definite, int depth_bound, void* err, void* stream) {
  if (n <= 0) return 0;
  auto* fn = apply_masks ? &launch_walk<Occlusion, true> : &launch_walk<Occlusion, false>;
  return fn(card_nodes, n_wide, arity, card_leaves, group, o, d, t_min, t_limit, t_out,
            prim_out, flag_out, n, all_definite, depth_bound, err, stream);
}

}  // namespace

extern "C" {

int tpurt_wide_closest(const void* card_nodes, int n_wide, int arity,
                       const void* card_leaves, int group, const void* o, const void* d,
                       const void* t_min, const void* t_limit, void* t_out,
                       void* prim_out, void* flag_out, int n, int apply_masks,
                       int all_definite, int depth_bound, void* err, void* stream) {
  return launch<false>(card_nodes, n_wide, arity, card_leaves, group, o, d, t_min,
                       t_limit, t_out, prim_out, flag_out, n, apply_masks, all_definite,
                       depth_bound, err, stream);
}

int tpurt_wide_occlusion(const void* card_nodes, int n_wide, int arity,
                         const void* card_leaves, int group, const void* o,
                         const void* d, const void* t_min, const void* t_limit,
                         void* t_out, void* prim_out, void* flag_out, int n,
                         int apply_masks, int all_definite, int depth_bound, void* err,
                         void* stream) {
  return launch<true>(card_nodes, n_wide, arity, card_leaves, group, o, d, t_min,
                      t_limit, t_out, prim_out, flag_out, n, apply_masks, all_definite,
                      depth_bound, err, stream);
}

}  // extern "C"
