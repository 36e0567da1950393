// Multi-walk wide-BVH traversal for Hopper (sm_90a): K5, closest hit and
// occlusion in one templated kernel.
//
// Replaces tpurt/kernels/pallas_wide.py:1434 _octet_packets running
// _octet_kernel, reached through traverse_packets(octet=N) and
// occlusion_packets(octet=N) (KernelPolicy.octet_closest/_occlusion).
// The contract is kernels/wide.py::octet_plain's, bit for bit: the rays
// are cut into walks of 1024/N consecutive rays (N = 2, 4 or 8, so 512,
// 256 or 128 rays), the last one padded with inactive rays (o = 0, d = 1,
// t_min = 0, t_limit -3e38); a walk takes the direction octant of its
// first ray and walks the union of its rays' hits: on a node, every ray
// of the walk tests every non-empty slot against its own t_best and the
// union of the hit masks decides what is visited next, nearest slot
// first; on a leaf, every ray runs the G triangle tests, with the cell
// masks where they apply. In occlusion mode the walk stops before any
// step at which none of its rays is active and unblocked. That exit is
// part of the contract: the t/prim of a blocked ray depend on it.
//
// It reads the card tables of kernels/wide.py::card_tables, as K1/K2 do
// (wide_traverse.cu): child s of a node row is [lo.xyz link][hi.xyz kind],
// triangle k of a leaf [v0.xyz id][e1.xyz alpha][e2.xyz opaque] with the
// edges precomputed in the same f32 bits as the plain version's
// subtraction. Built with --fmad=false and in the plain version's
// expression order, so t, prim and the flag are bit-equal to it.
//
// Design, against what held the first version back (tpurt's float rows
// staged whole into shared memory with scalar loads, three barriers per
// node step and two per leaf step, warp 0 alone pushing one entry per hit
// child onto a 256-int stack, edges recomputed by every thread):
//  1. No staging. Every thread of a walk reads the same node or triangle
//     words, straight from the card tables with 16-byte __ldg loads: a
//     warp-wide broadcast served from L1, with no copy and no barrier. A
//     node's slots are loaded four at a time and the walk stops after the
//     first group that ends in an empty slot (empty slots trail).
//  2. A hit-mask stack per walk, replicated per warp. A node visit pushes
//     one entry (row, union hit mask | leaf mask << 16) and a pop takes
//     the lowest set bit, the nearest hit child: the plain version's
//     far-first push of each hit child, as K1 walks it. The stack holds
//     one entry per internal level at most (the walk follows one path
//     from the root, whatever its rays hit), so `depth_bound` entries; an
//     entry past it ORs cudalib's wide-stack bit into the error word and
//     ends the walk. Every warp keeps its own copy in shared memory (the
//     top entry in registers) and updates it from the same union mask, so
//     no warp waits for another to push.
//  3. One exchange per step that needs one. A node step: each warp ORs
//     its lanes' hit masks (__reduce_or_sync), writes the result into its
//     slot of a small shared array, double-buffered by the exchange's
//     parity, takes one __syncthreads and ORs every warp's slot. A leaf
//     step in closest mode needs nothing from other warps and takes no
//     barrier. In occlusion mode, whether some ray is still active and
//     unblocked changes only on a leaf step, so one exchange before the
//     first step and one after each leaf step decide every exit, with the
//     same exchange. Every warp takes the same sequence of barriers: all
//     warps of a walk hold equal stacks, updated from the same exchanged
//     masks, read the same node and leaf words and see the same exchanged
//     "pending" bit, so they take the same branch at every step, and
//     padded rays run the loop like any other (no thread leaves early).
//     Double buffering makes one barrier per exchange enough: a warp that
//     writes exchange k+1's slot has passed exchange k's barrier, and one
//     that writes exchange k+2's (the same buffer as k) has passed k+1's,
//     which every warp reaches only after it has read exchange k.
//  4. Launch. One block of 1024/N threads per walk, one ray per thread
//     (LaneRays = 1); or, at 8 walks, one warp per walk with 4 rays per
//     lane (LaneRays = 4, four walks to a 128-thread block), whose OR is
//     one __reduce_or_sync, which takes no barrier and reuses every
//     loaded word for four rays, but holds 127 registers a thread (16
//     warps an SM) and a quarter of the warps. The host picks it from the
//     launch's size (kernels/wide.py::OCTET_WARP_WALKS): on the bench
//     scene one block per walk was faster up to 3,840 walks and one warp
//     per walk from 7,680 walks to whole frames (PERF.md).
//
// Bound. The same f32 work per box and triangle test as K1, times the
// union: every ray of a walk tests every entry the walk pops, so the walk
// does more tests than the function needs (the smoke and kernel_bench set
// the function's bound, K1/K2's on the same rays, beside the union walk's
// own).
//
// Plain C interface for ctypes: each entry point returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kEnd = INT_MIN;       // the walk is over
constexpr int kWordsPerChild = 2;   // float4 words per child slot
constexpr int kWordsPerTri = 3;     // float4 words per triangle
constexpr int kSlotGroup = 4;       // child slots loaded together
constexpr int kMaxWarps = 16;       // a 512-ray walk
constexpr int kWarpBlock = 128;     // threads per block of the warp-per-walk launch
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

// A walk's hit-mask stack as one warp holds it: entries (row, hit | leaf
// << 16), each with a bit left; the top one in registers (the same in
// every lane), the ones below it in this warp's column of shared memory,
// written by lane 0.
struct WarpStack {
  int2* base;
  int cap;
  int sp;  // entries, the top one included
  int top_row;
  unsigned top_bits;

  __device__ __forceinline__ WarpStack(int2* column, int cap_)
      : base(column), cap(cap_), sp(0), top_row(0), top_bits(0u) {}

  // false when the entry does not fit under the bound
  __device__ __forceinline__ bool push(int row, unsigned bits) {
    if (sp >= cap) return false;
    if (sp > 0) {
      __syncwarp();  // every lane has read the slot before lane 0 writes it
      if ((threadIdx.x & 31) == 0) base[sp - 1] = make_int2(top_row, (int)top_bits);
      __syncwarp();
    }
    top_row = row;
    top_bits = bits;
    ++sp;
    return true;
  }

  // the nearest hit child left: its node row, slot and whether it is a
  // leaf; false when the stack is empty
  __device__ __forceinline__ bool pop(int& row, int& slot, bool& leaf) {
    if (sp == 0) return false;
    row = top_row;
    slot = __ffs(top_bits) - 1;
    leaf = (top_bits >> (16 + slot)) & 1u;
    top_bits &= ~(0x10001u << slot);
    if (top_bits == 0u && --sp > 0) {
      const int2 e = base[sp - 1];
      top_row = e.x;
      top_bits = (unsigned)e.y;
    }
    return true;
  }
};

// The OR of `bits` over the walk's rays. LaneRays = 1: one walk per
// block, every warp must call it at the same point (see the header).
template <int LaneRays>
__device__ __forceinline__ unsigned walk_or(unsigned bits, unsigned (*slots)[kMaxWarps],
                                            int& parity) {
  bits = __reduce_or_sync(kFull, bits);
  if (LaneRays == 1) {
    const int warps = blockDim.x >> 5;
    if ((threadIdx.x & 31) == 0) slots[parity][threadIdx.x >> 5] = bits;
    __syncthreads();
    bits = 0u;
    for (int w = 0; w < warps; ++w) bits |= slots[parity][w];
    parity ^= 1;
  }
  return bits;
}

template <bool Occlusion, bool Masks, int LaneRays>
__global__ void __launch_bounds__(LaneRays == 1 ? 512 : kWarpBlock)
octet_walk(const float4* __restrict__ card_nodes, int n_wide, int arity,
           const float4* __restrict__ card_leaves, int group,
           const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t_min_in, const float* __restrict__ t_limit_in,
           float* __restrict__ t_out, int* __restrict__ prim_out,
           float* __restrict__ flag_out, int n, int rays_per_walk, int n_walks,
           int all_definite, int depth_bound, int* __restrict__ err) {
  extern __shared__ int2 stack_mem[];  // [warp][depth_bound]
  __shared__ unsigned or_slots[2][kMaxWarps];
  constexpr int R = LaneRays;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int walk = LaneRays == 1 ? blockIdx.x : blockIdx.x * (kWarpBlock / 32) + warp;
  if (LaneRays != 1 && walk >= n_walks) return;  // the whole warp: no barrier follows
  const int first = walk * rays_per_walk;

  // this thread's rays: ray r of a lane is the walk's ray
  // (LaneRays == 1 ? threadIdx.x : lane + 32 * r); rays past n are padding
  float ox[R], oy[R], oz[R], dx[R], dy[R], dz[R], inv_x[R], inv_y[R], inv_z[R];
  float t_min[R], t_best[R], flag[R];
  int prim[R];
  bool real[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = first + (LaneRays == 1 ? (int)threadIdx.x : lane + 32 * r);
    real[r] = i < n;
    ox[r] = real[r] ? o[3 * i + 0] : 0.0f;
    oy[r] = real[r] ? o[3 * i + 1] : 0.0f;
    oz[r] = real[r] ? o[3 * i + 2] : 0.0f;
    dx[r] = real[r] ? d[3 * i + 0] : 1.0f;
    dy[r] = real[r] ? d[3 * i + 1] : 1.0f;
    dz[r] = real[r] ? d[3 * i + 2] : 1.0f;
    t_min[r] = real[r] ? t_min_in[i] : 0.0f;
    t_best[r] = real[r] ? t_limit_in[i] : -kBig;
    const float tiny = 1e-20f;
    // sign / max(|d|, 1e-20), as pallas_wide.py:544-547
    inv_x[r] = (dx[r] >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dx[r]), tiny);
    inv_y[r] = (dy[r] >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dy[r]), tiny);
    inv_z[r] = (dz[r] >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dz[r]), tiny);
    prim[r] = -1;
    flag[r] = 0.0f;  // blocked (occlusion) or pending (closest, cell masks)
  }

  // the walk's octant: its first ray's (always a real ray)
  const float* d0 = d + 3 * (size_t)first;
  const int oct = (d0[0] < 0.0f ? 4 : 0) + (d0[1] < 0.0f ? 2 : 0) + (d0[2] < 0.0f ? 1 : 0);
  const int row_words = arity * kWordsPerChild;
  const float4* nodes = card_nodes + (size_t)oct * n_wide * row_words;

  WarpStack stack(stack_mem + warp * depth_bound, depth_bound);
  int parity = 0;
  bool overflow = false;

  // whether some ray of this thread is active and unblocked
  auto pending = [&]() -> unsigned {
    bool any = false;
#pragma unroll
    for (int r = 0; r < R; ++r) any |= flag[r] == 0.0f && t_best[r] > -1e37f;
    return any ? 1u : 0u;
  };
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
  if (Occlusion && !walk_or<R>(pending(), or_slots, parity)) c = kEnd;
  while (c != kEnd) {
    if (c >= 0) {
      // ---- node step: every ray tests every non-empty slot ----
      const float4* row = nodes + (size_t)c * row_words;
      unsigned hit = 0u, leaf_kind = 0u;
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
          if (kind == 2) leaf_kind |= 1u << (s0 + j);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float t0x = (lo[j].x - ox[r]) * inv_x[r];
            const float t0y = (lo[j].y - oy[r]) * inv_y[r];
            const float t0z = (lo[j].z - oz[r]) * inv_z[r];
            const float t1x = (hi[j].x - ox[r]) * inv_x[r];
            const float t1y = (hi[j].y - oy[r]) * inv_y[r];
            const float t1z = (hi[j].z - oz[r]) * inv_z[r];
            const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                                   fmaxf(fminf(t0z, t1z), t_min[r]));
            const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                                   fminf(fmaxf(t0z, t1z), t_best[r]));
            if (tn <= tf) hit |= 1u << (s0 + j);
          }
        }
        // empty slots trail: a group that ends in one is the last
        if (__float_as_int(hi[kSlotGroup - 1].w) == 0) break;
      }
      hit = walk_or<R>(hit, or_slots, parity);
      if (hit != 0u && !stack.push(c, hit | ((hit & leaf_kind) << 16))) {
        overflow = true;
        break;
      }
      c = next();
    } else {
      // ---- leaf step: every ray runs the G triangle tests ----
      const float4* tri = card_leaves + (size_t)(-c - 1) * group * kWordsPerTri;
      for (int k = 0; k < group; ++k) {
        const float4 w0 = __ldg(tri + kWordsPerTri * k);
        const float4 w1 = __ldg(tri + kWordsPerTri * k + 1);
        const float4 w2 = __ldg(tri + kWordsPerTri * k + 2);
        const float v0x = w0.x, v0y = w0.y, v0z = w0.z;
        const float e1x = w1.x, e1y = w1.y, e1z = w1.z;
        const float e2x = w2.x, e2y = w2.y, e2z = w2.z;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float px = dy[r] * e2z - dz[r] * e2y;
          const float py = dz[r] * e2x - dx[r] * e2z;
          const float pz = dx[r] * e2y - dy[r] * e2x;
          const float det = e1x * px + e1y * py + e1z * pz;
          const bool ok = fabsf(det) > 1e-12f;
          const float inv_det = ok ? 1.0f / det : 0.0f;
          const float tx = ox[r] - v0x, ty = oy[r] - v0y, tz = oz[r] - v0z;
          const float u = (tx * px + ty * py + tz * pz) * inv_det;
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float vv = (dx[r] * qx + dy[r] * qy + dz[r] * qz) * inv_det;
          const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          const bool hit = ok && u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f &&
                           t > t_min[r] && t < t_best[r];
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
          t_best[r] = t;
          prim[r] = __float_as_int(w0.w);
          if (Occlusion) {
            if (Masks ? !testable : all_definite) flag[r] = 1.0f;
          } else if (Masks) {
            flag[r] = testable ? 1.0f : 0.0f;
          }
        }
      }
      c = (Occlusion && !walk_or<R>(pending(), or_slots, parity)) ? kEnd : next();
    }
  }
  if (overflow) {
    if (lane == 0 && (LaneRays != 1 || warp == 0)) atomicOr(err, 1);  // cudalib.ERR_WIDE_STACK
    return;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (!real[r]) continue;
    const int i = first + (LaneRays == 1 ? (int)threadIdx.x : lane + 32 * r);
    t_out[i] = t_best[r];
    prim_out[i] = prim[r];
    flag_out[i] = flag[r];
  }
}

template <bool Occlusion, bool Masks, int LaneRays>
int launch_walk(const void* card_nodes, int n_wide, int arity, const void* card_leaves,
                int group, const void* o, const void* d, const void* t_min,
                const void* t_limit, void* t_out, void* prim_out, void* flag_out, int n,
                int rays_per_walk, int all_definite, int depth_bound, void* err,
                void* stream) {
  const int n_walks = (n + rays_per_walk - 1) / rays_per_walk;
  const int threads = LaneRays == 1 ? rays_per_walk : kWarpBlock;
  const int walks_per_block = LaneRays == 1 ? 1 : kWarpBlock / 32;
  const int blocks = (n_walks + walks_per_block - 1) / walks_per_block;
  const size_t smem = (size_t)(threads / 32) * depth_bound * sizeof(int2);
  octet_walk<Occlusion, Masks, LaneRays><<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const float4*)card_nodes, n_wide, arity, (const float4*)card_leaves, group,
      (const float*)o, (const float*)d, (const float*)t_min, (const float*)t_limit,
      (float*)t_out, (int*)prim_out, (float*)flag_out, n, rays_per_walk, n_walks,
      all_definite, depth_bound, (int*)err);
  return (int)cudaGetLastError();
}

template <bool Occlusion>
int launch(const void* card_nodes, int n_wide, int arity, const void* card_leaves,
           int group, const void* o, const void* d, const void* t_min, const void* t_limit,
           void* t_out, void* prim_out, void* flag_out, int n, int apply_masks,
           int all_definite, int walks, int depth_bound, int warp_per_walk, void* err,
           void* stream) {
  if (n <= 0) return 0;
  if (walks != 2 && walks != 4 && walks != 8) return (int)cudaErrorInvalidValue;
  if (arity < 1 || arity > 16 || depth_bound < 1) return (int)cudaErrorInvalidValue;
  // one warp per walk holds 4 rays per lane: 128-ray walks only
  if (warp_per_walk && walks != 8) return (int)cudaErrorInvalidValue;
  const int rays_per_walk = 1024 / walks;
  auto* fn = warp_per_walk ? (apply_masks ? &launch_walk<Occlusion, true, 4>
                                          : &launch_walk<Occlusion, false, 4>)
                           : (apply_masks ? &launch_walk<Occlusion, true, 1>
                                          : &launch_walk<Occlusion, false, 1>);
  return fn(card_nodes, n_wide, arity, card_leaves, group, o, d, t_min, t_limit, t_out,
            prim_out, flag_out, n, rays_per_walk, all_definite, depth_bound, err, stream);
}

}  // namespace

extern "C" {

int tpurt_octet_closest(const void* card_nodes, int n_wide, int arity,
                        const void* card_leaves, int group, const void* o, const void* d,
                        const void* t_min, const void* t_limit, void* t_out,
                        void* prim_out, void* flag_out, int n, int apply_masks,
                        int all_definite, int walks, int depth_bound, int warp_per_walk,
                        void* err, void* stream) {
  return launch<false>(card_nodes, n_wide, arity, card_leaves, group, o, d, t_min,
                       t_limit, t_out, prim_out, flag_out, n, apply_masks, all_definite,
                       walks, depth_bound, warp_per_walk, err, stream);
}

int tpurt_octet_occlusion(const void* card_nodes, int n_wide, int arity,
                          const void* card_leaves, int group, const void* o,
                          const void* d, const void* t_min, const void* t_limit,
                          void* t_out, void* prim_out, void* flag_out, int n,
                          int apply_masks, int all_definite, int walks, int depth_bound,
                          int warp_per_walk, void* err, void* stream) {
  return launch<true>(card_nodes, n_wide, arity, card_leaves, group, o, d, t_min,
                      t_limit, t_out, prim_out, flag_out, n, apply_masks, all_definite,
                      walks, depth_bound, warp_per_walk, err, stream);
}

}  // extern "C"
