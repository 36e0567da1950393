// Multi-walk wide-BVH traversal for Hopper (sm_90a): K5, closest hit and
// occlusion in one templated kernel.
//
// Replaces tpurt/kernels/pallas_wide.py::_octet_packets running
// _octet_kernel, reached through traverse_packets(octet=N) and
// occlusion_packets(octet=N) (KernelPolicy.octet_closest/_occlusion).
// The contract is K1/K2's (wide_traverse.cu) over the same tables, with
// tpurt's multi-walk order: the rays are cut into walks of 1024/N
// consecutive rays (N = 2, 4 or 8, so 512, 256 or 128 rays); a walk
// takes the direction octant of its first ray and traverses the union of
// its rays' hit nodes with one stack, each node visited once for the
// whole walk. Every ray of the walk runs the box tests and the triangle
// tests of every entry the walk pops, against its own t_best.
//
// Design. One thread block per walk, blockDim = 1024/N, thread i owns
// ray i of the walk (rays past n are tpurt's padding: inactive, t_limit
// -3e38). The walk's stack (256 ints, the host checks the exact
// _stack_bound against it) and the current node or leaf row live in
// shared memory. A node step: the block reads the 512-byte node row in
// one coalesced load (one float per thread for the first 128), each
// thread runs the slab tests of the non-empty slots for its ray in
// _octet_kernel's (and K1's) expression order, the 16-bit hit masks are
// OR-ed over the block (__reduce_or_sync per warp, atomicOr into a shared
// word; the card's counterpart of the TPU's roll-OR collapse), and warp 0
// pushes the hit children far-first with one ballot, so slot 0 ends on
// top; a leaf is pushed as -(link+1). A leaf step: the block stages the
// leaf row and each thread runs the G triangle tests for its ray in
// _tri_test's order, with cell masks as K1/K2 apply them. tpurt's dummy
// NaN node row and zero leaf row (which let idle walks run unmasked on
// the TPU) are not needed: a block whose stack is empty stops.
//
// Exit. Every thread reads the loop condition from shared memory after a
// barrier, so all threads of a block leave together: the stack is empty,
// or (occlusion) no ray of the walk is still active and unblocked
// (__syncthreads_or). tpurt's loop runs until every walk of its
// 1024-ray program is done; stopping a walk whose rays are all blocked
// changes only t/prim of rays that are already blocked, which no caller
// reads. As in tpurt, a blocked ray keeps testing until its walk ends.
//
// Bound. The same f32 work per box and triangle test as K1, times the
// union: every ray of a walk tests every entry the walk pops, so the
// walk does more tests than the function needs (PERF.md sets K1's bound
// on the same rays beside K5's). Built with --fmad=false, so t, prim,
// pending and blocked equal the plain version (kernels/wide.py::
// octet_plain) bit for bit. Three barriers per step; a stack overflow
// ORs bit 1 into the card's error word and ends the walk.
//
// Plain C interface for ctypes: each entry point returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kMaxStack = 256;
constexpr int kMaxArity = 16;
constexpr float kBig = 3.0e38f;

template <bool Occlusion>
__global__ void __launch_bounds__(512)
wide_octet(const float* __restrict__ node_rows, int n_wide,
           const float* __restrict__ tri_rows, int row_width,
           const float* __restrict__ o, const float* __restrict__ d,
           const float* __restrict__ t_min_in,
           const float* __restrict__ t_limit_in,
           float* __restrict__ t_out, int* __restrict__ prim_out,
           float* __restrict__ flag_out, int n, int group, int arity,
           int use_masks, int use_opaque, int apply_masks,
           int all_definite, int* __restrict__ err) {
  __shared__ int stack[kMaxStack];
  __shared__ float row[kLane];
  __shared__ int s_sp;
  __shared__ int s_oct;
  __shared__ unsigned s_mask;

  const int rpw = blockDim.x;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * rpw + tid;
  const bool real = i < n;

  // tpurt's padding for rays past n: o = 0, d = 1, t_min = 0, inactive
  const float ox = real ? o[3 * i + 0] : 0.0f;
  const float oy = real ? o[3 * i + 1] : 0.0f;
  const float oz = real ? o[3 * i + 2] : 0.0f;
  const float dx = real ? d[3 * i + 0] : 1.0f;
  const float dy = real ? d[3 * i + 1] : 1.0f;
  const float dz = real ? d[3 * i + 2] : 1.0f;
  const float t_min = real ? t_min_in[i] : 0.0f;
  const float tiny = 1e-20f;
  const float inv_x = (dx >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dx), tiny);
  const float inv_y = (dy >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dy), tiny);
  const float inv_z = (dz >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dz), tiny);

  float t_best = real ? t_limit_in[i] : -kBig;
  int prim = -1;
  float flag = 0.0f;  // blocked (occlusion) or pending (closest, cell masks)

  if (tid == 0) {
    // the walk's octant: its first ray's (always a real ray)
    s_oct = (dx < 0.0f ? 4 : 0) + (dy < 0.0f ? 2 : 0) + (dz < 0.0f ? 1 : 0);
    stack[0] = 0;  // wide root
    s_sp = 1;
  }
  __syncthreads();
  const float* nodes = node_rows + (size_t)s_oct * n_wide * kLane;
  const int link0 = 6 * arity, kind0 = 7 * arity;
  const int id_base = group * (9 + use_masks + use_opaque);

  while (true) {
    const int sp = s_sp;
    if (sp <= 0) break;  // the same value in every thread
    if (Occlusion) {
      if (!__syncthreads_or(flag == 0.0f && t_best > -1e37f)) break;
    }
    const int entry = stack[sp - 1];
    if (entry >= 0) {
      const float* src = nodes + (size_t)entry * kLane;
      for (int k = tid; k < kLane; k += rpw) row[k] = __ldg(src + k);
      if (tid == 0) s_mask = 0u;
      __syncthreads();
      unsigned bits = 0u;
      for (int s = 0; s < arity; ++s) {
        if ((int)row[kind0 + s] <= 0) continue;
        const float* b = row + 6 * s;
        const float t0x = (b[0] - ox) * inv_x;
        const float t0y = (b[1] - oy) * inv_y;
        const float t0z = (b[2] - oz) * inv_z;
        const float t1x = (b[3] - ox) * inv_x;
        const float t1y = (b[4] - oy) * inv_y;
        const float t1z = (b[5] - oz) * inv_z;
        const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                               fmaxf(fminf(t0z, t1z), t_min));
        const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                               fminf(fmaxf(t0z, t1z), t_best));
        if (tn <= tf) bits |= 1u << s;
      }
      bits = __reduce_or_sync(0xffffffffu, bits);
      if ((tid & 31) == 0 && bits) atomicOr(&s_mask, bits);
      __syncthreads();
      if (tid < 32) {
        // warp 0 pushes: lane s holds slot s; slots above s go first
        const unsigned m = s_mask;
        const int s = tid;
        bool push = false;
        int child = 0;
        if (s < arity && ((m >> s) & 1u)) {
          const int kind = (int)row[kind0 + s];
          if (kind > 0) {
            const int link = (int)row[link0 + s];
            child = kind == 2 ? -(link + 1) : link;
            push = true;
          }
        }
        const unsigned pm = __ballot_sync(0xffffffffu, push);
        const int base = sp - 1;
        const int top = base + __popc(pm);
        if (push) {
          const int pos = base + __popc(pm >> (s + 1));
          if (pos < kMaxStack) stack[pos] = child;
        }
        if (tid == 0) {
          if (top > kMaxStack) {
            atomicOr(err, 1);  // cudalib.ERR_WIDE_STACK; the walk ends
            s_sp = 0;
          } else {
            s_sp = top;
          }
        }
      }
      __syncthreads();
    } else {
      const float* src = tri_rows + (size_t)(-entry - 1) * row_width;
      for (int k = tid; k < row_width; k += rpw) row[k] = __ldg(src + k);
      __syncthreads();
      for (int k = 0; k < group; ++k) {
        const float* v = row + 9 * k;
        const float v0x = v[0], v0y = v[1], v0z = v[2];
        const float e1x = v[3] - v0x, e1y = v[4] - v0y, e1z = v[5] - v0z;
        const float e2x = v[6] - v0x, e2y = v[7] - v0y, e2z = v[8] - v0z;
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
        if (apply_masks) {
          const int m = (int)row[group * 9 + k];
          const int cu = min(max((int)(u * 4.0f), 0), 3);
          const int cv = min(max((int)(vv * 4.0f), 0), 3);
          const int cell = cu * 4 + cv;
          if ((m >> cell) & 1) continue;  // decided-transparent cell
          testable = ((m >> 16) & 1) == 1;
          if (use_opaque) {
            const int om = (int)row[group * 10 + k];
            testable = testable && (((om >> cell) & 1) == 0);
          }
        }
        t_best = t;
        prim = (int)row[id_base + k];
        if (Occlusion) {
          if (use_masks ? !testable : all_definite) flag = 1.0f;
        } else if (apply_masks) {
          flag = testable ? 1.0f : 0.0f;
        }
      }
      if (tid == 0) s_sp = sp - 1;
      __syncthreads();
    }
  }
  if (real) {
    t_out[i] = t_best;
    prim_out[i] = prim;
    flag_out[i] = flag;
  }
}

template <bool Occlusion>
int launch(const void* node_rows, int n_wide, const void* tri_rows,
           int row_width, const void* o, const void* d, const void* t_min,
           const void* t_limit, void* t_out, void* prim_out, void* flag_out,
           int n, int group, int arity, int use_masks, int use_opaque,
           int apply_masks, int all_definite, int walks, void* err,
           void* stream) {
  if (n <= 0) return 0;
  if (walks != 2 && walks != 4 && walks != 8) return (int)cudaErrorInvalidValue;
  if (arity > kMaxArity || row_width > kLane) return (int)cudaErrorInvalidValue;
  const int rpw = 1024 / walks;
  const int blocks = (n + rpw - 1) / rpw;
  wide_octet<Occlusion><<<blocks, rpw, 0, (cudaStream_t)stream>>>(
      (const float*)node_rows, n_wide, (const float*)tri_rows, row_width,
      (const float*)o, (const float*)d, (const float*)t_min,
      (const float*)t_limit, (float*)t_out, (int*)prim_out, (float*)flag_out,
      n, group, arity, use_masks, use_opaque, apply_masks, all_definite,
      (int*)err);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tpurt_octet_closest(const void* node_rows, int n_wide, const void* tri_rows,
                        int row_width, const void* o, const void* d,
                        const void* t_min, const void* t_limit, void* t_out,
                        void* prim_out, void* flag_out, int n, int group,
                        int arity, int use_masks, int use_opaque,
                        int apply_masks, int all_definite, int walks,
                        void* err, void* stream) {
  return launch<false>(node_rows, n_wide, tri_rows, row_width, o, d, t_min,
                       t_limit, t_out, prim_out, flag_out, n, group, arity,
                       use_masks, use_opaque, apply_masks, all_definite,
                       walks, err, stream);
}

int tpurt_octet_occlusion(const void* node_rows, int n_wide,
                          const void* tri_rows, int row_width, const void* o,
                          const void* d, const void* t_min,
                          const void* t_limit, void* t_out, void* prim_out,
                          void* flag_out, int n, int group, int arity,
                          int use_masks, int use_opaque, int apply_masks,
                          int all_definite, int walks, void* err,
                          void* stream) {
  return launch<true>(node_rows, n_wide, tri_rows, row_width, o, d, t_min,
                      t_limit, t_out, prim_out, flag_out, n, group, arity,
                      use_masks, use_opaque, apply_masks, all_definite, walks,
                      err, stream);
}

}  // extern "C"
