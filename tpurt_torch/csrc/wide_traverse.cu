// Wide-BVH ray traversal for Hopper (sm_90a): closest hit (K1) and
// occlusion (K2) in one templated kernel.
//
// Replaces tpurt/kernels/pallas_wide.py::_wide_packets running
// _wide_kernel with occlusion=False (K1, reached through
// traverse_packets) and occlusion=True (K2, reached through
// occlusion_packets). The tables are the ones tpurt packs: per octant,
// (W, 128) f32 node rows of 16 child boxes sorted near to far, 16 links
// and 16 kinds; (L, R) f32 leaf rows of G triangles x 9 floats, the
// optional transparent/opaque 4x4 cell masks, and G global triangle ids.
//
// Design. One thread per ray, 128 threads per block. Each ray walks its
// own stack in local memory (int[256]; the host's exact _stack_bound
// result is checked against it before launch, and an overflow ORs bit 1
// into *err, the card's error word, instead of writing past the array).
// The ray reads the node rows of its own direction octant through the
// read-only cache (__ldg). The
// TPU walked one octant per 1024-ray packet over the packet's union of
// nodes because its step was a serial scalar chain; a GPU thread needs
// no such sharing, and the closest hit is the same (only exact-t ties
// may pick the other triangle). The slab test and the leaf test repeat
// pallas_wide.py's expression order (_wide_kernel's node_tests and
// _tri_test), and the library is compiled with --fmad=false, so t equals
// the plain PyTorch traversal (kernels/wide.py::traverse_plain) bit for
// bit. That flag costs the fused multiply-adds; revisit it when the
// kernel is tuned.
//
// Bound. A traversal step is ~25 float operations per child box (400
// per node row) and ~60 per triangle (480 per leaf row at G=8), so at
// the bench's shapes the work is compute-bound against the 67 TFLOP/s
// f32 rate: the bytes are the rays (44 B each) plus the node and leaf
// rows actually read, a few tens of MB. This first version is simple
// and right; the per-thread divergence of an incoherent walk, not the
// arithmetic, is what it pays for (PERF.md records its time beside the
// bound computed from the plain version's visit counts).
//
// Plain C interface for ctypes: pointers and the stream come in as
// void*, each entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLane = 128;
constexpr int kMaxStack = 256;
constexpr int kThreads = 128;

template <bool Occlusion>
__global__ void __launch_bounds__(kThreads)
wide_traverse(const float* __restrict__ node_rows, int n_wide,
              const float* __restrict__ tri_rows, int row_width,
              const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ t_min_in,
              const float* __restrict__ t_limit_in,
              float* __restrict__ t_out, int* __restrict__ prim_out,
              float* __restrict__ flag_out, int n, int group, int arity,
              int use_masks, int use_opaque, int apply_masks,
              int all_definite, int* __restrict__ err) {
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
  const float* nodes = node_rows + (size_t)oct * n_wide * kLane;

  float t_best = t_limit_in[i];
  int prim = -1;
  float flag = 0.0f;  // blocked (K2) or pending (K1 with cell masks)

  const int link0 = 6 * arity, kind0 = 7 * arity;
  const int id_base = group * (9 + use_masks + use_opaque);

  int stack[kMaxStack];
  int sp = 0;
  stack[sp++] = 0;  // wide root

  while (sp > 0) {
    if (Occlusion && flag != 0.0f) break;
    const int entry = stack[--sp];
    if (entry >= 0) {
      const float* row = nodes + (size_t)entry * kLane;
      // push hit children far-first so the nearest pops next
      for (int s = arity - 1; s >= 0; --s) {
        const int kind = (int)__ldg(row + kind0 + s);
        if (kind <= 0) continue;
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
        if (tn <= tf) {
          if (sp >= kMaxStack) {
            atomicOr(err, 1);  // cudalib.ERR_WIDE_STACK
            return;
          }
          const int link = (int)__ldg(row + link0 + s);
          stack[sp++] = kind == 2 ? -(link + 1) : link;
        }
      }
    } else {
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
        bool hit = ok && u >= 0.0f && vv >= 0.0f && u + vv <= 1.0f &&
                   t > t_min && t < t_best;
        if (!hit) continue;
        bool testable = false;
        if (apply_masks) {
          const int m = (int)__ldg(row + group * 9 + k);
          const int cu = min(max((int)(u * 4.0f), 0), 3);
          const int cv = min(max((int)(vv * 4.0f), 0), 3);
          const int cell = cu * 4 + cv;
          if ((m >> cell) & 1) continue;  // decided-transparent cell
          testable = ((m >> 16) & 1) == 1;
          if (use_opaque) {
            const int om = (int)__ldg(row + group * 10 + k);
            testable = testable && (((om >> cell) & 1) == 0);
          }
        }
        t_best = t;
        prim = (int)__ldg(row + id_base + k);
        if (Occlusion) {
          if (use_masks ? !testable : all_definite) flag = 1.0f;
        } else if (apply_masks) {
          flag = testable ? 1.0f : 0.0f;
        }
      }
    }
  }
  t_out[i] = t_best;
  prim_out[i] = prim;
  flag_out[i] = flag;
}

template <bool Occlusion>
int launch(const void* node_rows, int n_wide, const void* tri_rows,
           int row_width, const void* o, const void* d, const void* t_min,
           const void* t_limit, void* t_out, void* prim_out, void* flag_out,
           int n, int group, int arity, int use_masks, int use_opaque,
           int apply_masks, int all_definite, void* err, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  wide_traverse<Occlusion><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)node_rows, n_wide, (const float*)tri_rows, row_width,
      (const float*)o, (const float*)d, (const float*)t_min,
      (const float*)t_limit, (float*)t_out, (int*)prim_out, (float*)flag_out,
      n, group, arity, use_masks, use_opaque, apply_masks, all_definite,
      (int*)err);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tpurt_wide_closest(const void* node_rows, int n_wide, const void* tri_rows,
                       int row_width, const void* o, const void* d,
                       const void* t_min, const void* t_limit, void* t_out,
                       void* prim_out, void* flag_out, int n, int group,
                       int arity, int use_masks, int use_opaque,
                       int apply_masks, int all_definite, void* err,
                       void* stream) {
  return launch<false>(node_rows, n_wide, tri_rows, row_width, o, d, t_min,
                       t_limit, t_out, prim_out, flag_out, n, group, arity,
                       use_masks, use_opaque, apply_masks, all_definite, err,
                       stream);
}

int tpurt_wide_occlusion(const void* node_rows, int n_wide,
                         const void* tri_rows, int row_width, const void* o,
                         const void* d, const void* t_min, const void* t_limit,
                         void* t_out, void* prim_out, void* flag_out, int n,
                         int group, int arity, int use_masks, int use_opaque,
                         int apply_masks, int all_definite, void* err,
                         void* stream) {
  return launch<true>(node_rows, n_wide, tri_rows, row_width, o, d, t_min,
                      t_limit, t_out, prim_out, flag_out, n, group, arity,
                      use_masks, use_opaque, apply_masks, all_definite, err,
                      stream);
}

}  // extern "C"
