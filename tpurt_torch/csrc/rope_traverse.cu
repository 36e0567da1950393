// Binary rope-BVH ray traversal for Hopper (sm_90a): closest hit (K3) and
// occlusion (K4) in one templated kernel.
//
// Replaces tpurt/kernels/experimental/pallas_traverse.py::_traverse_packets
// (_traverse_kernel, K3, reached through traverse_packets) and
// ::_occlusion_packets (_occlusion_kernel, K4, reached through
// occlusion_packets). The tables are the ones tpurt packs: per direction
// octant, (M, 8) f32 node rows [min3, max3, hit link, miss link] over the
// 2L-1 nodes of the binary tree (internal nodes first), the links being
// the per-octant `first` and `skip` ropes; (L, G*9 [+G]) f32 leaf rows of
// G triangles and, optionally, G alpha masks (bits 0-15 transparent 4x4
// cells, bit 16 alpha-testable).
//
// Design. One thread per ray, 128 threads per block, and no stack: the
// ray's state is one node id. At node n the slab test decides between
// first[oct][n] (an internal node whose box is hit) and skip[oct][n]
// (anything else); a leaf whose box is hit tests its G triangles in row
// order with a strict t < t_best, so the first copy of the padded last
// triangle wins. The walk ends at the END sentinel M. The TPU walked one
// octant per 1024-ray packet and descended when any ray hit, because its
// step was a serial scalar chain shared by the packet; each thread here
// walks its own octant's ropes, which leaves every ray's closest hit the
// same (only exact-t ties may pick the other triangle). Occlusion retires
// a ray after the leaf in which it met a definite blocker (mask bit 16
// clear, or any hit with all_definite and no masks), as tpurt's packet
// freezes a blocked ray's lanes. A correct rope visits each node at most
// once, so a walk is capped at 4*M steps; a walk that reaches the cap ORs
// bit 2 into *err (the card's error word, read once per sample by
// cudalib.check_kernel_errors) and stops, instead of looping on a broken
// link. The slab test and the triangle test repeat pallas_traverse.py's
// expression order (and kernels/intersect.py::ray_triangle_rows), and the
// library is compiled with --fmad=false, so t, u and v equal the plain
// PyTorch walk (kernels/experimental/rope.py::traverse_plain) bit for bit.
//
// Bound. A step is one box test (~25 float operations) and, at a leaf
// whose box is hit, G triangle tests (~60 each), so the work is
// compute-bound against the 67 TFLOP/s f32 rate: the bytes are the rays
// (48 B each in, 20 B out) plus each node row (32 B) and leaf row read.
// The binary walk takes several times the steps of the 16-ary wide walk
// (K1/K2), each one a dependent load; this first version is simple and
// right, and PERF.md records its time beside the bound computed from the
// plain walk's step counts.
//
// Plain C interface for ctypes: pointers and the stream come in as void*,
// each entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRow = 8;          // floats per node row
constexpr int kErrStepCap = 2;   // cudalib.ERR_ROPE_STEPS

template <bool Occlusion>
__global__ void __launch_bounds__(kThreads)
rope_traverse(const float* __restrict__ node_rows, int m, int n_internal,
              const float* __restrict__ tri_rows, int row_width, int group,
              int use_masks, int all_definite, const float* __restrict__ o,
              const float* __restrict__ d, const float* __restrict__ t_min_in,
              const float* __restrict__ t_limit_in,
              const uint8_t* __restrict__ active, float* __restrict__ t_out,
              int* __restrict__ prim_out, float* __restrict__ u_out,
              float* __restrict__ v_out, float* __restrict__ blocked_out,
              int n, int* __restrict__ err) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float ox = o[3 * i + 0], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = d[3 * i + 0], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const float t_min = t_min_in[i];
  const float tiny = 1e-20f;
  // sign / max(|d|, 1e-20), as pallas_traverse.py:121-123
  const float inv_x = (dx >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dx), tiny);
  const float inv_y = (dy >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dy), tiny);
  const float inv_z = (dz >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dz), tiny);
  const int oct = (dx < 0.0f ? 4 : 0) + (dy < 0.0f ? 2 : 0) + (dz < 0.0f ? 1 : 0);
  const float* nodes = node_rows + (size_t)oct * m * kRow;

  float t_best = t_limit_in[i];
  int prim = -1;
  float uu = 0.0f, vv = 0.0f;
  bool blocked = false;

  const int end = m;
  int node = active[i] ? 0 : end;
  const long long cap = 4LL * m;
  long long steps = 0;
  while (node != end) {
    if (steps++ >= cap) {
      atomicOr(err, kErrStepCap);
      break;
    }
    const float* row = nodes + (size_t)node * kRow;
    const float t0x = (__ldg(row + 0) - ox) * inv_x;
    const float t1x = (__ldg(row + 3) - ox) * inv_x;
    const float t0y = (__ldg(row + 1) - oy) * inv_y;
    const float t1y = (__ldg(row + 4) - oy) * inv_y;
    const float t0z = (__ldg(row + 2) - oz) * inv_z;
    const float t1z = (__ldg(row + 5) - oz) * inv_z;
    const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fmaxf(fminf(t0z, t1z), t_min));
    const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                           fminf(fmaxf(t0z, t1z), t_best));
    const bool box_hit = tn <= tf;
    if (node < n_internal) {
      node = (int)__ldg(row + (box_hit ? 6 : 7));
      continue;
    }
    if (box_hit) {
      const int leaf = node - n_internal;
      const float* lrow = tri_rows + (size_t)leaf * row_width;
      for (int k = 0; k < group; ++k) {
        const float* v = lrow + 9 * k;
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
        const float w = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        if (!(ok && u >= 0.0f && w >= 0.0f && u + w <= 1.0f && t > t_min &&
              t < t_best))
          continue;
        if (use_masks) {
          const int mask = (int)__ldg(lrow + group * 9 + k);
          const int cu = min(max((int)(u * 4.0f), 0), 3);
          const int cv = min(max((int)(w * 4.0f), 0), 3);
          if ((mask >> (cu * 4 + cv)) & 1) continue;  // transparent cell
          if (Occlusion && ((mask >> 16) & 1) == 0) blocked = true;
        } else if (Occlusion && all_definite) {
          blocked = true;
        }
        t_best = t;
        prim = leaf * group + k;
        uu = u;
        vv = w;
      }
    }
    node = (int)__ldg(row + 7);
    if (Occlusion && blocked) break;
  }
  t_out[i] = t_best;
  prim_out[i] = prim;
  u_out[i] = uu;
  v_out[i] = vv;
  blocked_out[i] = blocked ? 1.0f : 0.0f;
}

template <bool Occlusion>
int launch(const void* node_rows, int m, int n_internal, const void* tri_rows,
           int row_width, int group, int use_masks, int all_definite,
           const void* o, const void* d, const void* t_min,
           const void* t_limit, const void* active, void* t_out,
           void* prim_out, void* u_out, void* v_out, void* blocked_out, int n,
           void* err, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  rope_traverse<Occlusion><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)node_rows, m, n_internal, (const float*)tri_rows,
      row_width, group, use_masks, all_definite, (const float*)o,
      (const float*)d, (const float*)t_min, (const float*)t_limit,
      (const uint8_t*)active, (float*)t_out, (int*)prim_out, (float*)u_out,
      (float*)v_out, (float*)blocked_out, n, (int*)err);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tpurt_rope_closest(const void* node_rows, int m, int n_internal,
                       const void* tri_rows, int row_width, int group,
                       int use_masks, int all_definite, const void* o,
                       const void* d, const void* t_min, const void* t_limit,
                       const void* active, void* t_out, void* prim_out,
                       void* u_out, void* v_out, void* blocked_out, int n,
                       void* err, void* stream) {
  return launch<false>(node_rows, m, n_internal, tri_rows, row_width, group,
                       use_masks, all_definite, o, d, t_min, t_limit, active,
                       t_out, prim_out, u_out, v_out, blocked_out, n, err,
                       stream);
}

int tpurt_rope_occlusion(const void* node_rows, int m, int n_internal,
                         const void* tri_rows, int row_width, int group,
                         int use_masks, int all_definite, const void* o,
                         const void* d, const void* t_min, const void* t_limit,
                         const void* active, void* t_out, void* prim_out,
                         void* u_out, void* v_out, void* blocked_out, int n,
                         void* err, void* stream) {
  return launch<true>(node_rows, m, n_internal, tri_rows, row_width, group,
                      use_masks, all_definite, o, d, t_min, t_limit, active,
                      t_out, prim_out, u_out, v_out, blocked_out, n, err,
                      stream);
}

}  // extern "C"
