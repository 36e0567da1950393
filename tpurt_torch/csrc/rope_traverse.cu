// Binary rope-BVH ray traversal for Hopper (sm_90a): closest hit (K3) and
// occlusion (K4) in one templated kernel.
//
// Replaces tpurt/kernels/experimental/pallas_traverse.py:215
// _traverse_packets (_traverse_kernel, K3, reached through
// traverse_packets) and :451 _occlusion_packets (_occlusion_kernel, K4,
// reached through occlusion_packets). It reads the card tables that
// kernels/experimental/rope.py::card_tables copies out of tpurt's rope
// rows once per BVH, laid out for 16-byte loads:
//
//   boxes (M x 32 B): node n is [lo.xyz, 0] [hi.xyz, 0], one copy for all
//     eight direction octants (tpurt's rows repeat it per octant);
//   links (8 x M x 8 B): [first, skip] of node n in octant o as ints, the
//     END sentinel M; internal nodes first (n < n_internal), then leaves;
//   tris (L x G x 48 B): triangle k of leaf l is [v0.xyz, mask bits]
//     [e1.xyz, 0] [e2.xyz, 0], e1 = v1 - v0 and e2 = v2 - v0 taken in f32
//     (the same bits as the subtraction the plain walk does), the mask 0
//     without a mask column (bits 0-15 transparent 4x4 cells, bit 16
//     alpha-testable).
//
// Contract and order. One thread per ray; the ray walks the ropes of its
// own direction octant exactly as the plain walk
// (kernels/experimental/rope.py::traverse_plain) does: at node n the slab
// test against (t_min, t_best) decides between first[oct][n] (an internal
// node whose box is hit) and skip[oct][n] (anything else); a leaf whose box
// is hit tests its G triangles in row order with a strict t < t_best (the
// first copy of the padded last triangle wins), before the ray's next node
// step. The slab and triangle tests repeat the plain walk's expression
// order and the library is built with --fmad=false, so t, prim (the leaf
// slot), u, v and blocked are bit-equal to it. K4 retires a ray after the
// leaf in which it met a definite blocker (mask bit 16 clear, or any hit
// with all_definite and no masks). A correct rope visits each node at most
// once, so a walk is capped at 4*M steps (an int counter: M < 2^24); a
// walk that reaches the cap ORs cudalib's rope-steps bit into *err (the
// card's error word) and stops, instead of looping on a broken link.
//
// Design, against what held the first version back:
//  1. Scalar loads at a 32-byte node row and a 36-byte triangle stride: a
//     node step is now two 16-byte __ldg loads of its box and one 8-byte
//     load of its links, all three independent of each other, and a
//     triangle three 16-byte loads with its edges precomputed.
//  2. Boxes copied per octant (13.8 MB of node rows on the bench scene at
//     G = 8, against 1.7 MB of distinct boxes): one box per node, so a warp
//     of rays in different octants shares the box lines in L1/L2.
//  3. The if-if loop, where a thread at a leaf ran G triangle tests while
//     its warp mates on internal nodes waited: the walk is while-while
//     (Aila & Laine, HPG 2009), node steps in an inner loop until a leaf
//     whose box is hit, then that leaf. Each thread keeps its own order;
//     only the way the warp converges changes.
// One thread per ray, 128 threads per block, over a grid of all the rays.
// Other launches measured no faster on the render's whole-frame shapes and
// were dropped (PERF.md): 64 or 256 threads, resident blocks fed by an
// atomic ray counter (per warp or per lane), a 40-register cap, rays
// grouped by octant. The walk stays one function: the same walk written
// as a per-ray state object advanced from an outer loop compiled to a
// kernel 2x slower on bounce rays.
//
// Bound. A node step is one box test (~25 f32 operations) and a leaf
// whose box is hit G triangle tests (~60 each): bound by operations
// against the 67 TFLOP/s f32 rate; the card tables (15.4 MB on the bench
// scene at G = 8) fit the 50 MB L2. What the kernel pays for is a long
// chain of dependent loads per ray (every step's address comes from the
// previous step's link) and a divergent walk (PERF.md records its time
// beside the bound computed from the plain walk's step counts).
//
// Plain C interface for ctypes: pointers and the stream come in as void*,
// each entry point returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kErrStepCap = 2;  // cudalib.ERR_ROPE_STEPS
constexpr int kWordsPerTri = 3;  // float4 words per triangle

struct Args {
  const float4* boxes;
  const int2* links;
  int m;
  int n_internal;
  const float4* tris;
  int group;
  int all_definite;
  const float* o;
  const float* d;
  const float* t_min;
  const float* t_limit;
  const uint8_t* active;
  float* t_out;
  int* prim_out;
  float* u_out;
  float* v_out;
  float* blocked_out;
  int n;
  int* err;
};

// The whole walk of ray j, results written at j.
template <bool Occlusion, bool Masks>
__device__ __forceinline__ void walk_ray(const Args& a, int j) {
  const float ox = a.o[3 * j + 0], oy = a.o[3 * j + 1], oz = a.o[3 * j + 2];
  const float dx = a.d[3 * j + 0], dy = a.d[3 * j + 1], dz = a.d[3 * j + 2];
  const float t_min = a.t_min[j];
  const float tiny = 1e-20f;
  // sign / max(|d|, 1e-20), as pallas_traverse.py:121-123
  const float inv_x = (dx >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dx), tiny);
  const float inv_y = (dy >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dy), tiny);
  const float inv_z = (dz >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(dz), tiny);
  const int oct = (dx < 0.0f ? 4 : 0) + (dy < 0.0f ? 2 : 0) + (dz < 0.0f ? 1 : 0);
  const int2* links = a.links + (size_t)oct * a.m;

  float t_best = a.t_limit[j];
  int prim = -1;
  float uu = 0.0f, vv = 0.0f;
  bool blocked = false;

  const int end = a.m;
  const int cap = 4 * a.m;
  int steps = 0;
  int node = a.active[j] ? 0 : end;
  while (node != end) {
    // ---- node steps, until a leaf whose box is hit or the end ----
    int leaf = -1, next = end;
    while (node != end) {
      if (steps++ >= cap) {
        atomicOr(a.err, kErrStepCap);
        node = end;
        break;
      }
      const float4 lo = __ldg(a.boxes + 2 * node);
      const float4 hi = __ldg(a.boxes + 2 * node + 1);
      const int2 ln = __ldg(links + node);
      const float t0x = (lo.x - ox) * inv_x;
      const float t1x = (hi.x - ox) * inv_x;
      const float t0y = (lo.y - oy) * inv_y;
      const float t1y = (hi.y - oy) * inv_y;
      const float t0z = (lo.z - oz) * inv_z;
      const float t1z = (hi.z - oz) * inv_z;
      const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fmaxf(fminf(t0z, t1z), t_min));
      const float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                             fminf(fmaxf(t0z, t1z), t_best));
      const bool hit = tn <= tf;
      if (hit && node >= a.n_internal) {
        leaf = node - a.n_internal;
        next = ln.y;
        break;
      }
      node = hit ? ln.x : ln.y;
    }
    if (leaf < 0) break;

    // ---- the leaf's G triangles, before the next node step ----
    const float4* tri = a.tris + (size_t)leaf * a.group * kWordsPerTri;
    for (int k = 0; k < a.group; ++k) {
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
      const float w = (dx * qx + dy * qy + dz * qz) * inv_det;
      const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      if (!(ok && u >= 0.0f && w >= 0.0f && u + w <= 1.0f && t > t_min &&
            t < t_best))
        continue;
      if (Masks) {
        const int mask = __float_as_int(w0.w);
        const int cu = min(max((int)(u * 4.0f), 0), 3);
        const int cv = min(max((int)(w * 4.0f), 0), 3);
        if ((mask >> (cu * 4 + cv)) & 1) continue;  // transparent cell
        if (Occlusion && ((mask >> 16) & 1) == 0) blocked = true;
      } else if (Occlusion && a.all_definite) {
        blocked = true;
      }
      t_best = t;
      prim = leaf * a.group + k;
      uu = u;
      vv = w;
    }
    node = next;
    if (Occlusion && blocked) break;
  }
  a.t_out[j] = t_best;
  a.prim_out[j] = prim;
  a.u_out[j] = uu;
  a.v_out[j] = vv;
  a.blocked_out[j] = blocked ? 1.0f : 0.0f;
}

template <bool Occlusion, bool Masks>
__global__ void __launch_bounds__(kThreads)
rope_walk(const Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) walk_ray<Occlusion, Masks>(a, i);
}

template <bool Occlusion>
int launch(const void* boxes, const void* links, int m, int n_internal, const void* tris,
           int group, int use_masks, int all_definite, const void* o, const void* d,
           const void* t_min, const void* t_limit, const void* active, void* t_out,
           void* prim_out, void* u_out, void* v_out, void* blocked_out, int n, void* err,
           void* stream) {
  if (n <= 0) return 0;
  const Args a{(const float4*)boxes, (const int2*)links, m, n_internal, (const float4*)tris,
               group, all_definite, (const float*)o, (const float*)d, (const float*)t_min,
               (const float*)t_limit, (const uint8_t*)active, (float*)t_out, (int*)prim_out,
               (float*)u_out, (float*)v_out, (float*)blocked_out, n, (int*)err};
  const int blocks = (n + kThreads - 1) / kThreads;
  if (use_masks) {
    rope_walk<Occlusion, true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  } else {
    rope_walk<Occlusion, false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tpurt_rope_closest(const void* boxes, const void* links, int m, int n_internal,
                       const void* tris, int group, int use_masks, int all_definite,
                       const void* o, const void* d, const void* t_min, const void* t_limit,
                       const void* active, void* t_out, void* prim_out, void* u_out,
                       void* v_out, void* blocked_out, int n, void* err, void* stream) {
  return launch<false>(boxes, links, m, n_internal, tris, group, use_masks, all_definite, o,
                       d, t_min, t_limit, active, t_out, prim_out, u_out, v_out, blocked_out,
                       n, err, stream);
}

int tpurt_rope_occlusion(const void* boxes, const void* links, int m, int n_internal,
                         const void* tris, int group, int use_masks, int all_definite,
                         const void* o, const void* d, const void* t_min,
                         const void* t_limit, const void* active, void* t_out,
                         void* prim_out, void* u_out, void* v_out, void* blocked_out, int n,
                         void* err, void* stream) {
  return launch<true>(boxes, links, m, n_internal, tris, group, use_masks, all_definite, o, d,
                      t_min, t_limit, active, t_out, prim_out, u_out, v_out, blocked_out, n,
                      err, stream);
}

}  // extern "C"
