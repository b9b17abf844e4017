// The BVH walk for Hopper (sm_90a): kernel X2 of vimg_tpu_torch's
// BVHTracer (geometry/bvh.py::bvh_trace) and of the cost heatmap.
//
// Replaces: no Pallas kernel. vimg_tpu walks its BVH with XLA
// (vimg_tpu/geometry/bvh.py::bvh_traverse, :341-433, leaves in _leaf_test
// :288-328): every lane in lockstep, next = hit ? node + 1 : skip[node],
// each leaf tested 8 primitives wide by one-hot selects, because a TPU
// lane has no stack and no control flow of its own. Its plain PyTorch
// version is geometry/bvh.py::bvh_traverse.
//
// Design: nodes per lane, leaves per warp (the walk of kernels B4 and B2,
// cluster_walk.cuh, on a BVH whose leaves hold up to 8 mixed primitives).
// Each lane walks its own ray's preorder skip links, an inner node whose
// box it meets to node + 1, anything else to its skip link, until it meets
// a live leaf: it posts the leaf and waits. Once kPostMin lanes of the
// warp wait (geometry/bvh.py::POST_MIN), or no lane walks on, the warp
// runs every posted leaf together, a lane to each (posted leaf, slot)
// pair, 32 pairs a step, while the lanes that have not posted keep
// walking up to that point. A hit below the owner's best t merges into the
// owner's least (t, k) key by a shared-memory atomicMin, and the lane
// whose key wins writes its (t, u, v, slot) for the owner. The owner's
// next node sees the t that the per-lane walk would, so each lane visits
// the per-lane walk's nodes in its order and counts its cost, whenever its
// leaves run.
//
// Tables (host-packed once per tree and scene, geometry/bvh.py::
// packed_tables; both 16-byte aligned):
//   node  [n*8 + j]    lo xyz, skip link (int bits); hi xyz, start << 4 |
//                      count (int bits): one round trip of two float4s
//   row   [s*12 + j]   leaf slot s in slot order: a triangle's p0 p1 p2
//                      (words 0..8), a sphere's centre and radius (0..3);
//                      word 9 the test (0 triangle, 1 sphere, -1 none),
//                      10 the prim type, 11 the prim index (int bits)
// The floats are the scene's own (verts[tri_vidx], sph_center,
// sph_radius), so each test sees bvh_traverse's operands.
//
// It computes what bvh_traverse computes, bit for bit:
//  - inv = 1 / (d == 0 ? 1e-20 : d), an IEEE divide (the library is built
//    with -fmad=false and no fast math, so no product is fused into an
//    add anywhere below);
//  - the box test is XLA's: t0 = max(max(max(near.x, near.y), near.z),
//    minT), t1 = min(min(min(far.x, far.y), far.z), best_t), hit = t0 <=
//    t1, with NaN-propagating min / max (cwalk::nmin / nmax, as B3's);
//  - the triangle is geometry/intersect.py::tri_intersect (watertight,
//    pbrt), the sphere sphere_intersect (the robust quadric), each with
//    minT <= t <= best_t, operation for operation in PyTorch's order;
//  - a leaf keeps its first least t and only a t strictly below the best
//    replaces it: the least (t, k) key among the hits below the best t (t's
//    bits made order-preserving, -0 as +0) is that hit; a NaN t never
//    hits; on a miss t = inf, prim_id = 0;
//  - any hit ends at the first leaf that lowers t (vimg_tpu's early exit
//    :407-410); the cost mode adds 0.5 a node visit and count a tested
//    leaf, in float32 in the per-lane walk's order.
//
// What bounds it on this card: dependent loads (a node, then the next)
// and the rays of a warp taking different paths, far above both the bytes
// (48 B a ray plus the tables, all resident in the 50 MB L2) and the
// operations of the plain walk's tests. The first design (a thread a ray,
// the leaf tested in the lane, a primitive behind three dependent loads)
// left a warp waiting on each lane's leaf in turn; here a leaf is one
// round trip of 48-byte rows for all posted lanes at once. Waiting for
// every lane to post (B4's round) doubles the warp's node steps, since a
// round's node phase lasts as long as its slowest lane, and a round at
// every post triples the leaf steps; running the leaves once 8 lanes wait
// gave the least time on 4 of terrain 100k's 6 ray sets of the thresholds
// 1-33 (x2_study.py post-min; PERF.md). A node step is taken by every
// lane, the ones that do not walk on node 0 with the result dropped, so
// the loop has no branch. The modes are held to 64 registers (8 blocks
// of 128 a SM), so the 1,024 blocks of 131,072 rays are resident in one
// wave on 132 SMs.
//
// Launch contract: vimg_bvh_walk() launches on the given stream, does not
// synchronise and allocates nothing; it returns cudaGetLastError(). It
// adds its warp node and leaf steps to steps[0] and steps[1] when steps is
// not null.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_walk.cuh"

namespace {

using cwalk::ldg4;
using cwalk::nmax;
using cwalk::nmin;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 8;  // 64 registers a thread
// a leaf round starts once this many lanes of the warp wait on a leaf (or
// none walks on): geometry/bvh.py::POST_MIN, which its replay reads
constexpr int kPostMin = 8;
constexpr int kLeafSize = 8;
constexpr int kNodeWords = 8;
constexpr int kRowWords = 12;
constexpr int kKindTri = 0;
constexpr int kKindSphere = 1;
constexpr unsigned long long kNoKey = ~0ull;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// A warp's scratch: each lane's ray record, and for a round each posted
// lane's leaf, merge key and winning hit, and the round's pairs
struct Scratch {
  float4 org[32];                      // origin, minT (written once)
  float4 dir[32];                      // direction, best t when posted
  int start[32];                       // the posted leaf's first slot
  unsigned long long key[32];          // least (t, k) of its hits
  float4 hit[32];                      // that hit's t, u, v, slot bits
  unsigned char pair[32 * kLeafSize];  // owner << 3 | k
};

// geometry/intersect.py::tri_intersect for one ray and the triangle of a
// row (q0..q2): returns t (inf on a miss) and the weights u (of p0) and v
// (of p1).
__device__ __forceinline__ float tri_test(const float4& q0, const float4& q1,
                                          const float4& q2, float ox,
                                          float oy, float oz, float dx0,
                                          float dy0, float dz0, float minT,
                                          float maxT, float& u, float& v) {
  const float a0 = q0.x, a1 = q0.y, a2 = q0.z;
  const float b0 = q0.w, b1 = q1.x, b2 = q1.y;
  const float c0 = q1.z, c1 = q1.w, c2 = q2.x;
  // p - ro, then the axis permutation that makes |d| largest along z
  float e0s[3] = {a0 - ox, a1 - oy, a2 - oz};
  float e1s[3] = {b0 - ox, b1 - oy, b2 - oz};
  float e2s[3] = {c0 - ox, c1 - oy, c2 - oz};
  const float adx = fabsf(dx0), ady = fabsf(dy0), adz = fabsf(dz0);
  const bool kz0 = adx >= ady && adx >= adz;
  const bool kz1 = !kz0 && ady >= adz;
  // kz0: (y, z, x); kz1: (z, x, y); else (x, y, z)
  const int kx = kz0 ? 1 : (kz1 ? 2 : 0);
  const int ky = kz0 ? 2 : (kz1 ? 0 : 1);
  const int kz = kz0 ? 0 : (kz1 ? 1 : 2);
  const float dd[3] = {dx0, dy0, dz0};
  const float dx = dd[kx], dy = dd[ky], dz = dd[kz];
  float p0x = e0s[kx], p0y = e0s[ky], p0z = e0s[kz];
  float p1x = e1s[kx], p1y = e1s[ky], p1z = e1s[kz];
  float p2x = e2s[kx], p2y = e2s[ky], p2z = e2s[kz];
  const float sx = -dx / dz;
  const float sy = -dy / dz;
  const float sz = 1.0f / dz;
  p0x = p0x + sx * p0z;
  p0y = p0y + sy * p0z;
  p1x = p1x + sx * p1z;
  p1y = p1y + sy * p1z;
  p2x = p2x + sx * p2z;
  p2y = p2y + sy * p2z;
  const float e0 = p1x * p2y - p1y * p2x;
  const float e1 = p2x * p0y - p2y * p0x;
  const float e2 = p0x * p1y - p0y * p1x;
  const bool same_sign = !((e0 < 0.0f || e1 < 0.0f || e2 < 0.0f) &&
                           (e0 > 0.0f || e1 > 0.0f || e2 > 0.0f));
  const float det = e0 + e1 + e2;
  bool ok = same_sign && det != 0.0f;
  const float t_scaled = e0 * (p0z * sz) + e1 * (p1z * sz) + e2 * (p2z * sz);
  const float inv_det = det != 0.0f ? 1.0f / det : 0.0f;
  const float t = t_scaled * inv_det;
  ok = ok && t >= minT && t <= maxT;
  // degenerate: cross(p2 - p0, p1 - p0) == 0
  const float ex = c0 - a0, ey = c1 - a1, ez = c2 - a2;
  const float fx = b0 - a0, fy = b1 - a1, fz = b2 - a2;
  const float cx = ey * fz - ez * fy, cy = ez * fx - ex * fz,
              cz = ex * fy - ey * fx;
  ok = ok && !(cx * cx + cy * cy + cz * cz == 0.0f);
  u = e0 * inv_det;
  v = e1 * inv_det;
  return ok ? t : inf_f();
}

// geometry/intersect.py::sphere_intersect for one ray and the sphere of a
// row (q0: centre, radius).
__device__ __forceinline__ float sphere_test(const float4& q0, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float minT,
                                             float maxT) {
  const float fx = ox - q0.x;
  const float fy = oy - q0.y;
  const float fz = oz - q0.z;
  const float r = q0.w;
  const float a = dx * dx + dy * dy + dz * dz;
  const float b_prime = (-fx) * dx + (-fy) * dy + (-fz) * dz;
  const float c = (fx * fx + fy * fy + fz * fz) - r * r;
  const float k = b_prime / a;
  const float tx = fx + k * dx, ty = fy + k * dy, tz = fz + k * dz;
  const float disc = r * r - (tx * tx + ty * ty + tz * tz);
  const bool has_root = disc >= 0.0f;
  const float sign = b_prime > 0.0f ? 1.0f : -1.0f;
  const float disc_safe = has_root ? nmax(a * disc, 1e-30f) : 1.0f;
  const float q = b_prime + sign * sqrtf(disc_safe);
  const float x0 = c / (q == 0.0f ? 1.0f : q);
  const float x1 = q / a;
  const float t0 = nmin(x0, x1);
  const float t1 = nmax(x0, x1);
  const bool t0_ok = t0 >= minT && t0 <= maxT;
  const bool t1_ok = t1 >= minT && t1 <= maxT;
  const float t = t0_ok ? t0 : t1;
  return has_root && (t0_ok || t1_ok) ? t : inf_f();
}

// kMode: 0 closest, 1 any hit, 2 closest with the cost counter. kSteps:
// count the warp node and leaf steps into steps_out[0..1]. Every lane of a
// warp with a ray takes part; lanes past n_rays walk nothing.
template <int kMode, bool kSteps>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bvh_walk_kernel(const float* __restrict__ nodes,
                    const float* __restrict__ rows,
                    const float* __restrict__ ro,
                    const float* __restrict__ rd,
                    const float* __restrict__ min_t,
                    const float* __restrict__ max_t, int n_rays, int n_nodes,
                    int n_prims, float* __restrict__ out_t,
                    int* __restrict__ out_type, int* __restrict__ out_id,
                    float* __restrict__ out_u, float* __restrict__ out_v,
                    uint8_t* __restrict__ out_occ,
                    float* __restrict__ out_cost,
                    unsigned long long* __restrict__ steps_out) {
  __shared__ Scratch scratch[kWarps];
  Scratch& ws = scratch[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r - lane >= n_rays) return;  // the whole warp
  const bool live = r < n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
  float mn = 0.0f, best = 0.0f;
  if (live) {
    ox = ro[3 * r];
    oy = ro[3 * r + 1];
    oz = ro[3 * r + 2];
    dx = rd[3 * r];
    dy = rd[3 * r + 1];
    dz = rd[3 * r + 2];
    mn = min_t[r];
    best = max_t[r];
  }
  ws.org[lane] = make_float4(ox, oy, oz, mn);
  ws.dir[lane] = make_float4(dx, dy, dz, best);
  const float ix = 1.0f / (dx == 0.0f ? 1e-20f : dx);
  const float iy = 1.0f / (dy == 0.0f ? 1e-20f : dy);
  const float iz = 1.0f / (dz == 0.0f ? 1e-20f : dz);
  const unsigned lt = (1u << lane) - 1u;
  int node = live ? 0 : n_nodes;
  int post = -1;  // a posted live leaf: start << 4 | count
  float cost = 0.0f;
  bool found = false;
  cwalk::Steps steps = {0u, 0u};
  for (;;) {
    // ---- node steps of the lanes that walk and wait on no leaf, until
    // kPostMin lanes wait on one or no lane walks on (one vote a step:
    // waiting lanes in the low 6 bits, walking lanes above) ----
    unsigned votes;
    for (;;) {
      const bool walking = post < 0 && node < n_nodes;
      votes = __reduce_add_sync(cwalk::FULL,
                                (post >= 0 ? 1u : 0u) + (walking ? 64u : 0u));
      if (votes < 64u || (votes & 63u) >= (unsigned)kPostMin) break;
      if (kSteps && lane == 0) ++steps.node;
      // every lane takes the step (node 0 for one that does not walk) and
      // only a walking lane keeps it: no branch in the loop
      const int at = walking ? node : 0;
      const float4 lo = ldg4(nodes + (size_t)at * kNodeWords);
      const float4 hi = ldg4(nodes + (size_t)at * kNodeWords + 4);
      const float lx = (lo.x - ox) * ix, hx = (hi.x - ox) * ix;
      const float ly = (lo.y - oy) * iy, hy = (hi.y - oy) * iy;
      const float lz = (lo.z - oz) * iz, hz = (hi.z - oz) * iz;
      const float t0 =
          nmax(nmax(nmax(nmin(lx, hx), nmin(ly, hy)), nmin(lz, hz)), mn);
      const float t1 =
          nmin(nmin(nmin(nmax(lx, hx), nmax(ly, hy)), nmax(lz, hz)), best);
      const bool hit = t0 <= t1;
      const int sc = __float_as_int(hi.w);
      if (kMode == 2 && walking) cost = cost + 0.5f;
      const bool inner = hit && (sc & 15) == 0;
      if (walking) {
        node = inner ? node + 1 : __float_as_int(lo.w);
        post = hit && !inner ? sc : post;
      }
    }
    if ((votes & 63u) == 0u) break;  // no lane waits, none walks on
    // ---- leaf round: the waiting lanes' (leaf, slot) pairs, 32 a step --
    const int n = post >= 0 ? min(post & 15, kLeafSize) : 0;
    const unsigned b0 = __ballot_sync(cwalk::FULL, n & 1);
    const unsigned b1 = __ballot_sync(cwalk::FULL, n & 2);
    const unsigned b2 = __ballot_sync(cwalk::FULL, n & 4);
    const unsigned b3 = __ballot_sync(cwalk::FULL, n & 8);
    const int total =
        __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2) + 8 * __popc(b3);
    if (post >= 0) {
      ws.dir[lane].w = best;
      ws.start[lane] = post >> 4;
      ws.key[lane] = kNoKey;
      const int e = __popc(b0 & lt) + 2 * __popc(b1 & lt) +
                    4 * __popc(b2 & lt) + 8 * __popc(b3 & lt);
      for (int k = 0; k < n; ++k)
        ws.pair[e + k] = (unsigned char)((lane << 3) | k);
    }
    __syncwarp();
    for (int base = 0; base < total; base += 32) {
      int owner = 0, slot = 0;
      unsigned long long mine = kNoKey;
      float t = inf_f(), u = 0.0f, v = 0.0f;
      if (base + lane < total) {
        const int e = ws.pair[base + lane];
        const int k = e & 7;
        owner = e >> 3;
        slot = min(ws.start[owner] + k, n_prims - 1);
        const float4 o = ws.org[owner], d = ws.dir[owner];
        const float* q = rows + (size_t)slot * kRowWords;
        const float4 q0 = ldg4(q), q1 = ldg4(q + 4), q2 = ldg4(q + 8);
        const int kind = __float_as_int(q2.y);
        if (kind == kKindTri)
          t = tri_test(q0, q1, q2, o.x, o.y, o.z, d.x, d.y, d.z, o.w, d.w, u,
                       v);
        else if (kind == kKindSphere)
          t = sphere_test(q0, o.x, o.y, o.z, d.x, d.y, d.z, o.w, d.w);
        if (t < d.w) {  // below the owner's best: never a miss or a NaN
          mine = cwalk::hit_key(t, k);
          if (kMode == 1)
            ws.key[owner] = 0ull;
          else
            atomicMin(&ws.key[owner], mine);
        }
      }
      if (kMode != 1) {
        __syncwarp();
        if (mine != kNoKey && ws.key[owner] == mine)
          ws.hit[owner] = make_float4(t, u, v, __int_as_float(slot));
      }
    }
    if (kSteps && lane == 0) steps.tri += (unsigned)((total + 31) >> 5);
    __syncwarp();
    if (post >= 0) {
      if (kMode == 2) cost = cost + (float)(post & 15);
      if (ws.key[lane] != kNoKey) {
        found = true;
        if (kMode == 1)
          node = n_nodes;
        else
          best = ws.hit[lane].x;
      }
      post = -1;
    }
    __syncwarp();  // the next round rewrites the scratch
  }
  if (kSteps && lane == 0) {
    atomicAdd(steps_out, (unsigned long long)steps.node);
    atomicAdd(steps_out + 1, (unsigned long long)steps.tri);
  }
  if (!live) return;
  if (kMode == 1) {
    out_occ[r] = found ? 1 : 0;
    return;
  }
  float bu = 0.0f, bv = 0.0f;
  int btype = 0, bid = 0;
  if (found) {
    const float4 h = ws.hit[lane];
    const float4 q2 =
        ldg4(rows + (size_t)__float_as_int(h.w) * kRowWords + 8);
    bu = h.y;
    bv = h.z;
    btype = __float_as_int(q2.z);
    bid = __float_as_int(q2.w);
  }
  out_t[r] = found ? best : inf_f();
  out_type[r] = btype;
  out_id[r] = bid;
  out_u[r] = bu;
  out_v[r] = bv;
  if (kMode == 2) out_cost[r] = cost;
}

template <int kMode, bool kSteps>
int launch(const float* nodes, const float* rows, const float* ro,
           const float* rd, const float* min_t, const float* max_t,
           int n_rays, int n_nodes, int n_prims, float* t, int* ptype,
           int* pidx, float* u, float* v, uint8_t* occ, float* cost,
           unsigned long long* steps, cudaStream_t stream) {
  const dim3 grid((n_rays + kThreads - 1) / kThreads);
  bvh_walk_kernel<kMode, kSteps><<<grid, kThreads, 0, stream>>>(
      nodes, rows, ro, rd, min_t, max_t, n_rays, n_nodes, n_prims, t, ptype,
      pidx, u, v, occ, cost, steps);
  return (int)cudaGetLastError();
}

template <int kMode>
int launch_mode(const float* nodes, const float* rows, const float* ro,
                const float* rd, const float* min_t, const float* max_t,
                int n_rays, int n_nodes, int n_prims, float* t, int* ptype,
                int* pidx, float* u, float* v, uint8_t* occ, float* cost,
                unsigned long long* steps, cudaStream_t stream) {
  if (steps != nullptr)
    return launch<kMode, true>(nodes, rows, ro, rd, min_t, max_t, n_rays,
                               n_nodes, n_prims, t, ptype, pidx, u, v, occ,
                               cost, steps, stream);
  return launch<kMode, false>(nodes, rows, ro, rd, min_t, max_t, n_rays,
                              n_nodes, n_prims, t, ptype, pidx, u, v, occ,
                              cost, steps, stream);
}

}  // namespace

extern "C" int vimg_bvh_walk(const float* nodes, const float* rows,
                             const float* ro, const float* rd,
                             const float* min_t, const float* max_t,
                             int n_rays, int n_nodes, int n_prims, int mode,
                             float* t, int* ptype, int* pidx, float* u,
                             float* v, uint8_t* occ, float* cost,
                             unsigned long long* steps,
                             cudaStream_t stream) {
  if (n_rays <= 0) return 0;
  if (mode == 1)
    return launch_mode<1>(nodes, rows, ro, rd, min_t, max_t, n_rays, n_nodes,
                          n_prims, t, ptype, pidx, u, v, occ, cost, steps,
                          stream);
  if (mode == 2)
    return launch_mode<2>(nodes, rows, ro, rd, min_t, max_t, n_rays, n_nodes,
                          n_prims, t, ptype, pidx, u, v, occ, cost, steps,
                          stream);
  return launch_mode<0>(nodes, rows, ro, rd, min_t, max_t, n_rays, n_nodes,
                        n_prims, t, ptype, pidx, u, v, occ, cost, steps,
                        stream);
}

// What a launch of the mode (uncounted) would run: its resident blocks per
// SM (blocks of kThreads), registers a thread and local memory bytes a
// thread (its stack frame, spills included).
extern "C" int vimg_bvh_occupancy(int mode, int* per_sm, int* regs,
                                  int* local_bytes) {
  const void* fn = mode == 1   ? (const void*)bvh_walk_kernel<1, false>
                   : mode == 2 ? (const void*)bvh_walk_kernel<2, false>
                               : (const void*)bvh_walk_kernel<0, false>;
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, fn);
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, kThreads, 0);
  return (int)cudaGetLastError();
}
