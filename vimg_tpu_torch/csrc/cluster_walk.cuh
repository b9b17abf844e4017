// Device code of the cluster-tree walks, shared by kernels B3/B4
// (cluster_trace.cu) and the mesh mode of the megakernel B2
// (megakernel.cu): the ray record, the slab tests, the triangle test, the
// warp-cooperative leaf round (B3, B4, B2) and the skip-link walk of the
// binary cluster tree that runs on it (B4, B2).
//
// Everything lives in namespace cwalk so that the including file's own
// Hit / jmin / jmax do not clash. The arithmetic is the plain walks'
// (geometry/cluster_trace.py: _slab, _leaf_tests, skip_walk_plain)
// operation for operation; the including files are built with -fmad=false
// and without fast math, so + - * / round alike. jmin/jmax propagate NaN
// like torch.minimum / jnp.minimum (fminf/fmaxf would drop it).
//
// Tables (flat row-major views of vimg_tpu's packed arrays; the node boxes
// and triangle rows are read as float4, so both start 16-byte aligned):
//   node aabbs  [n*8 + j]          binary node box: lo xyz, hi xyz
//   node cid    [n]                cluster id of a leaf node, -1 inner
//   node skip   [n]                preorder skip link
//   tri         [c*1024 + k*16 + j] plane n, d0, m1, c1, m2, c2 (j < 12);
//                                  rows 2s / 2s+1 hold the lo / hi of
//                                  16-tri sub-box s in slots 13..15
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace cwalk {

constexpr int K = 64;           // triangles per cluster
constexpr int ROW = 16;         // floats per triangle row
constexpr int SUB = 16;         // triangles per sub-box gate
constexpr int N_SUB = K / SUB;
constexpr unsigned FULL = 0xffffffffu;
// warps per block of every kernel that calls warp_skip_walk (blocks of 128)
constexpr int WALK_WARPS = 4;

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fffffff); }
__device__ __forceinline__ bool isnan_(float a) { return a != a; }
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan_(a) || isnan_(b)) ? qnan() : (a > b ? a : b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan_(a) || isnan_(b)) ? qnan() : (a < b ? a : b);
}
// The same in one instruction each (PTX min.NaN / max.NaN, sm_80+), as
// torch.minimum / torch.maximum: NaN when either input is NaN (B3's node
// boxes, X2's boxes and sphere roots)
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, minT;
};

struct Hit {
  float t, u, v;
  int slot;  // c*K + k of the hit triangle, -1 for none
};

// Box and triangle tests of a lane's walks (kernel-side counters of B2;
// B3/B4 instantiate the walks without them)
struct Tests {
  unsigned box, tri;
};

// Warp steps of the walks, kept by lane 0: node steps (a round's node
// phase costs the most any lane took) and triangle steps (two 16-triangle
// units a step)
struct Steps {
  unsigned node, tri;
};

// The walk's ray record: inverse directions as the plain walks' _inv_dir
__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float minT) {
  Ray r;
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  r.dx = dx;
  r.dy = dy;
  r.dz = dz;
  r.ix = 1.0f / (dx == 0.0f ? 1e-30f : dx);
  r.iy = 1.0f / (dy == 0.0f ? 1e-30f : dy);
  r.iz = 1.0f / (dz == 0.0f ? 1e-30f : dz);
  r.minT = minT;
  return r;
}

// Whether the ray walks at all: maxT = -inf keeps no node live (tin >=
// minT > -inf), so such a ray leaves at once
__device__ __forceinline__ bool walks(const Ray& r, float maxT, bool any_hit) {
  if (any_hit) return maxT != -INFINITY;
  return !(maxT == -INFINITY && r.minT != -INFINITY);
}

// slab test of the box (lo, hi) over [minT, bt]
__device__ __forceinline__ bool slab6(float lox, float loy, float loz,
                                      float hix, float hiy, float hiz,
                                      const Ray& r, float bt) {
  float t0x = (lox - r.ox) * r.ix;
  float t1x = (hix - r.ox) * r.ix;
  float t0y = (loy - r.oy) * r.iy;
  float t1y = (hiy - r.oy) * r.iy;
  float t0z = (loz - r.oz) * r.iz;
  float t1z = (hiz - r.oz) * r.iz;
  float tin = jmax(jmax(jmin(t0x, t1x), jmin(t0y, t1y)),
                   jmax(jmin(t0z, t1z), r.minT));
  float tout = jmin(jmin(jmax(t0x, t1x), jmax(t0y, t1y)),
                    jmin(jmax(t0z, t1z), bt));
  return tin <= tout;
}

__device__ __forceinline__ float4 ldg4(const float* __restrict__ p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The triangle test of row q (three 16-byte loads): t, u, v and whether
// the ray meets the triangle's plane inside it (minT and the best t are
// the caller's)
__device__ __forceinline__ bool tri_test(const float* __restrict__ q,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         float& t, float& u, float& v) {
  const float4 a = ldg4(q), b = ldg4(q + 4), c = ldg4(q + 8);
  float ro_n = ox * a.x + oy * a.y + oz * a.z;
  float rd_n = dx * a.x + dy * a.y + dz * a.z;
  bool par = fabsf(rd_n) < 1e-22f;
  t = (a.w - ro_n) / (par ? 1.0f : rd_n);
  u = ox * b.x + oy * b.y + oz * b.z - b.w
      + t * (dx * b.x + dy * b.y + dz * b.z);
  v = ox * c.x + oy * c.y + oz * c.z - c.w
      + t * (dx * c.x + dy * c.y + dz * c.z);
  return !par && u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
}

// Merge key of a hit: least t first (its bits made order-preserving, -0
// taken as +0 so that equal t compare equal), then least k. Below 2^38,
// so never the empty key ~0.
__device__ __forceinline__ unsigned long long hit_key(float t, int k) {
  unsigned b = __float_as_uint(t == 0.0f ? 0.0f : t);
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)b << 6) | (unsigned)k;
}

// A warp's scratch for the leaves of one round: each posted lane's ray
// record (o, minT), (d, entry t), (1/d, cluster id) and its merge key; the
// round's units, one a gated sub-box: owner lane << 24 | first row
struct WarpScratch {
  float4 rec[32][3];
  unsigned long long key[32];
  unsigned unit[32 * N_SUB];
};

__device__ __forceinline__ WarpScratch& warp_scratch() {
  __shared__ WarpScratch scratch[WALK_WARPS];
  return scratch[threadIdx.x >> 5];
}

// The leaf round of the warp walks (B3, B4, B2): every lane of the warp
// calls it together, after its node phase, with c the cluster it posts (-1
// for none). Returns false, for the whole warp, when no lane posted: the
// warp's walk is over. Otherwise the warp runs the posted leaves: groups
// of 4 lanes gate a posted leaf's 4 sub-boxes at its entry t (8 leaves a
// pass); the gated sub-boxes of all posted lanes become units of 16
// triangles, two units a step, a lane a triangle. A lane with a hit (t >=
// minT, t < the entry t) merges it into the owner's key by a
// shared-memory atomicMin (any hit: the key is set). The owner takes the
// least (t, k) and recomputes that triangle's t, u, v, bit for bit what
// the hitting lane computed. That is the sequential scan's answer: strict
// < keeps the least t below the entry t and the first k of equal t; a NaN
// t never hits. An any-hit owner gets t = -inf and stop = true (its walk
// must end, but it still joins the warp's later rounds). kGate = false
// (the walk-ablation probe P1, whose leaves test all 64 triangles) skips
// the gates: every sub-box of a posted leaf becomes a unit.
template <bool kCount, bool kSteps, bool kGate = true>
__device__ __forceinline__ bool leaf_round(const float* __restrict__ tri,
                                           int c, const Ray& r, Hit& h,
                                           bool any_hit, Tests& n,
                                           Steps& steps, bool& stop) {
  WarpScratch& ws = warp_scratch();
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
  const unsigned posted = __ballot_sync(FULL, c >= 0);
  if (posted == 0u) return false;
  if (c >= 0) {
    ws.rec[lane][0] = make_float4(r.ox, r.oy, r.oz, r.minT);
    ws.rec[lane][1] = make_float4(r.dx, r.dy, r.dz, h.t);
    ws.rec[lane][2] = make_float4(r.ix, r.iy, r.iz, __int_as_float(c));
    ws.key[lane] = ~0ull;
  }
  __syncwarp();
  // ---- gates: lanes 4q..4q+3 test sub-boxes 0..3 of the q-th leaf ----
  unsigned gate = kGate || c < 0 ? 0u : (1u << N_SUB) - 1u;
  const int q = lane >> 2, s = lane & 3;
  for (unsigned rem = kGate ? posted : 0u; rem != 0u;) {
    unsigned m = rem;
    for (int j = 0; j < q && m != 0u; ++j) m &= m - 1u;
    bool g = false;
    if (m != 0u) {
      const int src = __ffs(m) - 1;
      const float4 o = ws.rec[src][0], d = ws.rec[src][1];
      const float4 iv = ws.rec[src][2];
      Ray rr;
      rr.ox = o.x;
      rr.oy = o.y;
      rr.oz = o.z;
      rr.ix = iv.x;
      rr.iy = iv.y;
      rr.iz = iv.z;
      rr.minT = o.w;
      const float* rows =
          tri + (size_t)__float_as_int(iv.w) * (K * ROW) + 12;
      const float4 lo = ldg4(rows + (2 * s) * ROW);
      const float4 hi = ldg4(rows + (2 * s + 1) * ROW);
      g = slab6(lo.y, lo.z, lo.w, hi.y, hi.z, hi.w, rr, d.w);
    }
    const unsigned bal = __ballot_sync(FULL, g);
    if ((rem >> lane) & 1u) {
      const int rank = __popc(rem & lt);
      if (rank < 8) gate = (bal >> (4 * rank)) & 0xFu;
    }
    for (int j = 0; j < 8 && rem != 0u; ++j) rem &= rem - 1u;
  }
  // ---- units: the gated sub-boxes in lane order ----
  const int cnt = __popc(gate);
  const unsigned b0 = __ballot_sync(FULL, cnt & 1);
  const unsigned b1 = __ballot_sync(FULL, cnt & 2);
  const unsigned b2 = __ballot_sync(FULL, cnt & 4);
  const int total = __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
  if (c >= 0) {
    if (kCount) {
      n.box += N_SUB;
      n.tri += SUB * cnt;
    }
    int e = __popc(b0 & lt) + 2 * __popc(b1 & lt) + 4 * __popc(b2 & lt);
    for (int j = 0; j < N_SUB; ++j)
      if ((gate >> j) & 1u)
        ws.unit[e++] = ((unsigned)lane << 24) | (unsigned)(c * K + j * SUB);
  }
  __syncwarp();
  // ---- triangle steps: half-warp h takes unit base + h ----
  for (int base = 0; base < total; base += 2) {
    const int un = base + (lane >> 4);
    if (un < total) {
      const unsigned e = ws.unit[un];
      const int owner = (int)(e >> 24);
      const int row = (int)(e & 0xFFFFFFu) + (lane & 15);
      const float4 o = ws.rec[owner][0], d = ws.rec[owner][1];
      float t, u, v;
      if (tri_test(tri + (size_t)row * ROW, o.x, o.y, o.z, d.x, d.y, d.z,
                   t, u, v) &&
          t >= o.w && t < d.w) {
        if (any_hit)
          ws.key[owner] = 0ull;
        else
          atomicMin(&ws.key[owner], hit_key(t, row & (K - 1)));
      }
    }
  }
  if (kSteps && lane == 0) steps.tri += (unsigned)((total + 1) >> 1);
  __syncwarp();
  if (c >= 0) {
    const unsigned long long key = ws.key[lane];
    if (key != ~0ull) {
      if (any_hit) {
        h.t = -INFINITY;
        stop = true;
      } else {
        const int k = (int)(key & (K - 1));
        float t, u, v;
        tri_test(tri + ((size_t)c * K + k) * ROW, r.ox, r.oy, r.oz, r.dx,
                 r.dy, r.dz, t, u, v);
        h.t = t;
        h.u = u;
        h.v = v;
        h.slot = c * K + k;
      }
    }
  }
  __syncwarp();  // the next round rewrites the scratch
  return true;
}

// The node phase's step count of a round: the most any lane of the warp
// took, kept by lane 0
template <bool kSteps>
__device__ __forceinline__ void count_node_steps(unsigned it, Steps& steps) {
  if (kSteps) {
    const unsigned most = __reduce_max_sync(FULL, it);
    if ((threadIdx.x & 31) == 0) steps.node += most;
  }
}

// Stackless skip-link walk of the binary cluster tree, n = live ? n + 1 :
// skip[n], with the leaves run by the whole warp (leaf_round).
//
// Every lane of the warp calls it together (the same call, the same number
// of times); lanes with go = false take part without a ray. h holds maxT
// on entry and the best hit on exit (t = -inf for an any-hit).
//
// A round: each lane walks its own nodes, exactly as a per-lane walk,
// until it reaches a live leaf (it posts the leaf and waits) or the end;
// then the warp runs the posted leaves. The owner's next node sees the
// t that a per-lane walk would, so every lane's node sequence and (t,
// slot, u, v) are a per-lane walk's.
template <bool kCount, bool kSteps>
__device__ __forceinline__ void warp_skip_walk(
    const float* __restrict__ aabb, const int* __restrict__ cid,
    const int* __restrict__ skip, const float* __restrict__ tri,
    int n_nodes, const Ray& r, Hit& h, bool any_hit, bool go, Tests& n,
    Steps& steps) {
  int node = go ? 0 : n_nodes;
  for (;;) {
    // ---- node phase ----
    int c = -1;
    unsigned it = 0;
    while (node < n_nodes) {
      const float4 a = ldg4(aabb + (size_t)node * 8);
      const float4 b = ldg4(aabb + (size_t)node * 8 + 4);
      const bool live = slab6(a.x, a.y, a.z, a.w, b.x, b.y, r, h.t);
      const int cc = __ldg(cid + node);
      ++it;
      if (live && cc >= 0) {
        c = cc;
        ++node;
        break;
      }
      node = live ? node + 1 : __ldg(skip + node);
    }
    if (kCount) n.box += it;
    count_node_steps<kSteps>(it, steps);
    bool stop = false;
    if (!leaf_round<kCount, kSteps>(tri, c, r, h, any_hit, n, steps, stop))
      return;
    if (stop) node = n_nodes;
  }
}

}  // namespace cwalk
