// Device code of the cluster-tree walks, shared by kernels B3/B4
// (cluster_trace.cu) and the mesh mode of the megakernel B2
// (megakernel.cu): the ray record, the slab tests, the 64-triangle leaf and
// the stackless skip-link walk of the binary cluster tree.
//
// Everything lives in namespace cwalk so that the including file's own
// Hit / jmin / jmax do not clash. The arithmetic is the plain walks'
// (geometry/cluster_trace.py: _slab, _leaf_tests, skip_walk_plain)
// operation for operation; the including files are built with -fmad=false
// and without fast math, so + - * / round alike. jmin/jmax propagate NaN
// like torch.minimum / jnp.minimum (fminf/fmaxf would drop it).
//
// Tables (flat row-major views of vimg_tpu's packed arrays):
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

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fffffff); }
__device__ __forceinline__ bool isnan_(float a) { return a != a; }
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan_(a) || isnan_(b)) ? qnan() : (a > b ? a : b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan_(a) || isnan_(b)) ? qnan() : (a < b ? a : b);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, minT;
};

struct Hit {
  float t, u, v;
  int slot;  // c*K + k of the hit triangle, -1 for none
};

// Box and triangle tests of a walk (kernel-side counters of B2; B3/B4
// instantiate the walk without them).
struct Tests {
  unsigned box, tri;
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

// slab test of box b[0..5] over [minT, bt]
__device__ __forceinline__ bool slab(const float* __restrict__ b,
                                     const Ray& r, float bt) {
  float t0x = (b[0] - r.ox) * r.ix;
  float t1x = (b[3] - r.ox) * r.ix;
  float t0y = (b[1] - r.oy) * r.iy;
  float t1y = (b[4] - r.oy) * r.iy;
  float t0z = (b[2] - r.oz) * r.iz;
  float t1z = (b[5] - r.oz) * r.iz;
  float tin = jmax(jmax(jmin(t0x, t1x), jmin(t0y, t1y)),
                   jmax(jmin(t0z, t1z), r.minT));
  float tout = jmin(jmin(jmax(t0x, t1x), jmax(t0y, t1y)),
                    jmin(jmax(t0z, t1z), bt));
  return tin <= tout;
}

// slab test of sub-box s of a cluster: lo in row 2s, hi in row 2s+1,
// slots 13..15
__device__ __forceinline__ bool sub_slab(const float* __restrict__ rows,
                                         int s, const Ray& r, float bt) {
  const float* lo = rows + (2 * s) * ROW + 13;
  const float* hi = rows + (2 * s + 1) * ROW + 13;
  float t0x = (lo[0] - r.ox) * r.ix;
  float t1x = (hi[0] - r.ox) * r.ix;
  float t0y = (lo[1] - r.oy) * r.iy;
  float t1y = (hi[1] - r.oy) * r.iy;
  float t0z = (lo[2] - r.oz) * r.iz;
  float t1z = (hi[2] - r.oz) * r.iz;
  float tin = jmax(jmax(jmin(t0x, t1x), jmin(t0y, t1y)),
                   jmax(jmin(t0z, t1z), r.minT));
  float tout = jmin(jmin(jmax(t0x, t1x), jmax(t0y, t1y)),
                    jmin(jmax(t0z, t1z), bt));
  return tin <= tout;
}

// The 64-triangle leaf of cluster c; the ray is already live against the
// cluster box at its current t. Sub-box gates use the t at leaf entry; the
// triangle tests use the running t (strict <: the first of equal t wins).
// Returns true on an any-hit (t set to -inf).
template <bool kCount>
__device__ __forceinline__ bool leaf(const float* __restrict__ tri, int c,
                                     const Ray& r, Hit& h, bool any_hit,
                                     Tests& n) {
  const float* rows = tri + (size_t)c * (K * ROW);
  const float be = h.t;
  unsigned gate = 0;
#pragma unroll
  for (int s = 0; s < N_SUB; s++) gate |= (unsigned)sub_slab(rows, s, r, be) << s;
  if (kCount) {
    n.box += N_SUB;
    n.tri += SUB * __popc(gate);
  }
  for (int s = 0; s < N_SUB; s++) {
    if (!((gate >> s) & 1u)) continue;
#pragma unroll 4
    for (int k = s * SUB; k < (s + 1) * SUB; k++) {
      const float* q = rows + k * ROW;
      float nx = q[0], ny = q[1], nz = q[2], d0 = q[3];
      float m1x = q[4], m1y = q[5], m1z = q[6], c1 = q[7];
      float m2x = q[8], m2y = q[9], m2z = q[10], c2 = q[11];
      float ro_n = r.ox * nx + r.oy * ny + r.oz * nz;
      float rd_n = r.dx * nx + r.dy * ny + r.dz * nz;
      bool par = fabsf(rd_n) < 1e-22f;
      float t = (d0 - ro_n) / (par ? 1.0f : rd_n);
      float u = r.ox * m1x + r.oy * m1y + r.oz * m1z - c1
                + t * (r.dx * m1x + r.dy * m1y + r.dz * m1z);
      float v = r.ox * m2x + r.oy * m2y + r.oz * m2z - c2
                + t * (r.dx * m2x + r.dy * m2y + r.dz * m2z);
      bool hit = !par && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
                 t >= r.minT && t < h.t;
      if (hit) {
        if (any_hit) {
          h.t = -INFINITY;
          return true;
        }
        h.t = t;
        h.u = u;
        h.v = v;
        h.slot = c * K + k;
      }
    }
  }
  return false;
}

// Stackless skip-link walk of the binary cluster tree, n = live ? n + 1 :
// skip[n]. h holds maxT on entry and the best hit on exit (t = -inf for an
// any-hit).
template <bool kCount>
__device__ __forceinline__ void skip_walk(const float* __restrict__ aabb,
                                          const int* __restrict__ cid,
                                          const int* __restrict__ skip,
                                          const float* __restrict__ tri,
                                          int n_nodes, const Ray& r, Hit& h,
                                          bool any_hit, Tests& n) {
  int node = 0;
  while (node < n_nodes) {
    bool live = slab(aabb + (size_t)node * 8, r, h.t);
    if (kCount) n.box += 1;
    int c = cid[node];
    if (live && c >= 0 && leaf<kCount>(tri, c, r, h, any_hit, n)) break;
    node = live ? node + 1 : skip[node];
  }
}

}  // namespace cwalk
