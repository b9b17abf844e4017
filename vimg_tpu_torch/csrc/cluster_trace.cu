// Cluster-tree ray walks for Hopper (sm_90a): kernels B3 (wide 8-ary stack
// walk) and B4 (binary skip-link walk) of vimg_tpu_torch's ClusterTracer.
//
// Replaces: vimg_tpu/geometry/cluster_trace.py::_make_wide_kernel (B3,
// launched by _build_wide_fn) and ::_make_trace_kernel (B4, launched by
// _build_trace_fn). Both compute, per ray, the closest hit (or any hit)
// against the triangles of a mesh cut into 64-triangle clusters, walking
// the SAH tree restricted to the clusters.
//
// Design: one thread per ray, 128-thread blocks, every table in global
// memory behind const __restrict__ pointers. The TPU kernels walk a whole
// ray tile in lockstep (a node is visited if any lane of the tile touches
// it) because Mosaic has no per-lane gather; the tile union, row-group
// gates, VMEM residency and DMA streaming exist only for that. A GPU
// thread can load by index, so each thread walks its own ray. The result
// is bit-equal to the tile walk: child boxes are nested in their parents,
// the slab test is monotone in the box bounds and a ray's best t only
// shrinks, so the per-ray preorder walk tests exactly the (cluster,
// sub-box, triangle) candidates that the ray's lane tests in the tile
// walk, in the same order and with the same float32 arithmetic. The plain
// PyTorch versions (geometry/cluster_trace.py: wide_walk_plain,
// skip_walk_plain) mirror this file operation for operation; the file is
// built with -fmad=false and without fast math, so + - * / round alike.
// jmin/jmax propagate NaN like torch.minimum / jnp.minimum (fminf/fmaxf
// would drop it).
//
// Tables (flat row-major views of vimg_tpu's packed arrays):
//   wide boxes  [w*64 + c*8 + j]   child c of wide node w: lo xyz, hi xyz
//   wide refs   [w*8 + c]          >= 0 wide node, < 0 cluster -(cid+1),
//                                  EMPTY for an unused slot
//   cl boxes    [cid*8 + j]        cluster box
//   node aabbs  [n*8 + j]          binary node box
//   node cid    [n]                cluster id of a leaf node, -1 inner
//   node skip   [n]                preorder skip link
//   tri         [c*1024 + k*16 + j] plane n, d0, m1, c1, m2, c2 (j < 12);
//                                  rows 2s / 2s+1 hold the lo / hi of
//                                  16-tri sub-box s in slots 13..15
//
// What bounds it on this card: neither bytes nor flops. Each step loads a
// node that depends on the previous one (latency), and the rays of a warp
// take different paths (divergence). The tables of the 100k and 500k
// terrains (9 and 45 MB) fit the 50 MB L2. This first version does nothing
// beyond the caller's Morton ray sort (warp coherence); node caching in
// shared memory and warp-coherent traversal are later work.
//
// Launch contract: vimg_cluster_wide() / vimg_cluster_skip() launch on the
// given stream, do not synchronise and allocate nothing; they return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr int K = 64;           // triangles per cluster
constexpr int ROW = 16;         // floats per triangle row
constexpr int SUB = 16;         // triangles per sub-box gate
constexpr int N_SUB = K / SUB;
constexpr int FAN = 8;
constexpr int EMPTY = 0x3FFFFFFF;
constexpr int MAX_STACK = 128;  // geometry/cluster_trace.py WIDE_MAX_STACK

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
  int slot;
};

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
__device__ __forceinline__ bool leaf(const float* __restrict__ tri, int c,
                                     const Ray& r, Hit& h, bool any_hit) {
  const float* rows = tri + (size_t)c * (K * ROW);
  const float be = h.t;
  unsigned gate = 0;
#pragma unroll
  for (int s = 0; s < N_SUB; s++) gate |= (unsigned)sub_slab(rows, s, r, be) << s;
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

__device__ __forceinline__ bool load_ray(int i, const float* __restrict__ ro,
                                         const float* __restrict__ rd,
                                         const float* __restrict__ minT,
                                         const float* __restrict__ maxT,
                                         bool any_hit, Ray& r, Hit& h) {
  r.ox = ro[3 * i + 0];
  r.oy = ro[3 * i + 1];
  r.oz = ro[3 * i + 2];
  r.dx = rd[3 * i + 0];
  r.dy = rd[3 * i + 1];
  r.dz = rd[3 * i + 2];
  r.ix = 1.0f / (r.dx == 0.0f ? 1e-30f : r.dx);
  r.iy = 1.0f / (r.dy == 0.0f ? 1e-30f : r.dy);
  r.iz = 1.0f / (r.dz == 0.0f ? 1e-30f : r.dz);
  r.minT = minT[i];
  h.t = maxT[i];
  h.u = 0.0f;
  h.v = 0.0f;
  h.slot = -1;
  // maxT = -inf keeps no node live (tin >= minT > -inf): leave at once
  if (any_hit) return h.t != -INFINITY;
  return !(h.t == -INFINITY && r.minT != -INFINITY);
}

__device__ __forceinline__ void store(int i, const Hit& h, float* t_out,
                                      int* slot_out, float* u_out,
                                      float* v_out) {
  t_out[i] = h.t;
  slot_out[i] = h.slot;
  u_out[i] = h.u;
  v_out[i] = h.v;
}

// B3: 8-ary stack walk
__global__ void __launch_bounds__(BLOCK)
    cluster_wide_kernel(const float* __restrict__ wbox,
                        const int* __restrict__ wref,
                        const float* __restrict__ clbox,
                        const float* __restrict__ tri,
                        const float* __restrict__ ro,
                        const float* __restrict__ rd,
                        const float* __restrict__ minT,
                        const float* __restrict__ maxT, int n_rays,
                        int any_hit, float* __restrict__ t_out,
                        int* __restrict__ slot_out, float* __restrict__ u_out,
                        float* __restrict__ v_out) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n_rays) return;
  Ray r;
  Hit h;
  if (load_ray(i, ro, rd, minT, maxT, any_hit, r, h)) {
    int stack[MAX_STACK];
    int sp = 0;
    stack[sp++] = 0;  // the root wide node
    while (sp > 0) {
      int ref = stack[--sp];
      if (ref < 0) {
        int c = -ref - 1;
        if (slab(clbox + (size_t)c * 8, r, h.t) && leaf(tri, c, r, h, any_hit))
          break;
      } else {
        const float* b = wbox + (size_t)ref * (FAN * 8);
        const int* kids = wref + (size_t)ref * FAN;
        // push live children in reverse: child 0 is popped first
#pragma unroll
        for (int ci = FAN - 1; ci >= 0; ci--) {
          int kid = kids[ci];
          if (kid != EMPTY && slab(b + ci * 8, r, h.t)) stack[sp++] = kid;
        }
      }
    }
  }
  store(i, h, t_out, slot_out, u_out, v_out);
}

// B4: stackless skip-link walk, n = live ? n + 1 : skip[n]
__global__ void __launch_bounds__(BLOCK)
    cluster_skip_kernel(const float* __restrict__ aabb,
                        const int* __restrict__ cid,
                        const int* __restrict__ skip,
                        const float* __restrict__ tri,
                        const float* __restrict__ ro,
                        const float* __restrict__ rd,
                        const float* __restrict__ minT,
                        const float* __restrict__ maxT, int n_rays,
                        int n_nodes, int any_hit, float* __restrict__ t_out,
                        int* __restrict__ slot_out, float* __restrict__ u_out,
                        float* __restrict__ v_out) {
  int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n_rays) return;
  Ray r;
  Hit h;
  if (load_ray(i, ro, rd, minT, maxT, any_hit, r, h)) {
    int n = 0;
    while (n < n_nodes) {
      bool live = slab(aabb + (size_t)n * 8, r, h.t);
      int c = cid[n];
      if (live && c >= 0 && leaf(tri, c, r, h, any_hit)) break;
      n = live ? n + 1 : skip[n];
    }
  }
  store(i, h, t_out, slot_out, u_out, v_out);
}

}  // namespace

extern "C" int vimg_cluster_wide(const float* wbox, const int* wref,
                                 const float* clbox, const float* tri,
                                 const float* ro, const float* rd,
                                 const float* minT, const float* maxT,
                                 int n_rays, int n_wide, int any_hit,
                                 float* t_out, int* slot_out, float* u_out,
                                 float* v_out, void* stream) {
  (void)n_wide;  // the refs bound the walk; checked by the wrapper
  int blocks = (n_rays + BLOCK - 1) / BLOCK;
  cluster_wide_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      wbox, wref, clbox, tri, ro, rd, minT, maxT, n_rays, any_hit, t_out,
      slot_out, u_out, v_out);
  return (int)cudaGetLastError();
}

extern "C" int vimg_cluster_skip(const float* aabb, const int* cid,
                                 const int* skip, const float* tri,
                                 const float* ro, const float* rd,
                                 const float* minT, const float* maxT,
                                 int n_rays, int n_nodes, int any_hit,
                                 float* t_out, int* slot_out, float* u_out,
                                 float* v_out, void* stream) {
  int blocks = (n_rays + BLOCK - 1) / BLOCK;
  cluster_skip_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      aabb, cid, skip, tri, ro, rd, minT, maxT, n_rays, n_nodes, any_hit,
      t_out, slot_out, u_out, v_out);
  return (int)cudaGetLastError();
}
