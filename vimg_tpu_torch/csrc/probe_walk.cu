// Walk-cost probe for Hopper (sm_90a): kernel P1 of vimg_tpu_torch's
// probes (probes/probe_walkablate.py).
//
// Replaces: tools/probe_walkablate.py::make_kernel (its pallas_call at
// :204). The skip-link walk of the binary cluster tree (n = any_live ? n + 1
// : skip[n]) with a closest-hit test of the 64 triangles of a live leaf, in
// five variants that take the walk apart:
//   full        the walk (slab test, leaf branch, triangle tests)
//   no_tri      the leaf branch kept, the triangle tests emptied
//   no_cond     no leaf branch: slab test and skip advance only
//   lean_carry  no_cond with the loop state cut to (n, bt, visits)
//   no_slab     lean_carry with the slab test replaced by one compare
// Outputs: bt per ray and the visit count per group.
//
// Design: one thread per ray, 128-thread blocks. The TPU walks a tile of
// tile_rows x 128 rays in lockstep: a node is visited when any ray of the
// tile is live in it. Here the group that advances together is a template
// parameter: a warp (kWarp, __any_sync on live: the tile's rule at warp
// width) or one thread (its own free walk, B4's schedule). bt does not
// depend on the group (a ray that is not live is masked out of the tests);
// the visit count does.
//
// The arithmetic is the probe's, operation for operation: the slab as
// b * inv - o * inv, t0/t1 min/max in the probe's nesting, ((ox*nx + oy*ny)
// + oz*nz), u and v as ((... - c1) + t * (...)), IEEE division for t,
// strict t < bt; the file is built with -fmad=false and without fast math.
// jmin/jmax propagate NaN like jnp.minimum / jnp.maximum. The plain version
// is probes/probe_walkablate.py::walkablate_plain.
//
// On the card the compiler drops an empty branch and every loop-carried
// value that reaches no output, so no_tri, no_cond and lean_carry compile
// to the same loop; the TPU's cond and carry costs have no counterpart.
//
// What bounds it on this card: the latency of the dependent node loads and
// the warp's divergence (group 1) or its lockstep visits (group 32), not
// bytes or flops.
//
// Launch contract: vimg_probe_walk() launches on the given stream, does not
// synchronise and allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;
constexpr int K = 64;        // triangles per cluster (ClusterData max_k)
constexpr int ROW = 16;      // floats per triangle row
constexpr int SUB = 16;      // triangles per gated sub-loop
enum Variant { FULL, NO_TRI, NO_COND, LEAN_CARRY, NO_SLAB };

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fffffff); }
__device__ __forceinline__ bool isnan_(float a) { return a != a; }
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan_(a) || isnan_(b)) ? qnan() : (a > b ? a : b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan_(a) || isnan_(b)) ? qnan() : (a < b ? a : b);
}

// the probe's test16 sub-loops over the 64 slots of a live leaf: each
// gated again by the group's any_live, a hit also needs the ray's own live
__device__ __forceinline__ void leaf(const float* __restrict__ rows, float ox,
                                     float oy, float oz, float dx, float dy,
                                     float dz, float minT, bool live,
                                     bool any_live, float& bt) {
  for (int s = 0; s < K / SUB; s++) {
    if (!any_live) continue;
#pragma unroll 4
    for (int k = s * SUB; k < (s + 1) * SUB; k++) {
      const float* q = rows + k * ROW;
      const float nx = q[0], ny = q[1], nz = q[2], d0 = q[3];
      const float m1x = q[4], m1y = q[5], m1z = q[6], c1 = q[7];
      const float m2x = q[8], m2y = q[9], m2z = q[10], c2 = q[11];
      const float ro_n = ox * nx + oy * ny + oz * nz;
      const float rd_n = dx * nx + dy * ny + dz * nz;
      const bool par = fabsf(rd_n) < 1e-22f;
      const float t = (d0 - ro_n) / (par ? 1.0f : rd_n);
      const float u = ox * m1x + oy * m1y + oz * m1z - c1
                      + t * (dx * m1x + dy * m1y + dz * m1z);
      const float v = ox * m2x + oy * m2y + oz * m2z - c2
                      + t * (dx * m2x + dy * m2y + dz * m2z);
      if (!par && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t >= minT &&
          t < bt && live)
        bt = t;
    }
  }
}

template <int V, bool kWarp>
__global__ void __launch_bounds__(BLOCK)
    walk_kernel(const float* __restrict__ aabb, const int* __restrict__ cid_t,
                const int* __restrict__ skip_t, const float* __restrict__ tri,
                int n_nodes, const float* __restrict__ ro,
                const float* __restrict__ rd, const float* __restrict__ tmin,
                const float* __restrict__ tmax, int n_rays,
                float* __restrict__ bt_out, int* __restrict__ nv_out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  // with kWarp, n_rays is a multiple of 32: a warp leaves whole
  if (i >= n_rays) return;
  const float ox = ro[3 * i + 0], oy = ro[3 * i + 1], oz = ro[3 * i + 2];
  const float dx = rd[3 * i + 0], dy = rd[3 * i + 1], dz = rd[3 * i + 2];
  const float minT = tmin[i];
  const float idx = 1.0f / (dx == 0.0f ? 1e-30f : dx);
  const float idy = 1.0f / (dy == 0.0f ? 1e-30f : dy);
  const float idz = 1.0f / (dz == 0.0f ? 1e-30f : dz);
  const float oix = ox * idx, oiy = oy * idy, oiz = oz * idz;
  float bt = tmax[i];
  int nv = 0;
  int n = 0;
  while (n < n_nodes) {
    const int cid = cid_t[n];
    const int c = max(cid, 0);
    const float* b = aabb + (size_t)n * 8;
    bool live;
    if (V == NO_SLAB) {
      live = (bt + b[0]) > 0.0f;
    } else {
      const float t0x = b[0] * idx - oix, t1x = b[3] * idx - oix;
      const float t0y = b[1] * idy - oiy, t1y = b[4] * idy - oiy;
      const float t0z = b[2] * idz - oiz, t1z = b[5] * idz - oiz;
      const float tin = jmax(jmax(jmin(t0x, t1x), jmin(t0y, t1y)),
                             jmax(jmin(t0z, t1z), minT));
      const float tout = jmin(jmin(jmax(t0x, t1x), jmax(t0y, t1y)),
                              jmin(jmax(t0z, t1z), bt));
      live = tin <= tout;
    }
    const bool any_live = kWarp ? __any_sync(0xffffffffu, live) : live;
    nv += 1;
    // no_tri's leaf branch, its test bodies emptied, compiles to nothing
    if constexpr (V == FULL) {
      if (any_live && cid >= 0) leaf(tri + (size_t)c * (K * ROW), ox, oy, oz,
                                     dx, dy, dz, minT, live, any_live, bt);
    }
    n = any_live ? n + 1 : skip_t[n];
  }
  bt_out[i] = bt;
  if (!kWarp)
    nv_out[i] = nv;
  else if ((threadIdx.x & 31) == 0)
    nv_out[i >> 5] = nv;
}

template <int V>
int launch(bool warp, int blocks, cudaStream_t s, const float* aabb,
           const int* cid, const int* skip, const float* tri, int n_nodes,
           const float* ro, const float* rd, const float* tmin,
           const float* tmax, int n_rays, float* bt, int* nv) {
  if (warp)
    walk_kernel<V, true><<<blocks, BLOCK, 0, s>>>(
        aabb, cid, skip, tri, n_nodes, ro, rd, tmin, tmax, n_rays, bt, nv);
  else
    walk_kernel<V, false><<<blocks, BLOCK, 0, s>>>(
        aabb, cid, skip, tri, n_nodes, ro, rd, tmin, tmax, n_rays, bt, nv);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 full, 1 no_tri, 2 no_cond, 3 lean_carry, 4 no_slab; group: 1
// or 32 (n_rays a multiple of 32). nv holds n_rays / group counts.
extern "C" int vimg_probe_walk(const float* aabb, const int* cid,
                               const int* skip, const float* tri,
                               int n_nodes, const float* ro, const float* rd,
                               const float* tmin, const float* tmax,
                               int n_rays, int variant, int group, float* bt,
                               int* nv, void* stream) {
  if ((group != 1 && group != 32) || (group == 32 && n_rays % 32) ||
      variant < 0 || variant > 4)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + BLOCK - 1) / BLOCK;
  const bool w = group == 32;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case FULL:
      return launch<FULL>(w, blocks, s, aabb, cid, skip, tri, n_nodes, ro, rd,
                          tmin, tmax, n_rays, bt, nv);
    case NO_TRI:
      return launch<NO_TRI>(w, blocks, s, aabb, cid, skip, tri, n_nodes, ro,
                            rd, tmin, tmax, n_rays, bt, nv);
    case NO_COND:
      return launch<NO_COND>(w, blocks, s, aabb, cid, skip, tri, n_nodes, ro,
                             rd, tmin, tmax, n_rays, bt, nv);
    case LEAN_CARRY:
      return launch<LEAN_CARRY>(w, blocks, s, aabb, cid, skip, tri, n_nodes,
                                ro, rd, tmin, tmax, n_rays, bt, nv);
    default:
      return launch<NO_SLAB>(w, blocks, s, aabb, cid, skip, tri, n_nodes, ro,
                             rd, tmin, tmax, n_rays, bt, nv);
  }
}
