// Cluster-tree ray walks for Hopper (sm_90a): kernels B3 (wide 8-ary stack
// walk) and B4 (binary skip-link walk) of vimg_tpu_torch's ClusterTracer.
//
// Replaces: vimg_tpu/geometry/cluster_trace.py::_make_wide_kernel (B3,
// launched by _build_wide_fn) and ::_make_trace_kernel (B4, launched by
// _build_trace_fn). Both compute, per ray, the closest hit (or any hit)
// against the triangles of a mesh cut into 64-triangle clusters, walking
// the SAH tree restricted to the clusters.
//
// Design. B3: one thread per ray, 128-thread blocks, every table in global
// memory behind const __restrict__ pointers; the lane walks its own nodes
// and scans its own leaves (cwalk::lane_leaf). B4: the warp-cooperative
// walk of cluster_walk.cuh: nodes per lane as in B3, the leaves of a
// warp's lanes run by the whole warp, 16-byte loads of node boxes and
// triangle rows. The TPU kernels walk a whole ray tile in lockstep (a node
// is visited if any lane of the tile touches it) because Mosaic has no
// per-lane gather; the tile union, row-group gates, VMEM residency and DMA
// streaming exist only for that. A GPU thread can load by index, so each
// lane walks its own ray. The result is bit-equal to the tile walk: child
// boxes are nested in their parents, the slab test is monotone in the box
// bounds and a ray's best t only shrinks, so the per-ray preorder walk
// tests exactly the (cluster, sub-box, triangle) candidates that the ray's
// lane tests in the tile walk, in the same order and with the same float32
// arithmetic. The plain PyTorch versions (geometry/cluster_trace.py:
// wide_walk_plain, skip_walk_plain) mirror this file operation for
// operation; the file is built with -fmad=false and without fast math, so
// + - * / round alike. jmin/jmax propagate NaN like torch.minimum /
// jnp.minimum (fminf/fmaxf would drop it).
//
// Tables (flat row-major views of vimg_tpu's packed arrays; the binary
// tree and triangle tables are described in cluster_walk.cuh, which holds
// the slab tests, the leaf and the skip walk shared with the mesh-mode
// megakernel B2):
//   wide boxes  [w*64 + c*8 + j]   child c of wide node w: lo xyz, hi xyz
//   wide refs   [w*8 + c]          >= 0 wide node, < 0 cluster -(cid+1),
//                                  EMPTY for an unused slot
//   cl boxes    [cid*8 + j]        cluster box
//
// What bounds it on this card: neither bytes nor flops. Each node step
// loads a node that depends on the previous one (latency), and the rays of
// a warp take different paths (divergence). In B3 a lane's leaf is up to 64
// sequential triangle tests while the warp's other lanes wait; B4 runs a
// warp's leaves 32 triangles a step (geometry/skip_schedule.py replays
// both schedules and counts their warp steps). The tables of the 100k and
// 500k terrains (9 and 45 MB) fit the 50 MB L2.
//
// Launch contract: vimg_cluster_wide() / vimg_cluster_skip() launch on the
// given stream, do not synchronise and allocate nothing; they return
// cudaGetLastError(). vimg_cluster_skip() adds B4's warp node and triangle
// steps to steps[0] and steps[1] when steps is not null.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_walk.cuh"

namespace {

using cwalk::Hit;
using cwalk::Ray;
using cwalk::Tests;
using cwalk::slab;

constexpr int BLOCK = 128;
static_assert(BLOCK == 32 * cwalk::WALK_WARPS, "B4's warp scratch");
constexpr int FAN = 8;
constexpr int EMPTY = 0x3FFFFFFF;
constexpr int MAX_STACK = 128;  // geometry/cluster_trace.py WIDE_MAX_STACK

__device__ __forceinline__ bool load_ray(int i, const float* __restrict__ ro,
                                         const float* __restrict__ rd,
                                         const float* __restrict__ minT,
                                         const float* __restrict__ maxT,
                                         bool any_hit, Ray& r, Hit& h) {
  r = cwalk::make_ray(ro[3 * i + 0], ro[3 * i + 1], ro[3 * i + 2],
                      rd[3 * i + 0], rd[3 * i + 1], rd[3 * i + 2], minT[i]);
  h.t = maxT[i];
  h.u = 0.0f;
  h.v = 0.0f;
  h.slot = -1;
  return cwalk::walks(r, h.t, any_hit);
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
    Tests none = {0u, 0u};
    int stack[MAX_STACK];
    int sp = 0;
    stack[sp++] = 0;  // the root wide node
    while (sp > 0) {
      int ref = stack[--sp];
      if (ref < 0) {
        int c = -ref - 1;
        if (slab(clbox + (size_t)c * 8, r, h.t) &&
            cwalk::lane_leaf<false>(tri, c, r, h, any_hit, none))
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

// B4: stackless skip-link walk, n = live ? n + 1 : skip[n], its leaves run
// by the warp (cwalk::warp_skip_walk). Every lane of a warp with a ray
// takes part; lanes past n_rays and rays that do not walk take part
// without a ray. kSteps: count the warp steps into steps_out[0..1].
template <bool kSteps>
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
                        float* __restrict__ v_out,
                        unsigned long long* __restrict__ steps_out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i - (int)(threadIdx.x & 31) >= n_rays) return;  // the whole warp
  const bool in = i < n_rays;
  Ray r;
  Hit h;
  bool go = false;
  if (in) {
    go = load_ray(i, ro, rd, minT, maxT, any_hit, r, h);
  } else {
    r = cwalk::make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 0.0f);
    h.t = -INFINITY;
  }
  Tests none = {0u, 0u};
  cwalk::Steps steps = {0u, 0u};
  cwalk::warp_skip_walk<false, kSteps>(aabb, cid, skip, tri, n_nodes, r, h,
                                       any_hit, go, none, steps);
  if (in) store(i, h, t_out, slot_out, u_out, v_out);
  if (kSteps && (threadIdx.x & 31) == 0) {
    atomicAdd(steps_out, (unsigned long long)steps.node);
    atomicAdd(steps_out + 1, (unsigned long long)steps.tri);
  }
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
                                 float* v_out, unsigned long long* steps,
                                 void* stream) {
  int blocks = (n_rays + BLOCK - 1) / BLOCK;
  if (steps != nullptr)
    cluster_skip_kernel<true><<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        aabb, cid, skip, tri, ro, rd, minT, maxT, n_rays, n_nodes, any_hit,
        t_out, slot_out, u_out, v_out, steps);
  else
    cluster_skip_kernel<false><<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        aabb, cid, skip, tri, ro, rd, minT, maxT, n_rays, n_nodes, any_hit,
        t_out, slot_out, u_out, v_out, steps);
  return (int)cudaGetLastError();
}
