// Cluster-tree ray walks for Hopper (sm_90a): kernels B3 (wide 8-ary stack
// walk) and B4 (binary skip-link walk) of vimg_tpu_torch's ClusterTracer.
//
// Replaces: vimg_tpu/geometry/cluster_trace.py::_make_wide_kernel (B3,
// launched by _build_wide_fn) and ::_make_trace_kernel (B4, launched by
// _build_trace_fn). Both compute, per ray, the closest hit (or any hit)
// against the triangles of a mesh cut into 64-triangle clusters, walking
// the SAH tree restricted to the clusters.
//
// Design. Both walks are warp-cooperative (cluster_walk.cuh): each lane
// walks its own ray's nodes, B3 with a per-lane stack of 8-ary node refs,
// B4 stacklessly over the binary tree, until it reaches a live cluster and
// posts it; the whole warp then runs the posted clusters of all its lanes
// together, 32 triangles a step (cwalk::leaf_round), and every lane goes
// on with its nodes. Node boxes and triangle rows are read 16 bytes at a
// time, every table stays in global memory. The TPU kernels walk a whole
// ray tile in lockstep (a node is visited if any lane of the tile touches
// it) because Mosaic has no per-lane gather; the tile union, row-group
// gates, VMEM residency and DMA streaming exist only for that. A GPU
// thread can load by index, so each lane walks its own ray. The result is bit-equal to the tile walk: child
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
// the slab tests, the leaf round and the skip walk shared with the
// mesh-mode megakernel B2):
//   wide boxes  [w*64 + c*8 + j]   child c of wide node w: lo xyz, hi xyz
//   wide refs   [w*8 + c]          >= 0 wide node, < 0 cluster -(cid+1),
//                                  EMPTY for an unused slot
//   cl boxes    [cid*8 + j]        cluster box
//
// What bounds it on this card: neither bytes nor flops. Each node step
// loads a node that depends on the previous one (latency), and the rays of
// a warp take different paths (divergence): a round's node phase lasts as
// long as its longest lane. The leaf, up to 64 sequential triangle tests
// in one lane while the warp waited in the first design, runs a warp's
// posted clusters 32 triangles a step (geometry/skip_schedule.py replays
// both schedules of both walks and counts their warp steps). B3's node
// phase then set its pace, so B3 reads a wide node's 8 child boxes and
// refs as 16-byte rows and takes min / max in one instruction each
// (wide_slab). The tables of the 100k and 500k terrains (9 and 45 MB)
// fit the 50 MB L2.
//
// Launch contract: vimg_cluster_wide() / vimg_cluster_skip() launch on the
// given stream, do not synchronise and allocate nothing; they return
// cudaGetLastError(). Each adds its warp node and triangle steps to
// steps[0] and steps[1] when steps is not null, and writes warp w's to
// warp_steps[2w] and warp_steps[2w + 1] (w < ceil(n_rays / 32)) when
// warp_steps is not null (ClusterTracer.trace_stats); the launch without
// either counter is the uncounted kernel. The totals are the column sums of
// the per-warp rows; the (2,) counter stays because it is the interface
// that earlier checkouts of the port share (compare_parent.py reads the
// steps of this and an earlier checkout through the same call, and the card
// tests and chip_smoke.py's phase 6 use it), and because it accumulates
// across launches in a counter of fixed size.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_walk.cuh"

namespace {

using cwalk::Hit;
using cwalk::Ray;
using cwalk::Tests;

constexpr int BLOCK = 128;
static_assert(BLOCK == 32 * cwalk::WALK_WARPS, "the warp scratch");
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

// The ray of lane i, or a lane that takes part without one (past n_rays);
// returns whether the lane walks
__device__ __forceinline__ bool lane_ray(int i, int n_rays,
                                         const float* __restrict__ ro,
                                         const float* __restrict__ rd,
                                         const float* __restrict__ minT,
                                         const float* __restrict__ maxT,
                                         bool any_hit, Ray& r, Hit& h) {
  if (i < n_rays) return load_ray(i, ro, rd, minT, maxT, any_hit, r, h);
  r = cwalk::make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f, 0.0f);
  h.t = -INFINITY;
  return false;
}

__device__ __forceinline__ void add_steps(const cwalk::Steps& steps,
                                          unsigned long long* steps_out,
                                          unsigned long long* warp_out) {
  if ((threadIdx.x & 31) == 0) {
    if (steps_out != nullptr) {
      atomicAdd(steps_out, (unsigned long long)steps.node);
      atomicAdd(steps_out + 1, (unsigned long long)steps.tri);
    }
    if (warp_out != nullptr) {
      const size_t w = ((size_t)blockIdx.x * BLOCK + threadIdx.x) >> 5;
      warp_out[2 * w] = steps.node;
      warp_out[2 * w + 1] = steps.tri;
    }
  }
}

// B3's slab test of a wide child or cluster box (lo xyz, hi xyz at b[0..5],
// the row 16-byte aligned): cwalk::slab6's arithmetic, with min / max that
// return NaN when either input is NaN in one instruction each
// (cwalk::nmin / nmax) where jmin / jmax take three. Only the comparison
// tin <= tout leaves it, so a NaN's bits and the sign of a zero do not
// matter: the result is slab6's.
using cwalk::nmax;
using cwalk::nmin;
__device__ __forceinline__ bool wide_slab(const float* __restrict__ b,
                                          const Ray& r, float bt) {
  const float4 p = cwalk::ldg4(b), q = cwalk::ldg4(b + 4);
  const float t0x = (p.x - r.ox) * r.ix;
  const float t1x = (p.w - r.ox) * r.ix;
  const float t0y = (p.y - r.oy) * r.iy;
  const float t1y = (q.x - r.oy) * r.iy;
  const float t0z = (p.z - r.oz) * r.iz;
  const float t1z = (q.y - r.oz) * r.iz;
  const float tin = nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)),
                         nmax(nmin(t0z, t1z), r.minT));
  const float tout = nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)),
                          nmin(nmax(t0z, t1z), bt));
  return tin <= tout;
}

// B3: the 8-ary stack walk on the warp's leaf round. A round's node phase:
// pop a ref; a wide node slab-tests its children at the current t and
// pushes the live, non-EMPTY ones in reverse (child 0 is popped first); a
// cluster ref is slab-tested against its cluster box at the current t and,
// if live, posted. Then the warp runs the posted clusters
// (cwalk::leaf_round); an any-hit owner empties its stack. Every lane of a
// warp with a ray takes part; lanes past n_rays and rays that do not walk
// take part without a ray. kSteps: count the warp steps into
// steps_out[0..1] and / or warp_out (node steps: pops).
template <bool kSteps>
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
                        float* __restrict__ v_out,
                        unsigned long long* __restrict__ steps_out,
                        unsigned long long* __restrict__ warp_out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i - (int)(threadIdx.x & 31) >= n_rays) return;  // the whole warp
  Ray r;
  Hit h;
  const bool go = lane_ray(i, n_rays, ro, rd, minT, maxT, any_hit, r, h);
  Tests none = {0u, 0u};
  cwalk::Steps steps = {0u, 0u};
  int stack[MAX_STACK];
  int sp = 0;
  if (go) stack[sp++] = 0;  // the root wide node
  for (;;) {
    // ---- node phase ----
    int c = -1;
    unsigned it = 0;
    while (sp > 0) {
      const int ref = stack[--sp];
      ++it;
      if (ref < 0) {
        const int cc = -ref - 1;
        if (wide_slab(clbox + (size_t)cc * 8, r, h.t)) {
          c = cc;
          break;
        }
      } else {
        const float* b = wbox + (size_t)ref * (FAN * 8);
        const int4* k4 = reinterpret_cast<const int4*>(wref) + 2 * ref;
        const int4 ka = __ldg(k4), kb = __ldg(k4 + 1);
        const int kids[FAN] = {ka.x, ka.y, ka.z, ka.w, kb.x, kb.y, kb.z, kb.w};
#pragma unroll
        for (int ci = FAN - 1; ci >= 0; ci--) {
          if (kids[ci] != EMPTY && wide_slab(b + ci * 8, r, h.t))
            stack[sp++] = kids[ci];
        }
      }
    }
    cwalk::count_node_steps<kSteps>(it, steps);
    bool stop = false;
    if (!cwalk::leaf_round<false, kSteps>(tri, c, r, h, any_hit, none, steps,
                                          stop))
      break;
    if (stop) sp = 0;
  }
  if (i < n_rays) store(i, h, t_out, slot_out, u_out, v_out);
  if (kSteps) add_steps(steps, steps_out, warp_out);
}

// B4: stackless skip-link walk, n = live ? n + 1 : skip[n], its leaves run
// by the warp (cwalk::warp_skip_walk). Every lane of a warp with a ray
// takes part; lanes past n_rays and rays that do not walk take part
// without a ray. kSteps: count the warp steps into steps_out[0..1] and / or
// warp_out.
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
                        unsigned long long* __restrict__ steps_out,
                        unsigned long long* __restrict__ warp_out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i - (int)(threadIdx.x & 31) >= n_rays) return;  // the whole warp
  Ray r;
  Hit h;
  const bool go = lane_ray(i, n_rays, ro, rd, minT, maxT, any_hit, r, h);
  Tests none = {0u, 0u};
  cwalk::Steps steps = {0u, 0u};
  cwalk::warp_skip_walk<false, kSteps>(aabb, cid, skip, tri, n_nodes, r, h,
                                       any_hit, go, none, steps);
  if (i < n_rays) store(i, h, t_out, slot_out, u_out, v_out);
  if (kSteps) add_steps(steps, steps_out, warp_out);
}

}  // namespace

extern "C" int vimg_cluster_wide(const float* wbox, const int* wref,
                                 const float* clbox, const float* tri,
                                 const float* ro, const float* rd,
                                 const float* minT, const float* maxT,
                                 int n_rays, int n_wide, int any_hit,
                                 float* t_out, int* slot_out, float* u_out,
                                 float* v_out, unsigned long long* steps,
                                 unsigned long long* warp_steps,
                                 void* stream) {
  (void)n_wide;  // the refs bound the walk; checked by the wrapper
  int blocks = (n_rays + BLOCK - 1) / BLOCK;
  if (steps != nullptr || warp_steps != nullptr)
    cluster_wide_kernel<true><<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        wbox, wref, clbox, tri, ro, rd, minT, maxT, n_rays, any_hit, t_out,
        slot_out, u_out, v_out, steps, warp_steps);
  else
    cluster_wide_kernel<false><<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        wbox, wref, clbox, tri, ro, rd, minT, maxT, n_rays, any_hit, t_out,
        slot_out, u_out, v_out, steps, warp_steps);
  return (int)cudaGetLastError();
}

extern "C" int vimg_cluster_skip(const float* aabb, const int* cid,
                                 const int* skip, const float* tri,
                                 const float* ro, const float* rd,
                                 const float* minT, const float* maxT,
                                 int n_rays, int n_nodes, int any_hit,
                                 float* t_out, int* slot_out, float* u_out,
                                 float* v_out, unsigned long long* steps,
                                 unsigned long long* warp_steps,
                                 void* stream) {
  int blocks = (n_rays + BLOCK - 1) / BLOCK;
  if (steps != nullptr || warp_steps != nullptr)
    cluster_skip_kernel<true><<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        aabb, cid, skip, tri, ro, rd, minT, maxT, n_rays, n_nodes, any_hit,
        t_out, slot_out, u_out, v_out, steps, warp_steps);
  else
    cluster_skip_kernel<false><<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
        aabb, cid, skip, tri, ro, rd, minT, maxT, n_rays, n_nodes, any_hit,
        t_out, slot_out, u_out, v_out, steps, warp_steps);
  return (int)cudaGetLastError();
}
