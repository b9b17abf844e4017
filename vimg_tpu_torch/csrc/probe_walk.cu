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
// The full walk's leaves run on the warp's leaf round of B4 and B2
// (cluster_walk.cuh, leaf_round, without its sub-box gates: the probe
// tests all 64 triangles of a leaf): the lanes that reach a live leaf post
// it, and the warp tests the posted (lane, leaf) pairs together, 32
// triangles a step, hits merged by least (t, k). Only live lanes' tests
// run; before, every lane of a warp ran the 64 tests of any leaf that some
// lane reached, one triangle at a time. At group 1 a round is B4's: each
// lane walks its own nodes until it posts a live leaf or ends; at group 32
// the warp's node is one, and a live leaf is a round of its live lanes.
// A lane with a posted leaf waits for the round before its next node, so
// every node sees the bt the plain walk gives it: bt and the visits are
// the plain walk's. The node boxes are two 16-byte loads, min and max one
// instruction each (cwalk::nmin / nmax, PTX min.NaN / max.NaN).
//
// The arithmetic is the probe's, operation for operation: the slab as
// b * inv - o * inv, t0/t1 min/max in the probe's nesting, ((ox*nx + oy*ny)
// + oz*nz), u and v as ((... - c1) + t * (...)), IEEE division for t,
// strict t < bt (cwalk::tri_test is the same expression); the file is
// built with -fmad=false and without fast math. nmin/nmax propagate NaN
// like jnp.minimum / jnp.maximum. The plain version is
// probes/probe_walkablate.py::walkablate_plain; the full walk's warp
// schedule is replayed by walk_schedule there.
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
// synchronise and allocates nothing; it returns cudaGetLastError(). With
// steps (device uint64[2], the full walk only) not null it adds the full
// walk's warp node and triangle steps to steps[0] and steps[1].

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_walk.cuh"

namespace {

constexpr int BLOCK = 32 * cwalk::WALK_WARPS;
constexpr unsigned FULL = 0xffffffffu;
enum Variant { FULL_WALK, NO_TRI, NO_COND, LEAN_CARRY, NO_SLAB };

// The probe's slab test of node n: b * inv - o * inv per plane (oi = o *
// inv), tin / tout in its nesting
__device__ __forceinline__ bool live_at(const float* __restrict__ aabb,
                                        int n, const cwalk::Ray& r,
                                        float oix, float oiy, float oiz,
                                        float bt) {
  using cwalk::nmax;
  using cwalk::nmin;
  const float4 a = cwalk::ldg4(aabb + (size_t)n * 8);
  const float4 b = cwalk::ldg4(aabb + (size_t)n * 8 + 4);
  const float t0x = a.x * r.ix - oix, t1x = a.w * r.ix - oix;
  const float t0y = a.y * r.iy - oiy, t1y = b.x * r.iy - oiy;
  const float t0z = a.z * r.iz - oiz, t1z = b.y * r.iz - oiz;
  const float tin = nmax(nmax(nmin(t0x, t1x), nmin(t0y, t1y)),
                         nmax(nmin(t0z, t1z), r.minT));
  const float tout = nmin(nmin(nmax(t0x, t1x), nmax(t0y, t1y)),
                          nmin(nmax(t0z, t1z), bt));
  return tin <= tout;
}

template <int V, bool kWarp, bool kSteps>
__global__ void __launch_bounds__(BLOCK)
    walk_kernel(const float* __restrict__ aabb, const int* __restrict__ cid_t,
                const int* __restrict__ skip_t, const float* __restrict__ tri,
                int n_nodes, const float* __restrict__ ro,
                const float* __restrict__ rd, const float* __restrict__ tmin,
                const float* __restrict__ tmax, int n_rays,
                float* __restrict__ bt_out, int* __restrict__ nv_out,
                unsigned long long* __restrict__ steps_out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  // the full walk's leaf rounds at group 1 need every lane of the warp: a
  // lane past the rays takes part without one (with kWarp, n_rays is a
  // multiple of 32, so a warp is past the rays as a whole)
  const bool go = i < n_rays;
  if (!go && (V != FULL_WALK || kWarp)) return;
  cwalk::Ray r = cwalk::make_ray(
      go ? ro[3 * i + 0] : 0.0f, go ? ro[3 * i + 1] : 0.0f,
      go ? ro[3 * i + 2] : 0.0f, go ? rd[3 * i + 0] : 1.0f,
      go ? rd[3 * i + 1] : 1.0f, go ? rd[3 * i + 2] : 1.0f,
      go ? tmin[i] : 0.0f);
  const float oix = r.ox * r.ix, oiy = r.oy * r.iy, oiz = r.oz * r.iz;
  cwalk::Hit h = {go ? tmax[i] : 0.0f, 0.0f, 0.0f, -1};
  cwalk::Tests none = {0u, 0u};
  cwalk::Steps steps = {0u, 0u};
  int nv = 0;
  if constexpr (V == FULL_WALK && !kWarp) {
    // rounds: each lane walks until it posts a live leaf or ends, then the
    // warp runs the posted leaves
    int node = go ? 0 : n_nodes;
    for (;;) {
      int c = -1;
      unsigned it = 0;
      while (node < n_nodes) {
        const bool live = live_at(aabb, node, r, oix, oiy, oiz, h.t);
        const int cc = __ldg(cid_t + node);
        ++it;
        if (live && cc >= 0) {
          c = cc;
          ++node;
          break;
        }
        node = live ? node + 1 : __ldg(skip_t + node);
      }
      nv += (int)it;
      cwalk::count_node_steps<kSteps>(it, steps);
      bool stop = false;
      if (!cwalk::leaf_round<false, kSteps, false>(tri, c, r, h, false, none,
                                                   steps, stop))
        break;
    }
  } else if constexpr (V == FULL_WALK) {
    // the warp in lockstep: a live leaf is a round of its live lanes
    int n = 0;
    while (n < n_nodes) {
      const bool live = live_at(aabb, n, r, oix, oiy, oiz, h.t);
      const bool any_live = __any_sync(FULL, live);
      const int cc = __ldg(cid_t + n);
      nv += 1;
      if (kSteps && (threadIdx.x & 31) == 0) steps.node += 1u;
      if (any_live && cc >= 0) {
        bool stop = false;
        cwalk::leaf_round<false, kSteps, false>(tri, live ? cc : -1, r, h,
                                                false, none, steps, stop);
      }
      n = any_live ? n + 1 : __ldg(skip_t + n);
    }
  } else {
    // no_tri's leaf branch, its test bodies emptied, compiles to nothing
    int n = 0;
    while (n < n_nodes) {
      bool live;
      if (V == NO_SLAB)
        live = (h.t + __ldg(aabb + (size_t)n * 8)) > 0.0f;
      else
        live = live_at(aabb, n, r, oix, oiy, oiz, h.t);
      const bool any_live = kWarp ? __any_sync(FULL, live) : live;
      nv += 1;
      n = any_live ? n + 1 : __ldg(skip_t + n);
    }
  }
  if (go) bt_out[i] = h.t;
  if (!kWarp) {
    if (go) nv_out[i] = nv;
  } else if ((threadIdx.x & 31) == 0) {
    nv_out[i >> 5] = nv;
  }
  if (kSteps && (threadIdx.x & 31) == 0) {
    atomicAdd(steps_out, (unsigned long long)steps.node);
    atomicAdd(steps_out + 1, (unsigned long long)steps.tri);
  }
}

template <int V, bool kSteps>
void launch(bool warp, int blocks, cudaStream_t s, const float* aabb,
            const int* cid, const int* skip, const float* tri, int n_nodes,
            const float* ro, const float* rd, const float* tmin,
            const float* tmax, int n_rays, float* bt, int* nv,
            unsigned long long* steps) {
  if (warp)
    walk_kernel<V, true, kSteps><<<blocks, BLOCK, 0, s>>>(
        aabb, cid, skip, tri, n_nodes, ro, rd, tmin, tmax, n_rays, bt, nv,
        steps);
  else
    walk_kernel<V, false, kSteps><<<blocks, BLOCK, 0, s>>>(
        aabb, cid, skip, tri, n_nodes, ro, rd, tmin, tmax, n_rays, bt, nv,
        steps);
}

int run(const float* aabb, const int* cid, const int* skip, const float* tri,
        int n_nodes, const float* ro, const float* rd, const float* tmin,
        const float* tmax, int n_rays, int variant, int group, float* bt,
        int* nv, unsigned long long* steps, void* stream) {
  if ((group != 1 && group != 32) || (group == 32 && n_rays % 32) ||
      variant < 0 || variant > 4 ||
      (steps != nullptr && variant != FULL_WALK))
    return (int)cudaErrorInvalidValue;
  const int blocks = (n_rays + BLOCK - 1) / BLOCK;
  const bool w = group == 32;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case FULL_WALK:
      if (steps != nullptr)
        launch<FULL_WALK, true>(w, blocks, s, aabb, cid, skip, tri, n_nodes,
                                ro, rd, tmin, tmax, n_rays, bt, nv, steps);
      else
        launch<FULL_WALK, false>(w, blocks, s, aabb, cid, skip, tri, n_nodes,
                                 ro, rd, tmin, tmax, n_rays, bt, nv, steps);
      break;
    case NO_TRI:
      launch<NO_TRI, false>(w, blocks, s, aabb, cid, skip, tri, n_nodes, ro,
                            rd, tmin, tmax, n_rays, bt, nv, steps);
      break;
    case NO_COND:
      launch<NO_COND, false>(w, blocks, s, aabb, cid, skip, tri, n_nodes, ro,
                             rd, tmin, tmax, n_rays, bt, nv, steps);
      break;
    case LEAN_CARRY:
      launch<LEAN_CARRY, false>(w, blocks, s, aabb, cid, skip, tri, n_nodes,
                                ro, rd, tmin, tmax, n_rays, bt, nv, steps);
      break;
    default:
      launch<NO_SLAB, false>(w, blocks, s, aabb, cid, skip, tri, n_nodes, ro,
                             rd, tmin, tmax, n_rays, bt, nv, steps);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 full, 1 no_tri, 2 no_cond, 3 lean_carry, 4 no_slab; group: 1
// or 32 (n_rays a multiple of 32). nv holds n_rays / group counts. The
// node boxes and triangle rows are read 16 bytes at a time (aabb and tri
// 16-byte aligned). steps: null, or (the full walk) device uint64[2]
// that gets the warp node and triangle steps added.
extern "C" int vimg_probe_walk(const float* aabb, const int* cid,
                               const int* skip, const float* tri,
                               int n_nodes, const float* ro, const float* rd,
                               const float* tmin, const float* tmax,
                               int n_rays, int variant, int group, float* bt,
                               int* nv, unsigned long long* steps,
                               void* stream) {
  return run(aabb, cid, skip, tri, n_nodes, ro, rd, tmin, tmax, n_rays,
             variant, group, bt, nv, steps, stream);
}
