// Packet mesh tracer for Hopper (sm_90a): kernel B5 of vimg_tpu_torch's
// PacketTracer.
//
// Replaces: vimg_tpu/geometry/packet_trace.py::_make_packet_kernel (built
// by _build_packet_fn). Per workgroup of 128 Morton-sorted rays (16 packets
// of 8), it walks the workgroup's chain of candidate clusters from the cull
// (geometry/packet_trace.py::_cull_meta) and tests each packet whose
// liveness bit is set against all 128 triangles of the cluster: closest hit
// (t, code = c*128 + k, least code among equal t) or any hit (t = -inf).
//
// Design: the work unit is one live (candidate, packet) pair, run by one
// warp.
//  - A warp owns its packets for the whole walk, so no two warps ever
//    update one packet's state. Lane = (ray lane & 7, quarter q = lane >>
//    3); at step kk the lane tests triangle k = 4 kk + q, so a step's four
//    triangles are 16 contiguous bytes of each constant row, and a pair is
//    at most 32 steps. The steps past the cluster's last triangle with a
//    non-zero normal are skipped: a zero normal is parallel to every ray
//    (or gives a NaN t) and never hits.
//  - The chain is read in 32-slot windows of meta row 1 by ballots, in
//    ascending slot order (the chain order): the slots holding a packet of
//    the warp, and for f2b every candidate (pmask != 0), whose count sets
//    the chunks of the early exit.
//  - Each lane keeps the state of its (ray, quarter): best t, code and a
//    32-bit mask of its steps at that t. At the end the four quarters of a
//    ray merge by the plain rule (the least t, then the least code among
//    the quarters at it that hold a hit): exact, because the plain rule is
//    per triangle lane k and the quarters partition k.
//  - Any hit: after each pair a ray's four lanes share their occlusion,
//    and a packet whose eight rays are all occluded takes no more pairs.
//  - slist: blocks of 4 warps (4 packets of one workgroup) with no barrier
//    at all. f2b: a block of 4 warps is a workgroup, warp w owning packets
//    w, w + 4, w + 8, w + 12, so that a chunk's pairs spread over the
//    warps (one packet a warp in 16-warp blocks leaves most warps waiting
//    at each barrier). After each chunk of `unroll` chain entries one
//    block reduction (shuffles, then shared memory, one barrier) of min(t,
//    scene exit) decides the early exit, as the plain version's test after
//    each chunk.
//  - The triangle constants come straight from L2 (__ldg; the
//    terrain-100k table is 6.64 MiB, L2 holds 50 MB). A per-warp cp.async
//    double buffer in shared memory was slower on 5 of the 6 (variant, ray
//    kind) cases: its 12 KB a warp caps residency, and L1 already keeps a
//    cluster's rows over its steps.
//  - An optional counter adds up the warp test steps executed: the lane
//    fill is the plain count of needed tests / (32 x steps).
//
// Float arithmetic is the plain version's (packet_walk_plain) operation
// for operation; the file is built with -fmad=false and no fast math;
// jmin/jmax propagate NaN as torch.minimum / jnp.minimum do. It gives the
// plain walk's (t, code) bit for bit.
//
// What bounds it on this card: the float32 operations of the needed
// triangle tests (about 56 a test), by a wide margin over the bytes of the
// meta table and the triangle rows. The first design (a block a
// workgroup, a thread a ray, the cluster staged in shared memory behind a
// barrier per candidate) lost most of its time to idle lanes (8 of a
// warp's 32 threads a live packet) and to that load and barrier.
//
// Launch contract: vimg_packet_trace() launches on the given stream, does
// not synchronise and allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WG = 128;        // rays per workgroup
constexpr int K = 128;         // triangles per cluster
constexpr int N_CONST = 12;    // constants per triangle
constexpr int META_ROWS = 8;   // meta rows per workgroup
constexpr int N_PACKETS = WG / 8;
constexpr int CLUSTER = N_CONST * K; // floats of one cluster (6 KB)
constexpr int WARPS = 4;             // warps a block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fffffff); }
__device__ __forceinline__ bool isnan_(float a) { return a != a; }
__device__ __forceinline__ float jmax(float a, float b) {
  return (isnan_(a) || isnan_(b)) ? qnan() : (a > b ? a : b);
}
__device__ __forceinline__ float jmin(float a, float b) {
  return (isnan_(a) || isnan_(b)) ? qnan() : (a < b ? a : b);
}

// scene-box exit t of a ray (f2b): as packet_trace._scene_exits
__device__ __forceinline__ float axis_exit(float o, float d, float lo,
                                           float hi) {
  float ivd = 1.0f / (d == 0.0f ? 1e-30f : d);
  return jmax((lo - o) * ivd, (hi - o) * ivd);
}

// The next slot of the chain holding a packet of `mine` (a mask of
// packets), or -1: `bits` holds such slots left in the 32-slot window at
// `base` (start at base = -32, bits = 0).
__device__ __forceinline__ int next_slot(const int* __restrict__ pmask,
                                         int cp, int mine, int lane,
                                         int& base, unsigned& bits) {
  while (bits == 0u) {
    base += 32;
    if (base >= cp) return -1;
    const int j = base + lane;
    const int v = j < cp ? pmask[j] : 0;
    bits = __ballot_sync(FULL, (v & mine) != 0);
  }
  const int b = __ffs(bits) - 1;
  bits &= bits - 1u;
  return base + b;
}

// The steps of a pair: up to the cluster's last step holding a triangle
// with a non-zero normal (lane l looks at step l's four triangles).
__device__ __forceinline__ int pair_steps(const float* __restrict__ s,
                                          int lane) {
  bool nz = false;
#pragma unroll
  for (int r = 0; r < 3; r++) {
    const float4 n =
        __ldg(reinterpret_cast<const float4*>(s + r * K + 4 * lane));
    nz |= n.x != 0.0f || n.y != 0.0f || n.z != 0.0f || n.w != 0.0f;
  }
  return 32 - __clz(__ballot_sync(FULL, nz));
}

// One pair: the lane's ray against quarter q of cluster rid, whose
// constants start at s, for n_steps steps.
template <bool kAnyHit>
__device__ __forceinline__ void test_pair(
    const float* __restrict__ s, int rid, int q, int n_steps, float ox,
    float oy, float oz, float dx, float dy, float dz, float mnt, float& bt,
    int& code, unsigned& mask) {
  const int cbase = rid * K;
#pragma unroll 2
  for (int kk = 0; kk < n_steps; kk++) {
    const int k = 4 * kk + q;
    const float nx = __ldg(s + 0 * K + k);
    const float ny = __ldg(s + 1 * K + k);
    const float nz = __ldg(s + 2 * K + k);
    const float d0 = __ldg(s + 3 * K + k);
    const float m1x = __ldg(s + 4 * K + k);
    const float m1y = __ldg(s + 5 * K + k);
    const float m1z = __ldg(s + 6 * K + k);
    const float c1 = __ldg(s + 7 * K + k);
    const float m2x = __ldg(s + 8 * K + k);
    const float m2y = __ldg(s + 9 * K + k);
    const float m2z = __ldg(s + 10 * K + k);
    const float c2 = __ldg(s + 11 * K + k);
    const float ro_n = ox * nx + oy * ny + oz * nz;
    const float rd_n = dx * nx + dy * ny + dz * nz;
    const bool par = fabsf(rd_n) < 1e-22f;
    const float t = (d0 - ro_n) / (par ? 1.0f : rd_n);
    const float u = ox * m1x + oy * m1y + oz * m1z - c1
                    + t * (dx * m1x + dy * m1y + dz * m1z);
    const float v = ox * m2x + oy * m2y + oz * m2z - c2
                    + t * (dx * m2x + dy * m2y + dz * m2z);
    if (par || !(u >= 0.0f) || !(v >= 0.0f) || !(u + v <= 1.0f) ||
        !(t >= mnt))
      continue;
    const unsigned bit = 1u << kk;
    if (t < bt) {
      if (kAnyHit) {
        bt = -INFINITY;
      } else {
        bt = t;
        code = cbase + k;
        mask = bit;
      }
    } else if (!kAnyHit && t == bt && code >= 0 && !(mask & bit)) {
      mask |= bit;
      code = min(code, cbase + k);
    }
  }
}

// A block is WARPS warps. slist: a warp one packet (four blocks a
// workgroup), no barrier. f2b: a block one workgroup, warp w the packets
// w + WARPS s (s < PPW), one barrier a chunk of `unroll` chain entries.
template <bool kAnyHit, bool kF2b>
__global__ void __launch_bounds__(WARPS * 32)
    packet_kernel(const float* __restrict__ tri, const int* __restrict__ meta,
                  const float* __restrict__ ro, const float* __restrict__ rd,
                  const float* __restrict__ minT,
                  const float* __restrict__ maxT, int cp, int n_clusters,
                  int unroll, float entry_scale, float lo0, float lo1,
                  float lo2, float hi0, float hi1, float hi2,
                  float* __restrict__ t_out, float* __restrict__ code_out,
                  unsigned long long* __restrict__ steps_out) {
  constexpr int PPW = kF2b ? N_PACKETS / WARPS : 1;   // packets a warp
  __shared__ float s_worst[2][WARPS];        // f2b: double-buffered

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wg = kF2b ? blockIdx.x : blockIdx.x / (N_PACKETS / WARPS);
  const int p0 = kF2b ? warp : (blockIdx.x % (N_PACKETS / WARPS)) * WARPS
                                   + warp;
  const int r = lane & 7, q = lane >> 3;
  const int* m = meta + (size_t)wg * META_ROWS * cp;
  const int* pmask = m + cp;
  auto ray_of = [&](int s) {
    return (size_t)wg * WG + (p0 + WARPS * s) * 8 + r;
  };

  // the state of the lane's (ray, quarter) in each packet of the warp
  float bt[PPW], exit_t[PPW];
  int code[PPW];
  unsigned mask[PPW];
  bool done[PPW];             // any hit: the packet's rays all occluded
  int mine = 0;
#pragma unroll
  for (int s = 0; s < PPW; s++) {
    const size_t ray = ray_of(s);
    mine |= 1 << (p0 + WARPS * s);
    bt[s] = maxT[ray];
    code[s] = -1;
    mask[s] = 0u;
    done[s] = false;
    exit_t[s] = 0.0f;
    if (kF2b) {
      const float ox = ro[3 * ray + 0], oy = ro[3 * ray + 1],
                  oz = ro[3 * ray + 2];
      const float dx = rd[3 * ray + 0], dy = rd[3 * ray + 1],
                  dz = rd[3 * ray + 2];
      float e = axis_exit(ox, dx, lo0, hi0);
      e = jmin(e, axis_exit(oy, dy, lo1, hi1));
      e = jmin(e, axis_exit(oz, dz, lo2, hi2));
      exit_t[s] = e * 1.0001f + 1e-5f;
    }
  }
  // slist: the warp's one ray stays in registers; f2b reloads a packet's
  // rays for each pair (four packets' rays would cost 28 registers)
  float g[PPW == 1 ? 7 : 1];
  if constexpr (PPW == 1) {
    const size_t ray = ray_of(0);
#pragma unroll
    for (int a = 0; a < 3; a++) {
      g[a] = ro[3 * ray + a];
      g[3 + a] = rd[3 * ray + a];
    }
    g[6] = minT[ray];
  }
  auto all_done = [&]() {
    bool a = true;
#pragma unroll
    for (int s = 0; s < PPW; s++) a = a && done[s];
    return a;
  };
  // slot j's cluster (f2b: meta row 4) and its constants in the table
  auto cluster = [&](int j) { return kF2b ? m[4 * cp + j] : j; };
  auto table = [&](int rid) {
    return tri + (size_t)min(rid, n_clusters - 1) * CLUSTER;
  };
  long long steps = 0;

  // a candidate slot j holding packets of the warp (vb: its packet mask)
  auto run_candidate = [&](int j, int vb) {
    const int rid = cluster(j);
    const float* src = table(rid);
    bool any = false;
#pragma unroll
    for (int s = 0; s < PPW; s++)
      any = any || (((vb >> (p0 + WARPS * s)) & 1) && !done[s]);
    if (any) {
      const int n_steps = pair_steps(src, lane);
#pragma unroll
      for (int s = 0; s < PPW; s++) {
        if (!((vb >> (p0 + WARPS * s)) & 1) || done[s]) continue;
        float h[7];
        if constexpr (PPW == 1) {
#pragma unroll
          for (int a = 0; a < 7; a++) h[a] = g[a];
        } else {
          const size_t ray = ray_of(s);
#pragma unroll
          for (int a = 0; a < 3; a++) {
            h[a] = ro[3 * ray + a];
            h[3 + a] = rd[3 * ray + a];
          }
          h[6] = minT[ray];
        }
        test_pair<kAnyHit>(src, rid, q, n_steps, h[0], h[1], h[2], h[3],
                            h[4], h[5], h[6], bt[s], code[s], mask[s]);
        steps += n_steps;
        if (kAnyHit) {
          bool occ = bt[s] == -INFINITY;
          occ |= __shfl_xor_sync(FULL, occ, 8);
          occ |= __shfl_xor_sync(FULL, occ, 16);
          if (occ) bt[s] = -INFINITY;
          done[s] = __all_sync(FULL, occ);
        }
      }
    }
  };

  if (!kF2b) {
    int base = -32;
    unsigned bits = 0u;
    while (!all_done()) {
      const int j = next_slot(pmask, cp, mine, lane, base, bits);
      if (j < 0) break;
      run_candidate(j, pmask[j]);
    }
  } else {
    // every chain entry in order, for the chunk count of the early exit
    const int count = m[2 * cp];
    const int ch = unroll < 1 ? 1 : unroll;
    int base = -32, par = 0, v = 0;
    unsigned cand = 0u;
    for (int i = 0; i < count; i++) {
      while (cand == 0u && base + 32 < cp) {
        base += 32;
        v = base + lane < cp ? pmask[base + lane] : 0;
        cand = __ballot_sync(FULL, v != 0);
      }
      if (cand == 0u) break;       // a count past the chain's end
      const int b = __ffs(cand) - 1;
      cand &= cand - 1u;
      const int j = base + b;
      const int vb = __shfl_sync(FULL, v, b);
      if ((vb & mine) && !all_done()) run_candidate(j, vb);
      if ((i + 1) % ch == 0 && i + 1 < count) {
        // the worst ray of the workgroup: max over rays of min(t, exit)
        float w = 0.0f;
#pragma unroll
        for (int s = 0; s < PPW; s++) {
          float x = jmin(bt[s], __shfl_xor_sync(FULL, bt[s], 8));
          x = jmin(x, __shfl_xor_sync(FULL, x, 16));
          x = jmin(x, exit_t[s]);
          w = s == 0 ? x : jmax(w, x);
        }
#pragma unroll
        for (int o = 4; o > 0; o >>= 1)
          w = jmax(w, __shfl_xor_sync(FULL, w, o));
        if (lane == 0) s_worst[par][warp] = w;
        __syncthreads();
        float worst = s_worst[par][0];
#pragma unroll
        for (int k = 1; k < WARPS; k++)
          worst = jmax(worst, s_worst[par][k]);
        par ^= 1;            // the next check writes the other buffer
        const int nxt_e = m[3 * cp + m[j + 1]];
        if (worst * entry_scale < (float)(nxt_e - 1)) break;
      }
    }
  }

  // each ray's four quarters: the least t, then the least code among the
  // quarters at it that hold a hit
#pragma unroll
  for (int s = 0; s < PPW; s++) {
    float t = bt[s];
    int c = code[s];
#pragma unroll
    for (int o = 8; o <= 16; o <<= 1) {
      const float ot = __shfl_xor_sync(FULL, t, o);
      const int oc = __shfl_xor_sync(FULL, c, o);
      if (ot < t) {
        t = ot;
        c = oc;
      } else if (!(t < ot) && oc >= 0 && (c < 0 || oc < c)) {
        c = oc;
      }
    }
    if (q == 0) {
      t_out[ray_of(s)] = t;
      code_out[ray_of(s)] = (float)c;
    }
  }
  if (steps_out != nullptr && lane == 0)
    atomicAdd(steps_out, (unsigned long long)steps);
}

template <bool kAnyHit, bool kF2b>
int launch(int n_wg, cudaStream_t stream, const float* tri, const int* meta,
           const float* ro, const float* rd, const float* minT,
           const float* maxT, int cp, int n_clusters, int unroll,
           float entry_scale, const float* b, float* t_out, float* code_out,
           unsigned long long* steps) {
  packet_kernel<kAnyHit, kF2b>
      <<<kF2b ? n_wg : n_wg * (N_PACKETS / WARPS), WARPS * 32, 0, stream>>>(
          tri, meta, ro, rd, minT, maxT, cp, n_clusters, unroll, entry_scale,
          b[0], b[1], b[2], b[3], b[4], b[5], t_out, code_out, steps);
  return (int)cudaGetLastError();
}

}  // namespace

// steps: a device uint64 the kernel adds its warp test steps to, or null.
extern "C" int vimg_packet_trace(const float* tri, const int* meta,
                                 const float* ro, const float* rd,
                                 const float* minT, const float* maxT,
                                 int n_rays, int cp, int n_clusters,
                                 int any_hit, int f2b, int unroll,
                                 float entry_scale, float lo0, float lo1,
                                 float lo2, float hi0, float hi1, float hi2,
                                 float* t_out, float* code_out,
                                 unsigned long long* steps, void* stream) {
  const int n_wg = n_rays / WG;
  const float b[6] = {lo0, lo1, lo2, hi0, hi1, hi2};
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit)
    return f2b ? launch<true, true>(n_wg, s, tri, meta, ro, rd, minT, maxT,
                                    cp, n_clusters, unroll, entry_scale, b,
                                    t_out, code_out, steps)
               : launch<true, false>(n_wg, s, tri, meta, ro, rd, minT, maxT,
                                     cp, n_clusters, unroll, entry_scale, b,
                                     t_out, code_out, steps);
  return f2b ? launch<false, true>(n_wg, s, tri, meta, ro, rd, minT, maxT,
                                   cp, n_clusters, unroll, entry_scale, b,
                                   t_out, code_out, steps)
             : launch<false, false>(n_wg, s, tri, meta, ro, rd, minT, maxT,
                                    cp, n_clusters, unroll, entry_scale, b,
                                    t_out, code_out, steps);
}
