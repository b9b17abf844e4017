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
// Design: one block of 128 threads per workgroup, one thread per ray.
//  - The candidate list is the ascending slots whose packet mask (meta row
//    1) is non-zero: exactly the chain of row 0's next pointers. The block
//    compacts it into shared memory in parallel (warp ballots), for every
//    variant; f2b reads the real cluster id (row 4) and the entry distance
//    (row 3) at the listed slots.
//  - Per candidate the block stages the cluster's 12 x 128 constants in
//    shared memory (thread k loads triangle k's column: 6 KB, coalesced),
//    and every thread of a live packet loops over the 128 triangles there
//    (all threads read one address: a broadcast). The packet bit gates the
//    test, not the ray's own slab test: that is what the TPU kernel does,
//    and the two differ at rounding edges.
//  - vimg_tpu keeps (bt, code) per (ray, lane) and reduces over lanes at
//    the end: the minimum bt, and the least code among the lanes at it. A
//    thread here keeps the lanes' minimum bt, its code and a 128-bit mask
//    of the lanes at that minimum: t < bt restarts them, t == bt on a lane
//    not yet in the mask (only once a hit is recorded: a first hit needs
//    t < maxT) joins it with the lesser code. That equals the per-lane rule
//    for any chain order.
//  - f2b: after each chunk of `unroll` candidates a block reduction (warp
//    shuffles, then shared memory) of min(bt, scene exit) decides the early
//    exit, as the TPU kernel's test after each unrolled chunk. Any-hit
//    blocks also leave once every ray is occluded (the result cannot move).
//  - Float arithmetic is the plain version's (packet_walk_plain) operation
//    for operation; the file is built with -fmad=false and no fast math;
//    jmin/jmax propagate NaN as torch.minimum / jnp.minimum do.
//
// What bounds it on this card: the float32 operations of the dense
// triangle tests (about 56 per test), by a wide margin over the bytes of
// the meta table and the triangle rows. This first version stages one
// cluster at a time with two barriers per candidate and no double
// buffering: the per-candidate load latency is not hidden.
//
// Launch contract: vimg_packet_trace() launches on the given stream, does
// not synchronise and allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WG = 128;        // rays per workgroup = threads per block
constexpr int K = 128;         // triangles per cluster
constexpr int N_CONST = 12;    // constants per triangle
constexpr int META_ROWS = 8;   // meta rows per workgroup
constexpr int N_WARPS = WG / 32;

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

template <bool kAnyHit, bool kF2b>
__global__ void __launch_bounds__(WG)
    packet_kernel(const float* __restrict__ tri, const int* __restrict__ meta,
                  const float* __restrict__ ro, const float* __restrict__ rd,
                  const float* __restrict__ minT,
                  const float* __restrict__ maxT, int cp, int n_clusters,
                  int unroll, float entry_scale, float lo0, float lo1,
                  float lo2, float hi0, float hi1, float hi2,
                  float* __restrict__ t_out, float* __restrict__ code_out) {
  extern __shared__ int slist[];            // cp candidate slots
  __shared__ float s_tri[N_CONST][K];
  __shared__ int s_count[N_WARPS];
  __shared__ float s_worst[N_WARPS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t ray = (size_t)blockIdx.x * WG + tid;
  const int* m = meta + (size_t)blockIdx.x * META_ROWS * cp;
  const int* pmask = m + cp;

  const float ox = ro[3 * ray + 0], oy = ro[3 * ray + 1], oz = ro[3 * ray + 2];
  const float dx = rd[3 * ray + 0], dy = rd[3 * ray + 1], dz = rd[3 * ray + 2];
  const float mnt = minT[ray];
  float bt = maxT[ray];
  int code = -1;
  unsigned m0 = 0u, m1 = 0u, m2 = 0u, m3 = 0u;   // lanes at bt
  float exit_t = 0.0f;
  if (kF2b) {
    exit_t = axis_exit(ox, dx, lo0, hi0);
    exit_t = jmin(exit_t, axis_exit(oy, dy, lo1, hi1));
    exit_t = jmin(exit_t, axis_exit(oz, dz, lo2, hi2));
    exit_t = exit_t * 1.0001f + 1e-5f;
  }

  // the chain: ascending slots with a live packet
  int count = 0;
  for (int base = 0; base < cp; base += WG) {
    const int j = base + tid;
    const bool cand = j < cp && pmask[j] != 0;
    const unsigned b = __ballot_sync(0xffffffffu, cand);
    if (lane == 0) s_count[warp] = __popc(b);
    __syncthreads();
    int off = count, total = 0;
#pragma unroll
    for (int q = 0; q < N_WARPS; q++) {
      off += q < warp ? s_count[q] : 0;
      total += s_count[q];
    }
    if (cand) slist[off + __popc(b & ((1u << lane) - 1u))] = j;
    count += total;
    __syncthreads();
  }

  const int packet = tid >> 3;
  const int ch = unroll < 1 ? 1 : unroll;
  for (int i = 0; i < count; i++) {
    const int cs = slist[i];
    const int rid = kF2b ? m[4 * cp + cs] : cs;
    const int pm = pmask[cs];
    const float* src = tri + (size_t)min(rid, n_clusters - 1) * N_CONST * K;
#pragma unroll
    for (int j = 0; j < N_CONST; j++) s_tri[j][tid] = src[j * K + tid];
    __syncthreads();
    // bt = -inf: an idle lane (maxT = -inf) or an occluded any-hit ray
    if (((pm >> packet) & 1) && bt != -INFINITY) {
      const int cbase = rid * K;
#pragma unroll
      for (int q = 0; q < 4; q++) {
#pragma unroll 2
        for (int kk = 0; kk < 32; kk++) {
          const int k = q * 32 + kk;
          const float nx = s_tri[0][k], ny = s_tri[1][k], nz = s_tri[2][k];
          const float d0 = s_tri[3][k];
          const float m1x = s_tri[4][k], m1y = s_tri[5][k], m1z = s_tri[6][k];
          const float c1 = s_tri[7][k];
          const float m2x = s_tri[8][k], m2y = s_tri[9][k], m2z = s_tri[10][k];
          const float c2 = s_tri[11][k];
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
          const unsigned bitk = 1u << kk;
          if (t < bt) {
            if (kAnyHit) {
              bt = -INFINITY;
            } else {
              bt = t;
              code = cbase + k;
              m0 = q == 0 ? bitk : 0u;
              m1 = q == 1 ? bitk : 0u;
              m2 = q == 2 ? bitk : 0u;
              m3 = q == 3 ? bitk : 0u;
            }
          } else if (!kAnyHit && t == bt && code >= 0) {
            unsigned& mq = q == 0 ? m0 : q == 1 ? m1 : q == 2 ? m2 : m3;
            if (!(mq & bitk)) {
              mq |= bitk;
              code = min(code, cbase + k);
            }
          }
        }
      }
    }
    if (kAnyHit) {
      // every ray occluded: nothing further can change the result
      if (__syncthreads_and(bt == -INFINITY)) break;
    } else {
      __syncthreads();   // s_tri is rewritten by the next candidate
    }
    if (kF2b && (i + 1) % ch == 0 && i + 1 < count) {
      float w = jmin(bt, exit_t);
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        w = jmax(w, __shfl_xor_sync(0xffffffffu, w, s));
      if (lane == 0) s_worst[warp] = w;
      __syncthreads();
      float worst = s_worst[0];
#pragma unroll
      for (int q = 1; q < N_WARPS; q++) worst = jmax(worst, s_worst[q]);
      const int nxt_e = m[3 * cp + slist[i + 1]];
      __syncthreads();   // s_worst is rewritten by the next check
      if (worst * entry_scale < (float)(nxt_e - 1)) break;
    }
  }
  t_out[ray] = bt;
  code_out[ray] = (float)code;
}

template <bool kAnyHit, bool kF2b>
int launch(size_t smem, int blocks, cudaStream_t stream, const float* tri,
           const int* meta, const float* ro, const float* rd,
           const float* minT, const float* maxT, int cp, int n_clusters,
           int unroll, float entry_scale, const float* b, float* t_out,
           float* code_out) {
  auto kern = packet_kernel<kAnyHit, kF2b>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<blocks, WG, smem, stream>>>(tri, meta, ro, rd, minT, maxT, cp,
                                     n_clusters, unroll, entry_scale, b[0],
                                     b[1], b[2], b[3], b[4], b[5], t_out,
                                     code_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int vimg_packet_trace(const float* tri, const int* meta,
                                 const float* ro, const float* rd,
                                 const float* minT, const float* maxT,
                                 int n_rays, int cp, int n_clusters,
                                 int any_hit, int f2b, int unroll,
                                 float entry_scale, float lo0, float lo1,
                                 float lo2, float hi0, float hi1, float hi2,
                                 float* t_out, float* code_out,
                                 void* stream) {
  const int blocks = n_rays / WG;
  const size_t smem = (size_t)cp * sizeof(int);
  const float b[6] = {lo0, lo1, lo2, hi0, hi1, hi2};
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit)
    return f2b ? launch<true, true>(smem, blocks, s, tri, meta, ro, rd, minT,
                                    maxT, cp, n_clusters, unroll, entry_scale,
                                    b, t_out, code_out)
               : launch<true, false>(smem, blocks, s, tri, meta, ro, rd, minT,
                                     maxT, cp, n_clusters, unroll,
                                     entry_scale, b, t_out, code_out);
  return f2b ? launch<false, true>(smem, blocks, s, tri, meta, ro, rd, minT,
                                   maxT, cp, n_clusters, unroll, entry_scale,
                                   b, t_out, code_out)
             : launch<false, false>(smem, blocks, s, tri, meta, ro, rd, minT,
                                    maxT, cp, n_clusters, unroll, entry_scale,
                                    b, t_out, code_out);
}
