// Packet cull for Hopper (sm_90a): kernel X1 of vimg_tpu_torch's
// PacketTracer, the pass before the packet walk B5 (packet_trace.cu).
//
// Replaces: vimg_tpu/geometry/packet_trace.py::_cull_meta, which vimg_tpu
// leaves to XLA (no Pallas kernel), and its plain PyTorch version
// geometry/packet_trace.py::_cull_meta. Per workgroup of 128 rays (16
// packets of 8) and per cluster box, exact slab tests of every ray,
// reduced to the meta block the walk reads (8 rows of cp int32):
//   row 0: nxt[j], the least candidate index >= j (sentinel cp - 1)
//   row 1: the 16 packet bits of candidate j (bit p: a ray of packet p
//          meets the box)
//   row 2: column 0 the candidate count, 0 elsewhere
//   f2b only (pi given; column j is cluster pi[oct_w][j] of the
//   workgroup's octant): row 3 the suffix minimum over j' >= j of the
//   quantised entry int32(clamp(entry * entry_scale, 0, 2^30)), 2^30
//   where there is no candidate; row 4 pi[oct_w][j]
//   every other slot 0 (no zero-fill pass is needed).
//
// Design: one block a workgroup, a thread a cluster (128 columns a chunk,
// the chunks from the last to the first). The workgroup's rays (o, minT)
// and (1/d, maxT) sit in shared memory as two float4 each, so a thread
// slab-tests all 128 rays from broadcast reads against its cluster box in
// registers and forms the 16 bits and the entry itself: no cross-thread
// reduction, and each row is written as 128 coalesced ints a chunk. Rows
// 0 and 3 are suffix minima over j: a warp shuffle scan, the warps' minima
// in shared memory (double-buffered by chunk, so one barrier a chunk) and
// the carry of the chunks already done. The count comes from the same
// barrier (__syncthreads_count).
//
// Float arithmetic is the plain version's operation for operation, in its
// order: inv = 1 / (d == 0 ? 1e-30 : d); per axis x, y, z t0 = (lo - o) *
// inv, t1 = (hi - o) * inv, tin = max(tin, min(t0, t1)) from minT, tout =
// min(tout, max(t0, t1)) from maxT; hit = tin <= tout. The file is built
// with -fmad=false and no fast math; jmin/jmax propagate NaN as
// torch.minimum / torch.maximum. The f2b octant (a float32 sum over the
// workgroup's directions, whose sign depends on the order of the sum)
// stays a PyTorch expression shared with the plain version; the kernel
// takes its (W,) result.
//
// What bounds it on this card: the float32 operations of the W x C x 128
// slab tests (about 25 each), far above the bytes (the meta written once,
// the rays read once).
//
// Launch contract: vimg_packet_cull() launches on the given stream, does
// not synchronise and allocates nothing; it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WG = 128;         // rays per workgroup = threads per block
constexpr int N_PACKETS = WG / 8;
constexpr int META_ROWS = 8;
constexpr int WARPS = WG / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_ENTRY = 1 << 30;

// min / max that return NaN when either input is NaN, as torch.minimum /
// torch.maximum do: one FMNMX.NAN instruction (PTX max.NaN, sm_80+) where
// a compare-and-select form takes three. A NaN's bits and the sign of a
// zero result may differ from PyTorch's, but they reach neither the hit
// test (tin <= tout) nor the quantised entry (clamped at 0).
__device__ __forceinline__ float jmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float jmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Suffix minima of v0 and v3 over the block's 128 threads in thread
// order: every thread gets the minimum over itself and the later threads;
// each warp's minimum is left in wmin0 / wmin3[warp]. One barrier, which
// also returns the number of threads with pred in n.
__device__ __forceinline__ void suffix_min2(int& v0, int& v3, int* wmin0,
                                            int* wmin3, int pred, int& n) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int a = __shfl_down_sync(FULL, v0, off);
    const int b = __shfl_down_sync(FULL, v3, off);
    if (lane + off < 32) {
      v0 = min(v0, a);
      v3 = min(v3, b);
    }
  }
  if (lane == 0) {
    wmin0[warp] = v0;
    wmin3[warp] = v3;
  }
  n = __syncthreads_count(pred);
#pragma unroll
  for (int w = 1; w < WARPS; ++w) {
    if (w > warp) {
      v0 = min(v0, wmin0[w]);
      v3 = min(v3, wmin3[w]);
    }
  }
}

// kF2b: pi (the per-octant orderings) and octs are given; rows 3 and 4
template <bool kF2b>
__global__ void __launch_bounds__(WG)
    packet_cull_kernel(const float* __restrict__ ro,
                       const float* __restrict__ rd,
                       const float* __restrict__ mn,
                       const float* __restrict__ mx,
                       const float* __restrict__ cl_lo,
                       const float* __restrict__ cl_hi,
                       const long long* __restrict__ pi,
                       const int* __restrict__ octs, int C, int cp,
                       float entry_scale, int* __restrict__ meta) {
  __shared__ float4 s_om[WG];   // o, minT
  __shared__ float4 s_ix[WG];   // 1/d, maxT
  __shared__ int s_wmin0[2][WARPS], s_wmin3[2][WARPS];
  const int w = blockIdx.x, tid = threadIdx.x;
  {
    const int i = w * WG + tid;
    const float dx = rd[3 * i + 0], dy = rd[3 * i + 1], dz = rd[3 * i + 2];
    s_om[tid] = make_float4(ro[3 * i + 0], ro[3 * i + 1], ro[3 * i + 2],
                            mn[i]);
    s_ix[tid] = make_float4(1.0f / (dx == 0.0f ? 1e-30f : dx),
                            1.0f / (dy == 0.0f ? 1e-30f : dy),
                            1.0f / (dz == 0.0f ? 1e-30f : dz), mx[i]);
  }
  const long long* __restrict__ order =
      kF2b ? pi + (size_t)octs[w] * C : nullptr;
  int* __restrict__ m = meta + (size_t)w * META_ROWS * cp;
  __syncthreads();
  int carry0 = cp - 1, carry3 = NO_ENTRY, count = 0;
  for (int base = cp - WG, chunk = 0; base >= 0; base -= WG, ++chunk) {
    const int j = base + tid;
    unsigned bits = 0u;
    float entry = INFINITY;
    int id = 0;
    if (j < C) {
      id = kF2b ? (int)order[j] : j;
      const float lox = cl_lo[3 * id + 0], loy = cl_lo[3 * id + 1],
                  loz = cl_lo[3 * id + 2];
      const float hix = cl_hi[3 * id + 0], hiy = cl_hi[3 * id + 1],
                  hiz = cl_hi[3 * id + 2];
#pragma unroll 1
      for (int p = 0; p < N_PACKETS; ++p) {
        bool any = false;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float4 om = s_om[8 * p + q], ix = s_ix[8 * p + q];
          const float t0x = (lox - om.x) * ix.x, t1x = (hix - om.x) * ix.x;
          const float t0y = (loy - om.y) * ix.y, t1y = (hiy - om.y) * ix.y;
          const float t0z = (loz - om.z) * ix.z, t1z = (hiz - om.z) * ix.z;
          float tin = jmax(om.w, jmin(t0x, t1x));
          float tout = jmin(ix.w, jmax(t0x, t1x));
          tin = jmax(tin, jmin(t0y, t1y));
          tout = jmin(tout, jmax(t0y, t1y));
          tin = jmax(tin, jmin(t0z, t1z));
          tout = jmin(tout, jmax(t0z, t1z));
          const bool hit = tin <= tout;
          any |= hit;
          // a hit's tin is not NaN; the least of them, whatever the order
          if (kF2b && hit && tin < entry) entry = tin;
        }
        bits |= (unsigned)any << p;
      }
    }
    // row 0: j where a candidate, else the sentinel; row 3: its quantised
    // entry (clamp, then truncation, as .to(torch.int32))
    int v0 = bits ? j : cp - 1;
    int v3 = NO_ENTRY;
    if (kF2b && bits) {
      float qe = entry * entry_scale;
      qe = jmin(jmax(qe, 0.0f), 1073741824.0f);
      v3 = (int)qe;
    }
    int n;
    suffix_min2(v0, v3, s_wmin0[chunk & 1], s_wmin3[chunk & 1], bits != 0u,
                n);
    count += n;
    v0 = min(v0, carry0);
    v3 = min(v3, carry3);
    {
      const int* w0 = s_wmin0[chunk & 1];
      const int* w3 = s_wmin3[chunk & 1];
#pragma unroll
      for (int k = 0; k < WARPS; ++k) {
        carry0 = min(carry0, w0[k]);
        carry3 = min(carry3, w3[k]);
      }
    }
    m[0 * cp + j] = v0;
    m[1 * cp + j] = (int)bits;
    m[2 * cp + j] = j == 0 ? count : 0;   // chunk 0 is the last one
    m[3 * cp + j] = kF2b ? v3 : 0;
    m[4 * cp + j] = kF2b && j < C ? id : 0;
    m[5 * cp + j] = 0;
    m[6 * cp + j] = 0;
    m[7 * cp + j] = 0;
  }
}

}  // namespace

extern "C" int vimg_packet_cull(const float* ro, const float* rd,
                                const float* mn, const float* mx,
                                const float* cl_lo, const float* cl_hi,
                                const long long* pi, const int* octs,
                                int n_work, int C, int cp, float entry_scale,
                                int* meta, void* stream) {
  if (n_work > 0 && pi != nullptr)
    packet_cull_kernel<true><<<n_work, WG, 0, (cudaStream_t)stream>>>(
        ro, rd, mn, mx, cl_lo, cl_hi, pi, octs, C, cp, entry_scale, meta);
  else if (n_work > 0)
    packet_cull_kernel<false><<<n_work, WG, 0, (cudaStream_t)stream>>>(
        ro, rd, mn, mx, cl_lo, cl_hi, pi, octs, C, cp, entry_scale, meta);
  return (int)cudaGetLastError();
}
