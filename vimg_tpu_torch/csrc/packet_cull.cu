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
// What bounds it on this card: the float32 operations of the W x C x 128
// slab tests, far above the bytes (the meta written once, the rays read
// once). Each is an instruction of its own (no fused form is exact), so
// the rate of one warp instruction a clock per SM partition is the
// ceiling; the plain form's test took 12 min/max of its 28 or so.
//
// Design: one block a workgroup, a thread a cluster (128 columns a chunk,
// the chunks from the last to the first).
//  - Octant buckets: at block start the workgroup's rays go into shared
//    memory bucketed by the sign bits of their inverse direction (1/d, so
//    d = +-0, taken as 1e-30, counts as positive), each entry (o, minT),
//    (1/d, maxT) and its packet's bit. A ray with !(minT <= maxT) (an idle
//    lane, maxT = -inf) meets no box and is left out: tin >= minT > maxT
//    >= tout, or a NaN.
//  - Near and far planes once a bucket: for a box with lo <= hi and a ray
//    with 1/d >= 0, rounding is monotone, so fl(lo - o) * inv <=
//    fl(hi - o) * inv: min(t0, t1) is the lo plane's t and max(t0, t1) the
//    hi plane's, unless one is NaN (then the plain form makes tin and tout
//    NaN, this form one of them: no hit either way). A thread picks its
//    box's near and far corners once a bucket and tests the bucket's rays
//    with tin = max(tin, (near - o) * inv), tout = min(tout, (far - o) *
//    inv): 6 min/max a test instead of 12, about 23 instructions instead
//    of 28. A hit's tin is the same number (a zero's sign aside, which the
//    quantisation's clamp and int32 drop). A box that is not lo <= hi on
//    every axis (an empty cluster's +inf / -inf, a NaN) breaks the
//    argument: a warp with such a box tests its 32 boxes in the plain
//    min/max form instead.
//  - Bucket bounds: the bucket's extent (the least and most o, 1/d, minT
//    and maxT of its rays) bounds every ray's t at a plane: with a = p - o
//    in [fl_rd(p - o_max), fl_ru(p - o_min)] and 1/d of one sign, a * inv
//    is monotone in each factor, so a corner product rounded down (up) is
//    below (above) every ray's fl(fl(p - o) * inv). If the least tin so
//    bounded exceeds the most tout, no ray of the bucket meets the box;
//    a warp skips the bucket when that holds for all its 32 boxes. A
//    bucket with a non-finite o or 1/d is never skipped, and a NaN bound
//    skips nothing. On terrain rays this leaves out half the tests or
//    more: neighbouring clusters are neighbouring boxes.
//  - Counted build (steps not null): each warp adds, over the columns
//    below C, its slab tests in the select form, in the plain form, its
//    bounds tests and the slab tests its skipped buckets left out
//    (steps[0..3]); geometry/cull_schedule.py replays them.
// Rows 0 and 3 are suffix minima over j: a warp shuffle scan, the warps'
// minima in shared memory (double-buffered by chunk, so one barrier a
// chunk) and the carry of the chunks already done. The count comes from
// the same barrier (__syncthreads_count). Each row is written as 128
// coalesced ints a chunk.
//
// Float arithmetic is the plain version's: inv = 1 / (d == 0 ? 1e-30 :
// d); per axis x, y, z the t of a plane (p - o) * inv; tin from minT,
// tout from maxT; hit = tin <= tout. The file is built with -fmad=false
// and no fast math; nmin/nmax propagate NaN as torch.minimum /
// torch.maximum. The f2b octant comes from a float32 sum over the
// workgroup's directions, whose sign depends on the order of the sum: that
// sum stays a PyTorch expression shared with the plain version
// (_direction_sums), and the kernel takes its (W, 3) result.
//
// Launch contract: vimg_packet_cull() launches on the given stream, does
// not synchronise and allocates nothing; it returns cudaGetLastError().
// steps: null, or device uint64[4] that gets the counts above added.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WG = 128;         // rays per workgroup = threads per block
constexpr int META_ROWS = 8;
constexpr int WARPS = WG / 32;
constexpr int N_OCT = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_ENTRY = 1 << 30;
// a bucket's bounds: least / most o (3 each), 1/d (3 each), minT, maxT
constexpr int N_BOUND = 14;

// min / max that return NaN when either input is NaN, as torch.minimum /
// torch.maximum do: one FMNMX.NAN instruction (PTX min.NaN / max.NaN,
// sm_80+). A zero's sign may differ from PyTorch's; it reaches neither the
// hit test nor the quantised entry.
__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// An order-preserving unsigned image of a float (-0 below +0), and back
__device__ __forceinline__ unsigned okey(float f) {
  const unsigned b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float ofloat(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The workgroup's live rays in bucket order: (o, minT), (1/d, maxT), the
// packet's bit; bucket o spans [beg[o], beg[o + 1]). bound[o]: the
// bucket's extent (okey images while it is reduced, then floats: o min
// xyz, o max xyz, 1/d min xyz, 1/d max xyz, minT min, maxT max); unsafe:
// a ray of the bucket has a non-finite o or 1/d
struct Rays {
  float4 om[WG];
  float4 ix[WG];
  unsigned pbit[WG];
  int beg[N_OCT + 1];
  unsigned bound[N_OCT][N_BOUND];
  unsigned unsafe[N_OCT];
};

// Whether no ray of bucket o (its bounds b) meets the box whose planes
// for the bucket's signs are near / far: the least tin the bounds allow
// exceeds the most tout. Products are rounded down for tin and up for
// tout; along an axis where 1/d >= 0, a * inv grows with a (so tin's
// bound takes the least a, tout's the most), where 1/d <= 0 it shrinks.
__device__ __forceinline__ bool misses(const float* b, int o,
                                       const float (&nr)[3],
                                       const float (&fr)[3]) {
  float lo = b[12], hi = b[13];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float omin = b[a], omax = b[3 + a];
    const float imin = b[6 + a], imax = b[9 + a];
    float an, af;
    if ((o >> a) & 1) {        // 1/d <= 0
      an = __fsub_ru(nr[a], omin);
      af = __fsub_rd(fr[a], omax);
    } else {                   // 1/d >= 0
      an = __fsub_rd(nr[a], omax);
      af = __fsub_ru(fr[a], omin);
    }
    lo = nmax(lo, __fmul_rd(an, an >= 0.0f ? imin : imax));
    hi = nmin(hi, __fmul_ru(af, af >= 0.0f ? imax : imin));
  }
  return lo > hi;
}

// The select form over the bucket [b0, b1): near / far are the box's
// planes for the bucket's signs
template <bool kF2b>
__device__ __forceinline__ void test_bucket(const Rays& s, int b0, int b1,
                                            const float (&nr)[3],
                                            const float (&fr)[3],
                                            unsigned& bits, float& entry) {
#pragma unroll 4
  for (int e = b0; e < b1; ++e) {
    const float4 om = s.om[e], ix = s.ix[e];
    float tin = nmax(om.w, (nr[0] - om.x) * ix.x);
    float tout = nmin(ix.w, (fr[0] - om.x) * ix.x);
    tin = nmax(tin, (nr[1] - om.y) * ix.y);
    tout = nmin(tout, (fr[1] - om.y) * ix.y);
    tin = nmax(tin, (nr[2] - om.z) * ix.z);
    tout = nmin(tout, (fr[2] - om.z) * ix.z);
    if (tin <= tout) {
      bits |= s.pbit[e];
      // a hit's tin is not NaN; the least of them, whatever the order
      if (kF2b) entry = fminf(entry, tin);
    }
  }
}

// The plain min/max form over every live ray, for a warp with a box not
// ordered on some axis
template <bool kF2b>
__device__ __forceinline__ void test_plain(const Rays& s,
                                           const float (&lo)[3],
                                           const float (&hi)[3],
                                           unsigned& bits, float& entry) {
  const int n = s.beg[N_OCT];
  for (int e = 0; e < n; ++e) {
    const float4 om = s.om[e], ix = s.ix[e];
    const float o[3] = {om.x, om.y, om.z}, iv[3] = {ix.x, ix.y, ix.z};
    float tin = om.w, tout = ix.w;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float t0 = (lo[a] - o[a]) * iv[a];
      const float t1 = (hi[a] - o[a]) * iv[a];
      tin = nmax(tin, nmin(t0, t1));
      tout = nmin(tout, nmax(t0, t1));
    }
    if (tin <= tout) {
      bits |= s.pbit[e];
      if (kF2b) entry = fminf(entry, tin);
    }
  }
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

// The workgroup's live rays into their octant buckets, and each bucket's
// bounds (three barriers)
__device__ __forceinline__ void bucket_rays(Rays& s, const float* ro,
                                            const float* rd, const float* mn,
                                            const float* mx) {
  __shared__ int s_cnt[WARPS][N_OCT];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * WG + tid;
  const float ox = ro[3 * i + 0], oy = ro[3 * i + 1], oz = ro[3 * i + 2];
  const float dx = rd[3 * i + 0], dy = rd[3 * i + 1], dz = rd[3 * i + 2];
  const float ix = 1.0f / (dx == 0.0f ? 1e-30f : dx);
  const float iy = 1.0f / (dy == 0.0f ? 1e-30f : dy);
  const float iz = 1.0f / (dz == 0.0f ? 1e-30f : dz);
  const float mnT = mn[i], mxT = mx[i];
  const int key = !(mnT <= mxT)
                      ? N_OCT
                      : (int)((__float_as_uint(ix) >> 31) |
                              ((__float_as_uint(iy) >> 31) << 1) |
                              ((__float_as_uint(iz) >> 31) << 2));
  if (tid < N_OCT * N_BOUND) {
    // neutral values: the minima's slots at the top of the order
    const int k = tid % N_BOUND;
    const bool is_min = k < 3 || (k >= 6 && k < 9) || k == 12;
    s.bound[tid / N_BOUND][k] = is_min ? 0xffffffffu : 0u;
  }
  if (tid < N_OCT) s.unsafe[tid] = 0u;
  int rank = 0;
#pragma unroll
  for (int o = 0; o < N_OCT; ++o) {
    const unsigned b = __ballot_sync(FULL, key == o);
    if (key == o) rank = __popc(b & ((1u << lane) - 1u));
    if (lane == 0) s_cnt[warp][o] = __popc(b);
  }
  __syncthreads();
  if (tid <= N_OCT) {
    int n = 0;
    for (int o = 0; o < tid; ++o)
      for (int k = 0; k < WARPS; ++k) n += s_cnt[k][o];
    s.beg[tid] = n;
  }
  // each warp's extent of each bucket, then the block's by shared atomics
  const float v[7] = {ox, oy, oz, ix, iy, iz, mnT};
  const bool bad = !(isfinite(ox) && isfinite(oy) && isfinite(oz) &&
                     isfinite(ix) && isfinite(iy) && isfinite(iz));
#pragma unroll 1
  for (int o = 0; o < N_OCT; ++o) {
    const bool in = key == o;
    if (__ballot_sync(FULL, in) == 0u) continue;
    unsigned lo[7], hi[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      lo[k] = __reduce_min_sync(FULL, in ? okey(v[k]) : 0xffffffffu);
      hi[k] = __reduce_max_sync(FULL, in ? okey(k == 6 ? mxT : v[k]) : 0u);
    }
    const unsigned u = __reduce_or_sync(FULL, in && bad ? 1u : 0u);
    if (lane == 0) {
      unsigned* b = s.bound[o];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        atomicMin(b + a, lo[a]);
        atomicMax(b + 3 + a, hi[a]);
        atomicMin(b + 6 + a, lo[3 + a]);
        atomicMax(b + 9 + a, hi[3 + a]);
      }
      atomicMin(b + 12, lo[6]);
      atomicMax(b + 13, hi[6]);
      atomicOr(s.unsafe + o, u);
    }
  }
  __syncthreads();
  if (key < N_OCT) {
    int pos = s.beg[key] + rank;
    for (int k = 0; k < warp; ++k) pos += s_cnt[k][key];
    s.om[pos] = make_float4(ox, oy, oz, mnT);
    s.ix[pos] = make_float4(ix, iy, iz, mxT);
    s.pbit[pos] = 1u << (tid >> 3);
  }
  if (tid < N_OCT * N_BOUND) {
    unsigned& b = s.bound[tid / N_BOUND][tid % N_BOUND];
    b = __float_as_uint(ofloat(b));
  }
  __syncthreads();
}

// kF2b: pi (the per-octant orderings) and the workgroups' direction sums
// (dsum, (W, 3)) are given; rows 3 and 4. kCount: steps is given
template <bool kF2b, bool kCount>
__global__ void __launch_bounds__(WG)
    packet_cull_kernel(const float* __restrict__ ro,
                       const float* __restrict__ rd,
                       const float* __restrict__ mn,
                       const float* __restrict__ mx,
                       const float* __restrict__ cl_lo,
                       const float* __restrict__ cl_hi,
                       const long long* __restrict__ pi,
                       const float* __restrict__ dsum, int C, int cp,
                       float entry_scale, int* __restrict__ meta,
                       unsigned long long* __restrict__ steps) {
  __shared__ Rays s;
  __shared__ int s_wmin0[2][WARPS], s_wmin3[2][WARPS];
  const int w = blockIdx.x, tid = threadIdx.x;
  bucket_rays(s, ro, rd, mn, mx);
  // f2b: the workgroup's octant, the signs of its direction sums
  const long long* __restrict__ order =
      kF2b ? pi + (size_t)((dsum[3 * w] < 0.0f) |
                           ((dsum[3 * w + 1] < 0.0f) << 1) |
                           ((dsum[3 * w + 2] < 0.0f) << 2)) * C
           : nullptr;
  int* __restrict__ m = meta + (size_t)w * META_ROWS * cp;
  int carry0 = cp - 1, carry3 = NO_ENTRY, count = 0;
  // kCount: select-form, plain-form, bounds tests, tests skipped
  unsigned long long n_sel = 0, n_plain = 0, n_bound = 0, n_skip = 0;
  for (int base = cp - WG, chunk = 0; base >= 0; base -= WG, ++chunk) {
    const int j = base + tid;
    const bool valid = j < C;
    const int id = valid ? (kF2b ? (int)order[j] : j) : 0;
    // a column past the clusters tests a point box and asks for no
    // bucket; its bits are dropped below
    float lo[3], hi[3];
    bool ordered = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = valid ? cl_lo[3 * id + a] : 0.0f;
      hi[a] = valid ? cl_hi[3 * id + a] : 0.0f;
      ordered &= lo[a] <= hi[a];
    }
    unsigned bits = 0u;
    float entry = INFINITY;
    // kCount: the warp's columns below C
    const int n_valid = kCount ? __popc(__ballot_sync(FULL, valid)) : 0;
    if (__all_sync(FULL, ordered)) {
#pragma unroll 1
      for (int o = 0; o < N_OCT; ++o) {
        const int b0 = s.beg[o], b1 = s.beg[o + 1];
        if (b0 == b1) continue;
        float nr[3], fr[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const bool neg = (o >> a) & 1;
          nr[a] = neg ? hi[a] : lo[a];
          fr[a] = neg ? lo[a] : hi[a];
        }
#ifdef X1_NO_BOUNDS
        const bool need = valid;   // x1_study.py's build: no bounds test
#else
        const bool need =
            valid && (s.unsafe[o] != 0u ||
                      !misses(reinterpret_cast<const float*>(s.bound[o]), o,
                              nr, fr));
#endif
        const bool run = __any_sync(FULL, need);
        if (kCount) {
          const unsigned long long n = n_valid * (unsigned long long)(b1 - b0);
          n_bound += s.unsafe[o] == 0u ? n_valid : 0;
          (run ? n_sel : n_skip) += n;
        }
        if (run) test_bucket<kF2b>(s, b0, b1, nr, fr, bits, entry);
      }
    } else {
      if (kCount) n_plain += (unsigned long long)n_valid * s.beg[N_OCT];
      test_plain<kF2b>(s, lo, hi, bits, entry);
    }
    if (!valid) bits = 0u;
    // row 0: j where a candidate, else the sentinel; row 3: its quantised
    // entry (clamp, then truncation, as .to(torch.int32))
    int v0 = bits ? j : cp - 1;
    int v3 = NO_ENTRY;
    if (kF2b && bits) {
      float qe = entry * entry_scale;
      qe = nmin(nmax(qe, 0.0f), 1073741824.0f);
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
    m[4 * cp + j] = kF2b && valid ? id : 0;
    m[5 * cp + j] = 0;
    m[6 * cp + j] = 0;
    m[7 * cp + j] = 0;
  }
  if (kCount && (tid & 31) == 0) {
    atomicAdd(steps + 0, n_sel);
    atomicAdd(steps + 1, n_plain);
    atomicAdd(steps + 2, n_bound);
    atomicAdd(steps + 3, n_skip);
  }
}

template <bool kF2b>
void launch(int n_work, cudaStream_t s, const float* ro, const float* rd,
            const float* mn, const float* mx, const float* cl_lo,
            const float* cl_hi, const long long* pi, const float* dsum, int C,
            int cp, float entry_scale, int* meta, unsigned long long* steps) {
  if (steps != nullptr)
    packet_cull_kernel<kF2b, true><<<n_work, WG, 0, s>>>(
        ro, rd, mn, mx, cl_lo, cl_hi, pi, dsum, C, cp, entry_scale, meta,
        steps);
  else
    packet_cull_kernel<kF2b, false><<<n_work, WG, 0, s>>>(
        ro, rd, mn, mx, cl_lo, cl_hi, pi, dsum, C, cp, entry_scale, meta,
        steps);
}

}  // namespace

extern "C" int vimg_packet_cull(const float* ro, const float* rd,
                                const float* mn, const float* mx,
                                const float* cl_lo, const float* cl_hi,
                                const long long* pi, const float* dsum,
                                int n_work, int C, int cp, float entry_scale,
                                int* meta, unsigned long long* steps,
                                void* stream) {
  if (cp % WG != 0 || cp <= C) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_work > 0 && pi != nullptr)
    launch<true>(n_work, s, ro, rd, mn, mx, cl_lo, cl_hi, pi, dsum, C, cp,
                 entry_scale, meta, steps);
  else if (n_work > 0)
    launch<false>(n_work, s, ro, rd, mn, mx, cl_lo, cl_hi, pi, dsum, C, cp,
                  entry_scale, meta, steps);
  return (int)cudaGetLastError();
}

// X1's registers and local bytes a thread, static shared bytes a block
// and resident blocks per SM (slist: f2b = 0; f2b: 1)
extern "C" int vimg_packet_cull_occupancy(int f2b, int* per_sm, int* regs,
                                          int* local_bytes, int* smem_bytes) {
  const void* fn = f2b ? (const void*)packet_cull_kernel<true, false>
                       : (const void*)packet_cull_kernel<false, false>;
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, fn);
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)attr.sharedSizeBytes;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, WG, 0);
  return (int)cudaGetLastError();
}
