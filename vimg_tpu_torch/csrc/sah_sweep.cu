// Kernel X3 of vimg_tpu_torch: the per-axis SAH sweep of the device BVH
// build (geometry/device_build.py::sah_sweep), for Hopper (sm_90a).
//
// Replaces: the scans and segment minima of one axis in
// vimg_tpu/geometry/device_build.py::_level (lines 104-134; XLA, not
// Pallas): segmented prefix and suffix min / max scans of the boxes in the
// axis's sorted order, the split cost at each position and, per segment,
// its least cost and the least left count nl that reaches it.
//
// Inputs, P positions in sorted order: seg_s[i], the segment start of
// position i (a segment is a run of equal seg_s); lo[i], hi[i], its box
// (3 floats each). Outputs, indexed by segment-start slot s = seg_s[i]:
// seg_cost[s], the least of
//   cost(i) = sa(prefix box of [s, i]) nl + sa(suffix box of [i+1, end))
//             nr,  nl = i - s + 1, nr = end - i - 1, INF where nr == 0,
// with sa(b) = d0 d1 + d0 d2 + d1 d2 of d = max(hi - lo, +0); and
// seg_j[s], the least nl at which cost(i) == seg_cost[s] (P + 1 when no
// position's cost equals it, i.e. a NaN minimum). Slots that start no
// segment get INF and INT32_MAX, jax.ops.segment_min's empty values.
//
// Design: four launches on the stream.
//   1. sweep_chunks: a block a chunk of 1,024 positions (256 threads x 4);
//      each chunk's segmented (min lo, max hi) aggregate in the prefix
//      direction and (min lo, max hi, end) in the suffix direction; it also
//      fills the outputs' slots with their empty values.
//   2. sweep_carries: one block scans the chunks' aggregates (a stripe of
//      chunks a thread) into each chunk's carry from the left and from the
//      right.
//   3. sweep_cost: each block rescans its chunk with the carries (a thread
//      folds its 4 positions, the block scans the threads' folds in shared
//      memory), computes cost(i), stores it, and takes each segment's
//      least cost: the lanes of a warp with the same segment reduce first
//      (__match_any_sync, __reduce_min_sync), then one atomicMin a group on
//      an order-preserving key of the cost (0 for NaN, so a NaN wins as in
//      segment_min; bits + 1 otherwise: every cost is +0 or more).
//   4. sweep_argmin: j(i) = cost(i) == seg_cost ? nl : P + 1, reduced the
//      same way into seg_j; every slot's key is decoded into seg_cost.
// Exactness: min / max are exact in any association (PTX min.NaN /
// max.NaN propagate NaN as torch.minimum does); every product and sum of
// the cost is __fmul_rn / __fadd_rn, never contracted; nl and nr convert
// with __int2float_rn as astype(float32); an atomic minimum is
// order-free. So X3 equals sah_sweep_plain bit for bit (NaN payloads
// aside).
// What bounds it on this card: its bound is bytes (seg_s and six floats
// a position read, two outputs written: 36 B a position); at the builds'
// sizes (10^5 to 5 x 10^5 positions) the latency of its four launches and
// of the one-block carry scan sets its time. Launches 1 and 3 read the
// inputs, 3 writes the cost and 4 reads it back with seg_s.
//
// Launch contract: vimg_sah_sweep() launches on the given stream, does not
// synchronise and allocates nothing (the caller's scratch holds 32 words a
// chunk and 2 P words); it returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;
constexpr int ITEMS = 4;
constexpr int CHUNK = BLOCK * ITEMS;  // device_build.py SWEEP_CHUNK
constexpr int CARRY_BLOCK = 1024;
constexpr int WORDS = 8;              // a Seg in scratch
constexpr unsigned FULL = 0xffffffffu;
constexpr int EMPTY_J = 0x7fffffff;
constexpr unsigned EMPTY_KEY = 0xffffffffu;

__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// An element of the segmented scan: whether a segment boundary lies in
// it (a start in the prefix direction, an end in the suffix direction),
// the running box since the last boundary and, in the suffix direction,
// the segment's end (its last position + 1, a running max).
struct Seg {
  int f;
  float lo[3], hi[3];
  int end;
};

__device__ __forceinline__ Seg identity() {
  Seg r;
  r.f = 0;
  for (int k = 0; k < 3; k++) {
    r.lo[k] = INFINITY;
    r.hi[k] = -INFINITY;
  }
  r.end = 0;
  return r;
}

// a earlier in scan order, b later: a boundary in b resets the run
__device__ __forceinline__ Seg combine(const Seg& a, const Seg& b) {
  if (b.f) return b;
  Seg r;
  r.f = a.f;
  for (int k = 0; k < 3; k++) {
    r.lo[k] = nmin(a.lo[k], b.lo[k]);
    r.hi[k] = nmax(a.hi[k], b.hi[k]);
  }
  r.end = max(a.end, b.end);
  return r;
}

__device__ __forceinline__ Seg shfl_up(const Seg& s, int d) {
  Seg r;
  r.f = __shfl_up_sync(FULL, s.f, d);
  for (int k = 0; k < 3; k++) {
    r.lo[k] = __shfl_up_sync(FULL, s.lo[k], d);
    r.hi[k] = __shfl_up_sync(FULL, s.hi[k], d);
  }
  r.end = __shfl_up_sync(FULL, s.end, d);
  return r;
}

__device__ __forceinline__ void store(float* p, const Seg& s) {
  p[0] = __int_as_float(s.f);
  for (int k = 0; k < 3; k++) {
    p[1 + k] = s.lo[k];
    p[4 + k] = s.hi[k];
  }
  p[7] = __int_as_float(s.end);
}

__device__ __forceinline__ Seg load(const float* p) {
  Seg s;
  s.f = __float_as_int(p[0]);
  for (int k = 0; k < 3; k++) {
    s.lo[k] = p[1 + k];
    s.hi[k] = p[4 + k];
  }
  s.end = __float_as_int(p[7]);
  return s;
}

// Exclusive scan of sh[0..N) in place (index order = scan order) by the
// block's first warp, each lane folding N / 32 entries; sh[N] gets the
// total. The caller synchronises before and after.
template <int N>
__device__ void warp0_exclusive(Seg* sh) {
  constexpr int PER = N / 32;
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  Seg tot = identity();
  for (int e = 0; e < PER; e++) tot = combine(tot, sh[lane * PER + e]);
  Seg inc = tot;
  for (int d = 1; d < 32; d *= 2) {
    const Seg o = shfl_up(inc, d);
    if (lane >= d) inc = combine(o, inc);
  }
  Seg ex = shfl_up(inc, 1);
  if (lane == 0) ex = identity();
  if (lane == 31) sh[N] = inc;
  for (int e = 0; e < PER; e++) {
    const Seg t = sh[lane * PER + e];
    sh[lane * PER + e] = ex;
    ex = combine(ex, t);
  }
}

// The boundary flags and box of position i (i < P)
__device__ __forceinline__ void element(const int* __restrict__ seg_s,
                                        const float* __restrict__ lo,
                                        const float* __restrict__ hi, int P,
                                        int i, Seg& pre, Seg& suf) {
  const int s = seg_s[i];
  pre.f = i == 0 || seg_s[i - 1] != s;
  suf.f = i == P - 1 || seg_s[i + 1] != s;
  for (int k = 0; k < 3; k++) {
    pre.lo[k] = suf.lo[k] = lo[3 * i + k];
    pre.hi[k] = suf.hi[k] = hi[3 * i + k];
  }
  pre.end = 0;
  suf.end = i + 1;
}

// The thread's positions [i0, i0 + ITEMS) of its chunk, clipped to P
__device__ __forceinline__ int first_pos() {
  return blockIdx.x * CHUNK + threadIdx.x * ITEMS;
}

// 1. each chunk's aggregates; empty values into the output slots
__global__ void __launch_bounds__(BLOCK)
    sweep_chunks(const int* __restrict__ seg_s, const float* __restrict__ lo,
                 const float* __restrict__ hi, int P,
                 unsigned* __restrict__ keys, int* __restrict__ seg_j,
                 float* __restrict__ agg) {
  __shared__ Seg sh_pre[BLOCK + 1], sh_suf[BLOCK + 1];
  const int i0 = first_pos();
  Seg ap = identity(), as = identity();
  for (int e = 0; e < ITEMS; e++) {
    const int i = i0 + e;
    if (i < P) {
      Seg p, s;
      element(seg_s, lo, hi, P, i, p, s);
      ap = combine(ap, p);
      keys[i] = EMPTY_KEY;
      seg_j[i] = EMPTY_J;
    }
  }
  // the suffix direction runs right to left: its own positions too
  for (int e = ITEMS - 1; e >= 0; e--) {
    const int i = i0 + e;
    if (i < P) {
      Seg p, s;
      element(seg_s, lo, hi, P, i, p, s);
      as = combine(as, s);
    }
  }
  sh_pre[threadIdx.x] = ap;
  sh_suf[BLOCK - 1 - threadIdx.x] = as;
  __syncthreads();
  warp0_exclusive<BLOCK>(sh_pre);
  __syncthreads();
  warp0_exclusive<BLOCK>(sh_suf);
  __syncthreads();
  if (threadIdx.x == 0) {
    float* a = agg + (size_t)blockIdx.x * 4 * WORDS;
    store(a, sh_pre[BLOCK]);
    store(a + WORDS, sh_suf[BLOCK]);
  }
}

// 2. each chunk's carries: from the left (prefix) and from the right
// (suffix), exclusive. Thread t folds a stripe of chunks in scan order.
__global__ void __launch_bounds__(CARRY_BLOCK)
    sweep_carries(int n_chunks, float* __restrict__ agg) {
  __shared__ Seg sh[CARRY_BLOCK + 1];
  const int stripe = (n_chunks + CARRY_BLOCK - 1) / CARRY_BLOCK;
  for (int dir = 0; dir < 2; dir++) {
    // q: the chunk's index in scan order; c: its index in the array
    Seg tot = identity();
    for (int e = 0; e < stripe; e++) {
      const int q = threadIdx.x * stripe + e;
      if (q < n_chunks) {
        const int c = dir == 0 ? q : n_chunks - 1 - q;
        tot = combine(tot, load(agg + (size_t)c * 4 * WORDS + dir * WORDS));
      }
    }
    sh[threadIdx.x] = tot;
    __syncthreads();
    warp0_exclusive<CARRY_BLOCK>(sh);
    __syncthreads();
    Seg run = sh[threadIdx.x];
    for (int e = 0; e < stripe; e++) {
      const int q = threadIdx.x * stripe + e;
      if (q < n_chunks) {
        const int c = dir == 0 ? q : n_chunks - 1 - q;
        float* a = agg + (size_t)c * 4 * WORDS;
        const Seg g = load(a + dir * WORDS);
        store(a + (2 + dir) * WORDS, run);
        run = combine(run, g);
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ float half_sa(const Seg& b) {
  float d[3];
  for (int k = 0; k < 3; k++) {
    const float x = __fsub_rn(b.hi[k], b.lo[k]);
    d[k] = x > 0.0f ? x : (x != x ? x : 0.0f);
  }
  return __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[1]), __fmul_rn(d[0], d[2])),
                   __fmul_rn(d[1], d[2]));
}

__device__ __forceinline__ unsigned cost_key(float c) {
  return c != c ? 0u : __float_as_uint(c) + 1u;
}

__device__ __forceinline__ float key_cost(unsigned k) {
  if (k == 0u) return __int_as_float(0x7fffffff);
  if (k == EMPTY_KEY) return INFINITY;
  return __uint_as_float(k - 1u);
}

// The least value of each group of lanes with the same segment, one
// atomicMin a group (lanes with valid = false take no part)
__device__ __forceinline__ void group_min(unsigned* dst_base, int s,
                                          unsigned v, bool valid) {
  const unsigned act = __ballot_sync(FULL, valid);
  if (!valid) return;
  const unsigned peers = __match_any_sync(act, s);
  const unsigned m = __reduce_min_sync(peers, v);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicMin(dst_base + s, m);
}

// 3. costs, and each segment's least cost (as keys)
__global__ void __launch_bounds__(BLOCK)
    sweep_cost(const int* __restrict__ seg_s, const float* __restrict__ lo,
               const float* __restrict__ hi, int P,
               const float* __restrict__ agg, float* __restrict__ cost,
               unsigned* __restrict__ keys) {
  __shared__ Seg sh_pre[BLOCK + 1], sh_suf[BLOCK + 1];
  const int i0 = first_pos();
  Seg ap = identity(), as = identity();
  Seg ep[ITEMS], es[ITEMS];
  for (int e = 0; e < ITEMS; e++) {
    if (i0 + e < P) {
      element(seg_s, lo, hi, P, i0 + e, ep[e], es[e]);
      ap = combine(ap, ep[e]);
    }
  }
  for (int e = ITEMS - 1; e >= 0; e--)
    if (i0 + e < P) as = combine(as, es[e]);
  sh_pre[threadIdx.x] = ap;
  sh_suf[BLOCK - 1 - threadIdx.x] = as;
  __syncthreads();
  warp0_exclusive<BLOCK>(sh_pre);
  __syncthreads();
  warp0_exclusive<BLOCK>(sh_suf);
  __syncthreads();
  const float* a = agg + (size_t)blockIdx.x * 4 * WORDS;
  Seg run_p = combine(load(a + 2 * WORDS), sh_pre[threadIdx.x]);
  Seg run_s = combine(load(a + 3 * WORDS), sh_suf[BLOCK - 1 - threadIdx.x]);
  // the suffix excluding each position: right to left
  Seg ex_s[ITEMS];
  for (int e = ITEMS - 1; e >= 0; e--) {
    ex_s[e] = run_s;
    if (i0 + e < P) run_s = combine(run_s, es[e]);
  }
  for (int e = 0; e < ITEMS; e++) {
    const int i = i0 + e;
    const bool in = i < P;
    float c = 0.0f;
    int s = 0;
    if (in) {
      run_p = combine(run_p, ep[e]);
      s = seg_s[i];
      const int seg_end = es[e].f ? i + 1 : ex_s[e].end;
      const int nl = i - s + 1;
      const int nr = seg_end - i - 1;
      c = nr > 0 ? __fadd_rn(__fmul_rn(half_sa(run_p), __int2float_rn(nl)),
                             __fmul_rn(half_sa(ex_s[e]), __int2float_rn(nr)))
                 : INFINITY;
      cost[i] = c;
    }
    group_min(keys, s, cost_key(c), in);
  }
}

// 4. the least nl at each segment's least cost; keys decoded
__global__ void __launch_bounds__(BLOCK)
    sweep_argmin(const int* __restrict__ seg_s, int P,
                 const float* __restrict__ cost,
                 const unsigned* __restrict__ keys,
                 float* __restrict__ seg_cost, int* __restrict__ seg_j) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const bool in = i < P;
  int s = 0;
  unsigned j = 0u;
  if (in) {
    s = seg_s[i];
    const float cmin = key_cost(keys[s]);
    j = cost[i] == cmin ? (unsigned)(i - s + 1) : (unsigned)(P + 1);
    seg_cost[i] = key_cost(keys[i]);
  }
  group_min(reinterpret_cast<unsigned*>(seg_j), s, j, in);
}

}  // namespace

extern "C" int vimg_sah_sweep(const int* seg_s, const float* lo,
                              const float* hi, int P, float* seg_cost,
                              int* seg_j, float* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_chunks = (P + CHUNK - 1) / CHUNK;
  float* agg = scratch;
  float* cost = scratch + (size_t)n_chunks * 4 * WORDS;
  unsigned* keys = reinterpret_cast<unsigned*>(cost + P);
  sweep_chunks<<<n_chunks, BLOCK, 0, st>>>(seg_s, lo, hi, P, keys, seg_j,
                                           agg);
  sweep_carries<<<1, CARRY_BLOCK, 0, st>>>(n_chunks, agg);
  sweep_cost<<<n_chunks, BLOCK, 0, st>>>(seg_s, lo, hi, P, agg, cost, keys);
  sweep_argmin<<<(P + BLOCK - 1) / BLOCK, BLOCK, 0, st>>>(seg_s, P, cost,
                                                          keys, seg_cost,
                                                          seg_j);
  return (int)cudaGetLastError();
}
