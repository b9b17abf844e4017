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
// Design: one cooperative launch (cudaLaunchCooperativeKernel) of G
// blocks of 256 threads, all resident at once, in three phases separated
// by grid-wide barriers (cooperative_groups::this_grid().sync()).
// Block b owns tile b: k chunks of CHUNK = 1,024 positions (a thread 4
// consecutive positions a chunk), tiles in position order. The host picks
// G and k with the occupancy API: the most blocks a chunk each, or fewer
// blocks of more chunks, such that a block's inputs fit in its dynamic
// shared memory (28 B a position) and G blocks are resident; then the
// inputs are staged there in phase 1 and read from HBM once. Where no
// such G exists (P above about 10^6) the tiles are as large as the
// resident grid needs and phase 2 reads its inputs from HBM again.
//   1. Each chunk's segmented (min lo, max hi) aggregate in the prefix
//      direction (the box since the chunk's last segment start, and
//      whether it holds one) and in the suffix direction (the box up to
//      its first segment end, that end, and whether it holds one), by a
//      block scan of both directions under one pair of barriers; the
//      tile's two aggregates folded from its chunks' into scratch, and
//      (k > 1) each chunk's suffix aggregate. Every key slot of the tile's
//      range is set to its empty value.
//   2. Each tile's carry from the left and from the right by a look-back
//      over the finished tile aggregates: the block reads 256 tiles a
//      step (a thread one, the nearest first), folds them by a
//      segmented block scan, and stops at the first step that holds a
//      boundary of the segment crossing in (tile 0 holds position 0, a
//      start; the last tile holds P - 1, an end). With G <= 256 that is
//      one step in each direction. The tile's chunks get their right
//      carries by one block scan over their suffix aggregates (k > 1).
//      Then each chunk in turn
//      is rescanned with its carries (thread folds, warp shuffles, the
//      block's warp totals in shared memory), each position's cost is
//      computed, and each segment's least key over the chunk's positions
//      is taken by a segmented block scan of the keys (reset at segment
//      ends) and committed by one 64-bit atomicMin at the segment's first
//      position in the chunk. The key is (order-preserving cost key << 32)
//      | nl, the cost key 0 for NaN and its bits + 1 otherwise (every cost
//      is +0 or more): the least key is the least cost and, among equal
//      costs, the least nl, in one atomic.
//   3. Each slot's key of the tile's range decoded into seg_cost and seg_j:
//      the empty key to INF and INT32_MAX, a NaN key to NaN and P + 1 (in
//      the plain version cost == seg_cost is false for NaN).
// The barriers order phase 1's key fill before every atomic and the
// atomics before the decode; scratch written in this launch is read with
// ld.global.cg (L2), never through L1 or the read-only path.
// Exactness: min / max are exact in any association (PTX min.NaN /
// max.NaN propagate NaN as torch.minimum does); every product and sum of
// the cost is __fmul_rn / __fadd_rn, never contracted; nl and nr convert
// with __int2float_rn as astype(float32); an atomic minimum is
// order-free. So X3 equals sah_sweep_plain bit for bit (NaN payloads
// aside). geometry/sweep_schedule.py replays this decomposition on the CPU.
// What bounds it on this card: its bound is bytes (seg_s and six floats
// a position read, two outputs written: 36 B a position); at the builds'
// sizes (10^5 to 5 x 10^5 positions, 0.0011-0.0054 ms of bytes) latency
// sets its time: x3_study.py, which builds it with X3_PHASES cut short,
// splits it into the launch with its two barriers and each phase's
// chain of loads, block scans and barriers within a block (one block on
// one chunk takes most of what 98 blocks take). The block scans take both
// directions at once wherever both are needed, to halve the barriers.
//
// Launch contract: vimg_sah_sweep() launches on the given stream, does not
// synchronise and allocates nothing (the caller's scratch holds 24 words a
// chunk and 2 P words); it returns the launch's error: a refused
// cooperative launch is returned, never replaced by another launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BLOCK = 256;
constexpr int WARPS = BLOCK / 32;
constexpr int ITEMS = 4;
constexpr int CHUNK = BLOCK * ITEMS;  // device_build.py SWEEP_CHUNK
constexpr int WORDS = 8;              // a Seg in scratch
constexpr int STAGE_BYTES = 28;       // a staged position: seg_s, lo, hi
constexpr unsigned FULL = 0xffffffffu;
constexpr int EMPTY_J = 0x7fffffff;
constexpr unsigned long long EMPTY_KEY = ~0ull;
// the phases a launch runs, 3 as shipped; x3_study.py builds 0-2 (the
// launch and its two barriers, then each phase added) to split X3's time
#ifndef X3_PHASES
#define X3_PHASES 3
#endif

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

// An element of the segmented box scan: whether a segment boundary lies in
// it (a start in the prefix direction, an end in the suffix direction),
// the running box since the last boundary and, in the suffix direction,
// the segment's end (its last position + 1, a running max).
struct Seg {
  int f;
  float lo[3], hi[3];
  int end;
};

// An element of the segmented key minimum (suffix direction, reset at
// segment ends)
struct KSeg {
  int f;
  unsigned long long k;
};

template <class T>
__device__ __forceinline__ T identity();

template <>
__device__ __forceinline__ Seg identity<Seg>() {
  Seg r;
  r.f = 0;
  for (int k = 0; k < 3; k++) {
    r.lo[k] = INFINITY;
    r.hi[k] = -INFINITY;
  }
  r.end = 0;
  return r;
}

template <>
__device__ __forceinline__ KSeg identity<KSeg>() {
  KSeg r;
  r.f = 0;
  r.k = EMPTY_KEY;
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

__device__ __forceinline__ KSeg combine(const KSeg& a, const KSeg& b) {
  if (b.f) return b;
  KSeg r;
  r.f = a.f;
  r.k = a.k < b.k ? a.k : b.k;
  return r;
}

// lane - d (REV: lane + d) of the warp
template <bool REV>
__device__ __forceinline__ int shfl(int v, int d) {
  return REV ? __shfl_down_sync(FULL, v, d) : __shfl_up_sync(FULL, v, d);
}
template <bool REV>
__device__ __forceinline__ float shfl(float v, int d) {
  return REV ? __shfl_down_sync(FULL, v, d) : __shfl_up_sync(FULL, v, d);
}
template <bool REV>
__device__ __forceinline__ unsigned long long shfl(unsigned long long v,
                                                   int d) {
  return REV ? __shfl_down_sync(FULL, v, d) : __shfl_up_sync(FULL, v, d);
}

template <bool REV>
__device__ __forceinline__ Seg shfl(const Seg& s, int d) {
  Seg r;
  r.f = shfl<REV>(s.f, d);
  for (int k = 0; k < 3; k++) {
    r.lo[k] = shfl<REV>(s.lo[k], d);
    r.hi[k] = shfl<REV>(s.hi[k], d);
  }
  r.end = shfl<REV>(s.end, d);
  return r;
}

template <bool REV>
__device__ __forceinline__ KSeg shfl(const KSeg& s, int d) {
  KSeg r;
  r.f = shfl<REV>(s.f, d);
  r.k = shfl<REV>(s.k, d);
  return r;
}

// The warp's part of an exclusive segmented scan in lane order or (REV)
// in reverse lane order: inc, the inclusive value, and ex, the exclusive
template <bool REV, class T>
__device__ __forceinline__ void warp_scan(const T& x, T& inc, T& ex) {
  const int lane = threadIdx.x & 31;
  inc = x;
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const T o = shfl<REV>(inc, d);
    if (REV ? lane + d < 32 : lane >= d) inc = combine(o, inc);
  }
  ex = shfl<REV>(inc, 1);
  if (lane == (REV ? 31 : 0)) ex = identity<T>();
}

// The block's part, after the warps' inclusive totals are in sh:
// combine(carry, the warps before this one in scan order, ex); *total,
// where given, gets combine(carry, every warp)
template <bool REV, class T>
__device__ __forceinline__ T block_part(const T& carry, const T* sh,
                                        const T& ex, T* total) {
  const int warp = threadIdx.x >> 5;
  T run = carry;
#pragma unroll
  for (int q = 0; q < WARPS; q++) {
    const int w = REV ? WARPS - 1 - q : q;
    if (w == warp) break;
    run = combine(run, sh[w]);
  }
  if (total) {
    T t = carry;
#pragma unroll
    for (int q = 0; q < WARPS; q++) t = combine(t, sh[REV ? WARPS - 1 - q : q]);
    *total = t;
  }
  return combine(run, ex);
}

// Exclusive segmented scan over the block's threads, in thread order or
// (REV) in reverse thread order: returns combine(carry, the elements of
// the threads before this one in scan order); *total, where given, gets
// combine(carry, every element). sh: WARPS elements of shared memory.
// Every thread of the block calls it; it synchronises the block twice.
template <bool REV, class T>
__device__ __forceinline__ T block_scan(const T& x, const T& carry, T* sh,
                                        T* total) {
  T inc, ex;
  warp_scan<REV>(x, inc, ex);
  if ((threadIdx.x & 31) == (REV ? 0 : 31)) sh[threadIdx.x >> 5] = inc;
  __syncthreads();
  const T r = block_part<REV>(carry, sh, ex, total);
  __syncthreads();
  return r;
}

// Both directions under one pair of barriers: the prefix-direction scan
// of xp in thread order into ex_p (total *tot_p) and the suffix-direction
// scan of xs in reverse thread order into ex_s (total *tot_s). sh: 2 WARPS
// Segs of shared memory.
__device__ __forceinline__ void block_scan2(const Seg& xp, const Seg& cp,
                                            const Seg& xs, const Seg& cs,
                                            Seg* sh, Seg& ex_p, Seg& ex_s,
                                            Seg* tot_p, Seg* tot_s) {
  Seg ip, ep, is, es;
  warp_scan<false>(xp, ip, ep);
  warp_scan<true>(xs, is, es);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 31) sh[warp] = ip;
  if (lane == 0) sh[WARPS + warp] = is;
  __syncthreads();
  ex_p = block_part<false>(cp, sh, ep, tot_p);
  ex_s = block_part<true>(cs, sh + WARPS, es, tot_s);
  __syncthreads();
}

__device__ __forceinline__ void store_seg(float* p, const Seg& s) {
  reinterpret_cast<float4*>(p)[0] =
      make_float4(__int_as_float(s.f), s.lo[0], s.lo[1], s.lo[2]);
  reinterpret_cast<float4*>(p)[1] =
      make_float4(s.hi[0], s.hi[1], s.hi[2], __int_as_float(s.end));
}

// scratch written in this launch: through L2 only
__device__ __forceinline__ Seg load_seg(const float* p) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  Seg s;
  s.f = __float_as_int(a.x);
  s.lo[0] = a.y;
  s.lo[1] = a.z;
  s.lo[2] = a.w;
  s.hi[0] = b.x;
  s.hi[1] = b.y;
  s.hi[2] = b.z;
  s.end = __float_as_int(b.w);
  return s;
}

// A thread's positions i0 .. i0 + n - 1 (n <= ITEMS) of a chunk: segment
// starts, boxes and boundary flags
struct Items {
  int i0, n;
  int s[ITEMS];
  float lo[ITEMS][3], hi[ITEMS][3];
  bool st[ITEMS], en[ITEMS];
};

// seg, lo, hi hold position i at index i - base (the staged tile in
// shared memory, or the inputs themselves with base 0); g_seg is the
// input, read for the neighbours outside the thread's positions
__device__ __forceinline__ void load_items(Items& it, const int* seg,
                                           const float* lo, const float* hi,
                                           int base,
                                           const int* __restrict__ g_seg,
                                           int P, int i0, int cend) {
  it.i0 = i0;
  it.n = max(0, min(ITEMS, cend - i0));
  const int x = i0 - base;
  if (it.n == ITEMS) {
    const int4 s4 = *reinterpret_cast<const int4*>(seg + x);
    it.s[0] = s4.x;
    it.s[1] = s4.y;
    it.s[2] = s4.z;
    it.s[3] = s4.w;
    const float4* l4 = reinterpret_cast<const float4*>(lo + 3 * x);
    const float4* h4 = reinterpret_cast<const float4*>(hi + 3 * x);
    float l[12], h[12];
    #pragma unroll
    for (int q = 0; q < 3; q++) {
      const float4 a = l4[q], b = h4[q];
      l[4 * q] = a.x;
      l[4 * q + 1] = a.y;
      l[4 * q + 2] = a.z;
      l[4 * q + 3] = a.w;
      h[4 * q] = b.x;
      h[4 * q + 1] = b.y;
      h[4 * q + 2] = b.z;
      h[4 * q + 3] = b.w;
    }
    #pragma unroll
    for (int e = 0; e < ITEMS; e++)
      for (int k = 0; k < 3; k++) {
        it.lo[e][k] = l[3 * e + k];
        it.hi[e][k] = h[3 * e + k];
      }
  } else {
    #pragma unroll
    for (int e = 0; e < ITEMS; e++) {
      it.s[e] = 0;
      for (int k = 0; k < 3; k++) it.lo[e][k] = it.hi[e][k] = 0.0f;
      if (e < it.n) {
        it.s[e] = seg[x + e];
        for (int k = 0; k < 3; k++) {
          it.lo[e][k] = lo[3 * (x + e) + k];
          it.hi[e][k] = hi[3 * (x + e) + k];
        }
      }
    }
  }
  const int prev = it.n > 0 && i0 > 0 ? __ldg(g_seg + i0 - 1) : 0;
  const int next = it.n > 0 && i0 + it.n < P ? __ldg(g_seg + i0 + it.n) : 0;
  #pragma unroll
  for (int e = 0; e < ITEMS; e++) {
    const int i = i0 + e;
    it.st[e] = i == 0 || (e == 0 ? prev : it.s[max(e - 1, 0)]) != it.s[e];
    it.en[e] = i == P - 1 ||
               (e + 1 < it.n ? it.s[min(e + 1, ITEMS - 1)] : next) != it.s[e];
  }
}

__device__ __forceinline__ Seg pre_elem(const Items& it, int e) {
  Seg r;
  r.f = it.st[e];
  for (int k = 0; k < 3; k++) {
    r.lo[k] = it.lo[e][k];
    r.hi[k] = it.hi[e][k];
  }
  r.end = 0;
  return r;
}

__device__ __forceinline__ Seg suf_elem(const Items& it, int e) {
  Seg r = pre_elem(it, e);
  r.f = it.en[e];
  r.end = it.i0 + e + 1;
  return r;
}

// the thread's fold in the prefix direction (left to right)
__device__ __forceinline__ Seg fold_pre(const Items& it) {
  Seg a = identity<Seg>();
  #pragma unroll
  for (int e = 0; e < ITEMS; e++)
    if (e < it.n) a = combine(a, pre_elem(it, e));
  return a;
}

// ... and in the suffix direction (right to left)
__device__ __forceinline__ Seg fold_suf(const Items& it) {
  Seg a = identity<Seg>();
  #pragma unroll
  for (int e = ITEMS - 1; e >= 0; e--)
    if (e < it.n) a = combine(a, suf_elem(it, e));
  return a;
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

// Tile b: chunks [b k, b k + k) of positions [r0, r1). Scratch: tile_agg
// 2 Segs a tile (prefix, suffix), chunk_agg a Seg a chunk (the chunk's
// suffix aggregate after phase 1, its right carry in phase 2), keys P.
__global__ void __launch_bounds__(BLOCK, 2)
    sah_sweep_coop(const int* __restrict__ seg_s,
                   const float* __restrict__ lo,
                   const float* __restrict__ hi, int P, int k, int n_tiles,
                   int staged, unsigned long long* keys, float* tile_agg,
                   float* chunk_agg, float* __restrict__ seg_cost,
                   int* __restrict__ seg_j) {
  extern __shared__ float4 dyn[];
  __shared__ Seg sh[2 * WARPS];
  __shared__ KSeg sh_k[WARPS];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int R = k * CHUNK;
  const int r0 = b * R, r1 = min(r0 + R, P);
  const int nk = (r1 - r0 + CHUNK - 1) / CHUNK;  // the tile's chunks
  int* s_seg = reinterpret_cast<int*>(dyn);
  float* s_lo = reinterpret_cast<float*>(s_seg + R);
  float* s_hi = s_lo + 3 * R;
  const int* src_seg = staged ? s_seg : seg_s;
  const float* src_lo = staged ? s_lo : lo;
  const float* src_hi = staged ? s_hi : hi;
  const int base = staged ? r0 : 0;

  // ---- phase 1: aggregates, empty keys
  if (X3_PHASES >= 1 && staged) {
    const int n = r1 - r0;
    const int n4 = n / 4, f4 = 3 * n / 4;
    const int4* g4 = reinterpret_cast<const int4*>(seg_s + r0);
    const float4* l4 = reinterpret_cast<const float4*>(lo + 3 * (size_t)r0);
    const float4* h4 = reinterpret_cast<const float4*>(hi + 3 * (size_t)r0);
    for (int j = tid; j < n4; j += BLOCK)
      reinterpret_cast<int4*>(s_seg)[j] = __ldg(g4 + j);
    for (int j = tid; j < f4; j += BLOCK) {
      reinterpret_cast<float4*>(s_lo)[j] = __ldg(l4 + j);
      reinterpret_cast<float4*>(s_hi)[j] = __ldg(h4 + j);
    }
    for (int j = 4 * n4 + tid; j < n; j += BLOCK) s_seg[j] = seg_s[r0 + j];
    for (int j = 4 * f4 + tid; j < 3 * n; j += BLOCK) {
      s_lo[j] = lo[3 * (size_t)r0 + j];
      s_hi[j] = hi[3 * (size_t)r0 + j];
    }
    __syncthreads();
  }
  if (X3_PHASES >= 1) {
    for (int i = r0 + tid; i < r1; i += BLOCK) keys[i] = EMPTY_KEY;
    Seg tp = identity<Seg>(), ts = identity<Seg>();
    for (int j = 0; j < nk; j++) {
      const int c0 = r0 + j * CHUNK;
      Items it;
      load_items(it, src_seg, src_lo, src_hi, base, seg_s, P,
                 c0 + tid * ITEMS, min(c0 + CHUNK, r1));
      Seg cp, cs, unused_p, unused_s;
      block_scan2(fold_pre(it), identity<Seg>(), fold_suf(it),
                  identity<Seg>(), sh, unused_p, unused_s, &cp, &cs);
      if (tid == 0 && k > 1)
        store_seg(chunk_agg + (size_t)(b * k + j) * WORDS, cs);
      tp = combine(tp, cp);
      ts = combine(cs, ts);
    }
    if (tid == 0) {
      store_seg(tile_agg + (size_t)b * 2 * WORDS, tp);
      store_seg(tile_agg + (size_t)b * 2 * WORDS + WORDS, ts);
    }
  }
  grid.sync();

  // ---- phase 2: look-back, chunk carries, costs, segment minima
  if (X3_PHASES >= 2) {
    Seg carry_p = identity<Seg>(), carry_s = identity<Seg>();
    bool need_p = b > 0, need_s = b + 1 < n_tiles;
    for (int w = 0; need_p || need_s; w++) {
      // window w: tiles b - 256 (w + 1) .. b - 256 w - 1 to the left and
      // b + 1 + 256 w .. b + 256 (w + 1) to the right, a tile a thread
      const int tl = b - BLOCK * (w + 1) + tid;
      const int tr = b + 1 + BLOCK * w + tid;
      Seg xp = identity<Seg>(), xs = identity<Seg>();
      if (need_p && tl >= 0) xp = load_seg(tile_agg + (size_t)tl * 2 * WORDS);
      if (need_s && tr < n_tiles)
        xs = load_seg(tile_agg + (size_t)tr * 2 * WORDS + WORDS);
      Seg t_p, t_s, unused_p, unused_s;
      block_scan2(xp, identity<Seg>(), xs, identity<Seg>(), sh, unused_p,
                  unused_s, &t_p, &t_s);
      if (need_p) {
        carry_p = combine(t_p, carry_p);
        need_p = !t_p.f && b - BLOCK * (w + 1) > 0;
      }
      if (need_s) {
        carry_s = combine(t_s, carry_s);
        need_s = !t_s.f && b + 1 + BLOCK * (w + 1) < n_tiles;
      }
    }
    // each chunk's carry from the right (k > 1), 256 chunks a round
    if (k > 1) {
      Seg run = carry_s;
      for (int top = nk - 1; top >= 0; top -= BLOCK) {
        const int j = top - (BLOCK - 1) + tid;
        float* slot = chunk_agg + (size_t)(b * k + j) * WORDS;
        const Seg x = j >= 0 ? load_seg(slot) : identity<Seg>();
        Seg tot;
        const Seg ex = block_scan<true>(x, run, sh, &tot);
        if (j >= 0) store_seg(slot, ex);
        run = tot;
      }
      __syncthreads();
    }
    Seg run_p = carry_p;
    for (int j = 0; j < nk; j++) {
      const int c0 = r0 + j * CHUNK;
      const Seg c_s =
          k > 1 ? load_seg(chunk_agg + (size_t)(b * k + j) * WORDS) : carry_s;
      Items it;
      load_items(it, src_seg, src_lo, src_hi, base, seg_s, P,
                 c0 + tid * ITEMS, min(c0 + CHUNK, r1));
      Seg ex_p, ex_s, tot_p;
      block_scan2(fold_pre(it), run_p, fold_suf(it), c_s, sh, ex_p, ex_s,
                  &tot_p, (Seg*)nullptr);
      run_p = tot_p;
      // the box of [i + 1, end) and the segment's end, right to left
      float sa_r[ITEMS];
      int seg_end[ITEMS];
      Seg r = ex_s;
      #pragma unroll
      for (int e = ITEMS - 1; e >= 0; e--) {
        sa_r[e] = 0.0f;
        seg_end[e] = 0;
        if (e < it.n) {
          sa_r[e] = half_sa(r);
          seg_end[e] = it.en[e] ? it.i0 + e + 1 : r.end;
          r = combine(r, suf_elem(it, e));
        }
      }
      // the prefix box of [s, i], the cost and its key, left to right
      unsigned long long key[ITEMS];
      Seg p = ex_p;
      #pragma unroll
      for (int e = 0; e < ITEMS; e++) {
        key[e] = EMPTY_KEY;
        if (e < it.n) {
          const int i = it.i0 + e;
          p = combine(p, pre_elem(it, e));
          const int nl = i - it.s[e] + 1;
          const int nr = seg_end[e] - i - 1;
          const float c =
              nr > 0 ? __fadd_rn(__fmul_rn(half_sa(p), __int2float_rn(nl)),
                                 __fmul_rn(sa_r[e], __int2float_rn(nr)))
                     : INFINITY;
          key[e] = ((unsigned long long)cost_key(c) << 32) | (unsigned)nl;
        }
      }
      // each segment's least key over the chunk: a suffix-direction scan
      // reset at segment ends, committed at the segment's first position
      // in the chunk
      KSeg kt = identity<KSeg>();
      #pragma unroll
      for (int e = ITEMS - 1; e >= 0; e--)
        if (e < it.n) kt = combine(kt, KSeg{it.en[e], key[e]});
      KSeg kr = block_scan<true>(kt, identity<KSeg>(), sh_k, (KSeg*)nullptr);
      #pragma unroll
      for (int e = ITEMS - 1; e >= 0; e--) {
        if (e < it.n) {
          kr = combine(kr, KSeg{it.en[e], key[e]});
          if (it.st[e] || it.i0 + e == c0)
            atomicMin(keys + it.s[e], kr.k);
        }
      }
    }
  }
  grid.sync();

  // ---- phase 3: decode the tile's slots
  for (int i = r0 + tid; X3_PHASES >= 3 && i < r1; i += BLOCK) {
    const unsigned long long key = __ldcg(keys + i);
    float c = INFINITY;
    int j = EMPTY_J;
    if (key != EMPTY_KEY) {
      const unsigned ck = (unsigned)(key >> 32);
      c = ck == 0u ? __int_as_float(0x7fffffff) : __uint_as_float(ck - 1u);
      j = ck == 0u ? P + 1 : (int)(unsigned)key;
    }
    seg_cost[i] = c;
    seg_j[i] = j;
  }
}

// The launch's shape for P positions on the current device: grid G,
// chunks a tile k, dynamic shared memory bytes (0: not staged), and the
// occupancy it was checked against
struct Plan {
  int grid, k, smem, per_sm;
};

constexpr int MAX_DEVICES = 64;
int g_sms[MAX_DEVICES];
int g_max_dyn[MAX_DEVICES];

cudaError_t plan_for(int P, Plan* pl) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (g_sms[dev] == 0) {
    int coop = 0, sms = 0, optin = 0;
    cudaFuncAttributes fa;
    if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                    dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
            cudaSuccess ||
        (e = cudaFuncGetAttributes(&fa, sah_sweep_coop)) != cudaSuccess)
      return e;
    if (!coop) return cudaErrorNotSupported;
    const int max_dyn = optin - (int)fa.sharedSizeBytes;
    e = cudaFuncSetAttribute(sah_sweep_coop,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_dyn);
    if (e != cudaSuccess) return e;
    g_max_dyn[dev] = max_dyn;
    g_sms[dev] = sms;
  }
  const int sms = g_sms[dev];
  const int n_chunks = (P + CHUNK - 1) / CHUNK;
  int occ0 = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ0, sah_sweep_coop,
                                                    BLOCK, 0);
  if (e != cudaSuccess) return e;
  if (occ0 < 1) return cudaErrorCooperativeLaunchTooLarge;
  // staged: the most blocks per SM whose tiles fit in shared memory
  for (int bps = occ0; bps >= 1; bps--) {
    const int g0 = min(bps * sms, n_chunks);
    const int k = (n_chunks + g0 - 1) / g0;
    const int grid = (n_chunks + k - 1) / k;
    const long long bytes = (long long)k * CHUNK * STAGE_BYTES;
    if (bytes > g_max_dyn[dev]) continue;
    int occ = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, sah_sweep_coop,
                                                      BLOCK, (size_t)bytes);
    if (e != cudaSuccess) return e;
    if ((long long)occ * sms >= grid) {
      *pl = Plan{grid, k, (int)bytes, occ};
      return cudaSuccess;
    }
  }
  // not staged: tiles as large as the resident grid needs
  const int g0 = min(occ0 * sms, n_chunks);
  const int k = (n_chunks + g0 - 1) / g0;
  *pl = Plan{(n_chunks + k - 1) / k, k, 0, occ0};
  return cudaSuccess;
}

}  // namespace

extern "C" int vimg_sah_sweep(const int* seg_s, const float* lo,
                              const float* hi, int P, float* seg_cost,
                              int* seg_j, float* scratch, void* stream) {
  Plan pl;
  cudaError_t e = plan_for(P, &pl);
  if (e != cudaSuccess) return (int)e;
  const int n_chunks = (P + CHUNK - 1) / CHUNK;
  float* tile_agg = scratch;
  float* chunk_agg = scratch + (size_t)n_chunks * 2 * WORDS;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(
      chunk_agg + (size_t)n_chunks * WORDS);
  int n_tiles = pl.grid, staged = pl.smem > 0;
  void* args[] = {(void*)&seg_s,    (void*)&lo,        (void*)&hi,
                  (void*)&P,        (void*)&pl.k,      (void*)&n_tiles,
                  (void*)&staged,   (void*)&keys,      (void*)&tile_agg,
                  (void*)&chunk_agg, (void*)&seg_cost, (void*)&seg_j};
  e = cudaLaunchCooperativeKernel((const void*)sah_sweep_coop, dim3(pl.grid),
                                  dim3(BLOCK), args, (size_t)pl.smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // leave no error behind for the next launch
    return (int)e;
  }
  return (int)cudaGetLastError();
}

// The plan a call with P positions takes on the current device, and the
// kernel's registers a thread (host int pointers)
extern "C" int vimg_sah_sweep_plan(int P, int* grid, int* tile_chunks,
                                   int* smem_bytes, int* per_sm, int* regs) {
  Plan pl;
  cudaError_t e = plan_for(P, &pl);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, sah_sweep_coop);
  if (e != cudaSuccess) return (int)e;
  *grid = pl.grid;
  *tile_chunks = pl.k;
  *smem_bytes = pl.smem;
  *per_sm = pl.per_sm;
  *regs = fa.numRegs;
  return 0;
}
