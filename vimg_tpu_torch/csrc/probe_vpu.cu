// Arithmetic-rate probes for Hopper (sm_90a): kernels P12-P15 and P20 of
// vimg_tpu_torch's probes (probes/probe_prims.py, probe_vpu2.py,
// probe_vpu3.py, probe_r2c.py).
//
// Replaces:
//   P12 tools/probe_prims.py::run / make_kernel (pallas_call :73): a loop
//       of ITERS steps over a (16, 128) float32 tile whose body is n_rep
//       copies of one primitive: vec22 (11 x v*1.000001 + 1e-7), anyred
//       (any(v > 100) into an int32 carry), cond (a branch on any()),
//       vload / sload (6 dynamic-offset scalar reads of an (8, 128) table
//       from device memory / shared memory). Output v + acc * 1e-20.
//   P13 tools/probe_vpu2.py::fma_throughput (pallas_call :59): 8
//       independent chains a*1.000001 + 1e-7 (i+1) over a (32, 128) tile,
//       300 steps, summed.
//   P14 tools/probe_vpu2.py::mix_throughput (pallas_call :91): a 4-state
//       multiply-add + compare + select mix, 200 steps.
//   P15 tools/probe_vpu3.py::run (pallas_call :55), its four bodies (:67,
//       :84, :103, :118): f32 compare + bf16 select, f32 compare +
//       arithmetic select, bf16 multiply with f32 state, bf16 sqrt / exp;
//       200 steps.
//   P20 tools/probe_r2c.py::vpu_rate (pallas_call :203): two dependent
//       chains, 2,000 steps.
//
// Design:
//  - The TPU's (rows, 128) tile is one block; every element's chain runs in
//    one thread (P12: 256 threads of 8 elements; the others: 1024 threads
//    of 4 float32 elements or 2 bf16 pairs). An any() over the tile is a
//    block-wide vote (__syncthreads_or).
//  - Each kernel takes a grid: 1 block is the probe's own size; a grid of
//    every SM times the kernel's occupancy runs the same per-block work on
//    the whole card (every block computes, block 0 writes the output).
//  - Two forms of every multiply-add: separate (__fmul_rn / __fadd_rn,
//    __hmul2_rn / __hadd2_rn: each op rounds, as the TPU probe and the
//    plain versions do) and fused (__fmaf_rn, __hfma2: one rounding).
//  - bf16 runs two elements a lane in __nv_bfloat162 (HFMA2). Compares
//    convert to float32 (exact). sqrt and exp of P15 run in float32 and
//    round once to bf16, as XLA computes a bf16 sqrt / exp.
//  - Every constant comes from the wrapper (consts), already rounded to
//    the working type: in bf16, 1.000001 and 1.0000013 are exactly 1.0,
//    and a literal would let the compiler fold the multiply away.
//  - P12's tile starts from an explicit initial tile (init): the TPU
//    kernel reads its own output buffer, which Pallas leaves undefined.
// The file is built with -fmad=false and without fast math.
//
// What bounds them on this card: P12, P20 and the one-block runs, latency
// (dependent chains on one SM); the full-card runs of P13-P15, the FP32 or
// bf16 issue rate. Far above any bytes bound.
//
// Launch contract: the vimg_probe_* functions launch on the given stream,
// do not synchronise and allocate nothing; they return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "probe_common.cuh"

namespace {

typedef __nv_bfloat162 bf2;

// ---------------------------------------------------------------------------
// P12: the primitive loop over a (16, 128) tile
// ---------------------------------------------------------------------------

enum Prim { VEC22 = 0, ANYRED = 1, COND = 2, VLOAD = 3, SLOAD = 4 };
constexpr int PRIM_THREADS = 256;
constexpr int PRIM_PER = 8;            // (16, 128) / 256
constexpr int TAB = 1024;              // the (8, 128) table

// k: [1.000001, 1e-7, 1e-6, 1e-12, 1e-20, 100, 0.5] as float32
template <int PRIM, int NREP>
__global__ void __launch_bounds__(PRIM_THREADS)
    prims_kernel(const float* __restrict__ tab, const float* __restrict__ init,
                 const float* __restrict__ k, int iters,
                 float* __restrict__ out) {
  __shared__ float s_tab[TAB];
  const int t = threadIdx.x;
  if (PRIM == SLOAD) {
    for (int e = t; e < TAB; e += PRIM_THREADS) s_tab[e] = tab[e];
    __syncthreads();
  }
  const float c = k[0], d = k[1], eps = k[2], s12 = k[3], s20 = k[4],
              lim = k[5], half = k[6];
  float v[PRIM_PER];
#pragma unroll
  for (int j = 0; j < PRIM_PER; j++)
    v[j] = __fadd_rn(init[t + PRIM_THREADS * j], eps);
  int acc = 0;
  for (int i = 0; i < iters; i++) {
#pragma unroll
    for (int r = 0; r < NREP; r++) {
      if (PRIM == VEC22) {
#pragma unroll
        for (int q = 0; q < 11; q++)
#pragma unroll
          for (int j = 0; j < PRIM_PER; j++)
            v[j] = __fadd_rn(__fmul_rn(v[j], c), d);
      } else if (PRIM == ANYRED || PRIM == COND) {
        bool mine = false;
#pragma unroll
        for (int j = 0; j < PRIM_PER; j++) mine |= v[j] > lim;
        const int s = __syncthreads_or(mine);
        if (PRIM == ANYRED) {
          acc += s ? 1 : 0;
#pragma unroll
          for (int j = 0; j < PRIM_PER; j++) v[j] = __fmul_rn(v[j], c);
        } else if (s) {
          // cond: a branch on the vote, uniform across the block, as the
          // TPU's lax.cond; the empty asm in each arm keeps the compiler
          // from merging the two arms into one multiply by a select
#pragma unroll
          for (int j = 0; j < PRIM_PER; j++) {
            v[j] = __fmul_rn(v[j], half);
            asm volatile("" : "+f"(v[j]));
          }
        } else {
#pragma unroll
          for (int j = 0; j < PRIM_PER; j++) {
            v[j] = __fmul_rn(v[j], c);
            asm volatile("" : "+f"(v[j]));
          }
        }
      } else {
        const int off = (i * 7 + r * 13) % 900;
        const int row = (off / 128) * 128;
        float sum = 0.0f;
#pragma unroll
        for (int q = 0; q < 6; q++) {
          const int e = row + (off + q) % 128;
          // sload reads as the probe does: tab[0, 0] * 0.0 + tab[...]
          const float x = PRIM == VLOAD
                              ? __ldg(tab + e)
                              : __fadd_rn(__fmul_rn(s_tab[0], 0.0f), s_tab[e]);
          sum = q == 0 ? __fadd_rn(0.0f, x) : __fadd_rn(sum, x);
        }
        const float add = __fmul_rn(sum, s12);
#pragma unroll
        for (int j = 0; j < PRIM_PER; j++) v[j] = __fadd_rn(v[j], add);
      }
    }
  }
  if (blockIdx.x == 0) {
    const float a = __fmul_rn((float)acc, s20);
#pragma unroll
    for (int j = 0; j < PRIM_PER; j++)
      out[t + PRIM_THREADS * j] = __fadd_rn(v[j], a);
  }
}

// ---------------------------------------------------------------------------
// P13-P15, P20: (32, 128) tiles in float32 or bf16
// ---------------------------------------------------------------------------

constexpr int VPU_THREADS = 1024;

__device__ __forceinline__ float vmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float vadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float vfma(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ bf2 vmul(bf2 a, bf2 b) { return __hmul2_rn(a, b); }
__device__ __forceinline__ bf2 vadd(bf2 a, bf2 b) { return __hadd2_rn(a, b); }
__device__ __forceinline__ bf2 vfma(bf2 a, bf2 b, bf2 c) { return __hfma2(a, b, c); }

template <bool FUSED, class T>
__device__ __forceinline__ T madd(T a, T b, T c) {
  return FUSED ? vfma(a, b, c) : vadd(vmul(a, b), c);
}

// a lane's mask: one flag a float32 element, two a bf16 pair
struct M2 { bool lo, hi; };
__device__ __forceinline__ bool gt(float a, float b) { return a > b; }
__device__ __forceinline__ M2 gt(bf2 a, bf2 b) {
  return {__low2float(a) > __low2float(b), __high2float(a) > __high2float(b)};
}
__device__ __forceinline__ bool both(bool a, bool b) { return a && b; }
__device__ __forceinline__ M2 both(M2 a, M2 b) {
  return {a.lo && b.lo, a.hi && b.hi};
}
__device__ __forceinline__ float sel(bool m, float a, float b) { return m ? a : b; }
__device__ __forceinline__ bf2 sel(M2 m, bf2 a, bf2 b) {
  return __halves2bfloat162(m.lo ? __low2bfloat16(a) : __low2bfloat16(b),
                            m.hi ? __high2bfloat16(a) : __high2bfloat16(b));
}
// the 0/1 mask in the working type (probe_vpu3's arithmetic select)
__device__ __forceinline__ bf2 as_num(M2 m) {
  return __floats2bfloat162_rn(m.lo ? 1.0f : 0.0f, m.hi ? 1.0f : 0.0f);
}

// slots of a thread: float32, element t + 1024 s (s < 4); bf16, the pair
// (t + 2048 s, t + 1024 + 2048 s) (s < 2)
template <bool BF> struct Lanes;
template <> struct Lanes<false> {
  typedef float T;
  static constexpr int N = 4;
  __device__ static T load(const float* x, int t, int s) {
    return x[t + VPU_THREADS * s];
  }
  __device__ static void store(float* o, int t, int s, T v) {
    o[t + VPU_THREADS * s] = v;
  }
  __device__ static T splat(float c) { return c; }
};
template <> struct Lanes<true> {
  typedef bf2 T;
  static constexpr int N = 2;
  __device__ static T load(const float* x, int t, int s) {
    return __floats2bfloat162_rn(x[t + 2 * VPU_THREADS * s],
                                 x[t + VPU_THREADS + 2 * VPU_THREADS * s]);
  }
  __device__ static void store(float* o, int t, int s, T v) {
    o[t + 2 * VPU_THREADS * s] = __low2float(v);
    o[t + VPU_THREADS + 2 * VPU_THREADS * s] = __high2float(v);
  }
  __device__ static T splat(float c) { return __float2bfloat162_rn(c); }
};

// P13. k: [c1, x0..x7 (0.001 i), d0..d7 (1e-7 (i + 1))] in the working type
template <bool BF, bool FUSED>
__global__ void __launch_bounds__(VPU_THREADS)
    fma_kernel(const float* __restrict__ x, const float* __restrict__ k,
               int iters, float* __restrict__ out) {
  typedef Lanes<BF> L;
  typedef typename L::T T;
  const int t = threadIdx.x;
  const T c1 = L::splat(k[0]);
  T a[8][L::N], d[8];
#pragma unroll
  for (int i = 0; i < 8; i++) {
    d[i] = L::splat(k[9 + i]);
    const T off = L::splat(k[1 + i]);
#pragma unroll
    for (int s = 0; s < L::N; s++) a[i][s] = vadd(L::load(x, t, s), off);
  }
  for (int it = 0; it < iters; it++) {
#pragma unroll
    for (int i = 0; i < 8; i++)
#pragma unroll
      for (int s = 0; s < L::N; s++) a[i][s] = madd<FUSED>(a[i][s], c1, d[i]);
  }
  if (blockIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < L::N; s++) {
      T acc = a[0][s];
#pragma unroll
      for (int i = 1; i < 8; i++) acc = vadd(acc, a[i][s]);
      L::store(out, t, s, acc);
    }
  }
}

// P14. k: [c1, 0.5, 0.25, 0.75, 1e-7, 2e-7] in the working type
template <bool BF, bool FUSED>
__global__ void __launch_bounds__(VPU_THREADS)
    mix_kernel(const float* __restrict__ x, const float* __restrict__ k,
               int iters, float* __restrict__ out) {
  typedef Lanes<BF> L;
  typedef typename L::T T;
  const int t = threadIdx.x;
  const T c1 = L::splat(k[0]), h = L::splat(k[1]), q = L::splat(k[2]),
          tq = L::splat(k[3]), e1 = L::splat(k[4]), e2 = L::splat(k[5]);
  T a[L::N], b[L::N], c[L::N], d[L::N];
#pragma unroll
  for (int s = 0; s < L::N; s++) {
    a[s] = L::load(x, t, s);
    b[s] = vadd(a[s], h);
    c[s] = vadd(a[s], q);
    d[s] = vadd(a[s], tq);
  }
  for (int it = 0; it < iters; it++) {
#pragma unroll
    for (int s = 0; s < L::N; s++) {
      a[s] = madd<FUSED>(a[s], c1, e1);
      b[s] = madd<FUSED>(b[s], c1, e2);
      const auto hit = both(gt(a[s], b[s]), gt(d[s], c[s]));
      c[s] = vmul(sel(hit, a[s], c[s]), c1);
      d[s] = vadd(sel(hit, b[s], d[s]), e1);
    }
  }
  if (blockIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < L::N; s++)
      L::store(out, t, s, vadd(vadd(vadd(a[s], b[s]), c[s]), d[s]));
  }
}

// P15: bf16 pairs, float32 state in FORM 2.
// k: [c1, 0.5, 0.25, 0.75, 1e-7, 2e-7, 1.0, 0.1, 0.01] (bf16 values) and
//    [0.5, 0.25, 0.75, 1e-7, 2e-7] (float32 values, FORM 2)
enum Form { F32CMP_BF16SEL = 0, F32CMP_ARITH = 1, BF16MATH_F32 = 2, TRANSC = 3 };

__device__ __forceinline__ bf2 sqrt2(bf2 v) {
  return __floats2bfloat162_rn(__fsqrt_rn(__low2float(v)),
                               __fsqrt_rn(__high2float(v)));
}
__device__ __forceinline__ bf2 exp2_(bf2 v) {
  return __floats2bfloat162_rn(expf(__low2float(v)), expf(__high2float(v)));
}
// float32 sum of the four states, widened from bf16, as probe_vpu3 sums
__device__ __forceinline__ float2 wide(bf2 v) {
  return make_float2(__low2float(v), __high2float(v));
}

template <int FORM, bool FUSED>
__global__ void __launch_bounds__(VPU_THREADS)
    vpu3_kernel(const float* __restrict__ x, const float* __restrict__ k,
                int iters, float* __restrict__ out) {
  const int t = threadIdx.x;
  if (FORM == BF16MATH_F32) {
    typedef Lanes<false> L;
    const bf2 c1 = __float2bfloat162_rn(k[0]);
    const __nv_bfloat16 c1h = __low2bfloat16(c1);
    const float h = k[9], q = k[10], tq = k[11], e1 = k[12], e2 = k[13];
    float a[4], b[4], c[4], d[4];
#pragma unroll
    for (int s = 0; s < 4; s++) {
      const float xf = L::load(x, t, s);
      a[s] = xf;
      b[s] = vadd(xf, h);
      c[s] = vadd(xf, q);
      d[s] = vadd(xf, tq);
    }
    for (int it = 0; it < iters; it++) {
#pragma unroll
      for (int s = 0; s < 4; s++) {
        a[s] = vadd(__bfloat162float(__hmul_rn(__float2bfloat16_rn(a[s]), c1h)), e1);
        b[s] = vadd(__bfloat162float(__hmul_rn(__float2bfloat16_rn(b[s]), c1h)), e2);
        const bool hit = a[s] > b[s] && c[s] < d[s];
        c[s] = hit ? a[s] : c[s];
        d[s] = vadd(hit ? b[s] : d[s], e1);
      }
    }
    if (blockIdx.x == 0) {
#pragma unroll
      for (int s = 0; s < 4; s++)
        L::store(out, t, s, vadd(vadd(vadd(a[s], b[s]), c[s]), d[s]));
    }
    return;
  }
  typedef Lanes<true> L;
  const bf2 c1 = L::splat(k[0]), h = L::splat(k[1]), q = L::splat(k[2]),
            tq = L::splat(k[3]), e1 = L::splat(k[4]), e2 = L::splat(k[5]),
            one = L::splat(k[6]), tenth = L::splat(k[7]),
            hundredth = L::splat(k[8]);
  bf2 a[2], b[2], c[2], d[2];
#pragma unroll
  for (int s = 0; s < 2; s++) {
    const bf2 xb = L::load(x, t, s);
    if (FORM == TRANSC) {
      a[s] = b[s] = vadd(xb, h);
    } else {
      a[s] = xb;
      b[s] = vadd(xb, h);
      c[s] = vadd(xb, q);
      d[s] = vadd(xb, tq);
    }
  }
  for (int it = 0; it < iters; it++) {
#pragma unroll
    for (int s = 0; s < 2; s++) {
      if (FORM == TRANSC) {
        a[s] = sqrt2(madd<FUSED>(a[s], a[s], tenth));
        b[s] = exp2_(vmul(__hneg2(b[s]), hundredth));
        continue;
      }
      a[s] = madd<FUSED>(a[s], c1, e1);
      b[s] = madd<FUSED>(b[s], c1, e2);
      const M2 hit = both(gt(a[s], b[s]), gt(d[s], c[s]));
      if (FORM == F32CMP_BF16SEL) {
        c[s] = vmul(sel(hit, a[s], c[s]), c1);
        d[s] = vadd(sel(hit, b[s], d[s]), e1);
      } else {
        const bf2 m = as_num(hit);
        const bf2 im = vadd(one, __hneg2(m));     // 1 - m, exact
        c[s] = vmul(madd<FUSED>(m, a[s], vmul(im, c[s])), c1);
        d[s] = vadd(madd<FUSED>(m, b[s], vmul(im, d[s])), e1);
      }
    }
  }
  if (blockIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < 2; s++) {
      float2 acc = wide(a[s]);
      const float2 wb = wide(b[s]);
      acc.x = vadd(acc.x, wb.x);
      acc.y = vadd(acc.y, wb.y);
      if (FORM != TRANSC) {
        const float2 wc = wide(c[s]), wd = wide(d[s]);
        acc.x = vadd(vadd(acc.x, wc.x), wd.x);
        acc.y = vadd(vadd(acc.y, wc.y), wd.y);
      }
      out[t + 2 * VPU_THREADS * s] = acc.x;
      out[t + VPU_THREADS + 2 * VPU_THREADS * s] = acc.y;
    }
  }
}

// P20. k: [c1, c2, 1.0] in the working type
template <bool BF, bool FUSED>
__global__ void __launch_bounds__(VPU_THREADS)
    rate_kernel(const float* __restrict__ x, const float* __restrict__ k,
                int iters, float* __restrict__ out) {
  typedef Lanes<BF> L;
  typedef typename L::T T;
  const int t = threadIdx.x;
  const T c1 = L::splat(k[0]), c2 = L::splat(k[1]), one = L::splat(k[2]);
  T a[L::N], b[L::N];
#pragma unroll
  for (int s = 0; s < L::N; s++) {
    a[s] = L::load(x, t, s);
    b[s] = vadd(a[s], one);
  }
  for (int it = 0; it < iters; it++) {
#pragma unroll
    for (int s = 0; s < L::N; s++) {
      a[s] = madd<FUSED>(a[s], c1, c2);
      b[s] = madd<FUSED>(b[s], c1, vmul(a[s], c2));
    }
  }
  if (blockIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < L::N; s++) L::store(out, t, s, vadd(a[s], b[s]));
  }
}

template <class Kernel>
int run(Kernel kernel, int threads, int n_blocks, int* grid_used,
        cudaStream_t s, const float* x, const float* k, int iters,
        float* out) {
  const int grid = probe_grid(kernel, threads, n_blocks, grid_used);
  kernel<<<grid, threads, 0, s>>>(x, k, iters, out);
  return (int)cudaGetLastError();
}

template <int PRIM>
int run_prim(int n_rep, cudaStream_t s, const float* tab, const float* init,
             const float* k, int iters, int n_blocks, int* grid_used,
             float* out) {
  auto kernel = n_rep == 4 ? prims_kernel<PRIM, 4> : prims_kernel<PRIM, 1>;
  const int grid = probe_grid(kernel, PRIM_THREADS, n_blocks, grid_used);
  kernel<<<grid, PRIM_THREADS, 0, s>>>(tab, init, k, iters, out);
  return (int)cudaGetLastError();
}

}  // namespace

// P12: tab (8, 128), init and out (16, 128) float32; prim 0 vec22, 1
// anyred, 2 cond, 3 vload, 4 sload; n_rep 1 or 4; n_blocks <= 0: the
// full card.
extern "C" int vimg_probe_prims(const float* tab, const float* init,
                                const float* k, int prim, int n_rep,
                                int iters, int n_blocks, int* grid_used,
                                float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n_rep != 1 && n_rep != 4) return (int)cudaErrorInvalidValue;
  switch (prim) {
    case VEC22: return run_prim<VEC22>(n_rep, s, tab, init, k, iters, n_blocks, grid_used, out);
    case ANYRED: return run_prim<ANYRED>(n_rep, s, tab, init, k, iters, n_blocks, grid_used, out);
    case COND: return run_prim<COND>(n_rep, s, tab, init, k, iters, n_blocks, grid_used, out);
    case VLOAD: return run_prim<VLOAD>(n_rep, s, tab, init, k, iters, n_blocks, grid_used, out);
    case SLOAD: return run_prim<SLOAD>(n_rep, s, tab, init, k, iters, n_blocks, grid_used, out);
  }
  return (int)cudaErrorInvalidValue;
}

// P13, P14, P20: x and out (32, 128) float32; kind 0 fma, 1 mix, 2 rate;
// bf16 0/1; fused 0/1; n_blocks <= 0: the full card.
extern "C" int vimg_probe_vpu(const float* x, const float* k, int kind,
                              int bf16, int fused, int iters, int n_blocks,
                              int* grid_used, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int code = kind * 4 + bf16 * 2 + fused;
  switch (code) {
#define CASE(KIND, K)                                                       \
  case KIND * 4 + 0: return run(K<false, false>, VPU_THREADS, n_blocks, grid_used, s, x, k, iters, out); \
  case KIND * 4 + 1: return run(K<false, true>, VPU_THREADS, n_blocks, grid_used, s, x, k, iters, out);  \
  case KIND * 4 + 2: return run(K<true, false>, VPU_THREADS, n_blocks, grid_used, s, x, k, iters, out);  \
  case KIND * 4 + 3: return run(K<true, true>, VPU_THREADS, n_blocks, grid_used, s, x, k, iters, out);
    CASE(0, fma_kernel)
    CASE(1, mix_kernel)
    CASE(2, rate_kernel)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}

// P15: x and out (32, 128) float32; form 0-3 (see Form); fused 0/1;
// n_blocks <= 0: the full card.
extern "C" int vimg_probe_vpu3(const float* x, const float* k, int form,
                               int fused, int iters, int n_blocks,
                               int* grid_used, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (form * 2 + fused) {
#define CASE(F)                                                             \
  case F * 2 + 0: return run(vpu3_kernel<F, false>, VPU_THREADS, n_blocks, grid_used, s, x, k, iters, out); \
  case F * 2 + 1: return run(vpu3_kernel<F, true>, VPU_THREADS, n_blocks, grid_used, s, x, k, iters, out);
    CASE(0)
    CASE(1)
    CASE(2)
    CASE(3)
#undef CASE
  }
  return (int)cudaErrorInvalidValue;
}
