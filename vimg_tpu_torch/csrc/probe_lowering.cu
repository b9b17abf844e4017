// Construct checks for Hopper (sm_90a): kernels P23-P31 of vimg_tpu_torch's
// probes (probes/probe_pallas.py, probe_constructs.py): each is the same
// construct as its TPU kernel, written in CUDA.
//
// Replaces:
//   P23 tools/probe_pallas.py::t_grid (pallas_call :54): a 4-step grid
//       writing col + 1000 g into (8, 256) blocks of a (32, 256) output.
//   P24 tools/probe_pallas.py::t_while (pallas_call :81): while (max(v) <
//       100 && it < 1000) v = v * 1.1 + 0.01 over an (8, 128) tile.
//   P25 tools/probe_pallas.py::t_pcg (pallas_call :100): r1 + 2 r2 + 4 r3
//       + 8 r4 from uniform4(pixel = lane, sample = row, 3, 7).
//   P26 tools/probe_pallas.py::t_scalars (pallas_call :125): the sum of six
//       static-index scalars of a (2, 12) table, broadcast.
//   P27 tools/probe_pallas.py::t_transcendental (pallas_call :145): sin +
//       cos + sqrt + log + exp + atan2 + pow over an (8, 128) tile.
//   P28 tools/probe_pallas.py::t_throughput (pallas_call :188): a ~60-flop
//       body with an rsqrt and a select, 2,000 steps, 16 grid steps of
//       (64, 128) lanes.
//   P29 tools/probe_constructs.py k1 (pallas_call :39): a loop over 8
//       clusters of acc += aabb[c, 0] * x, dynamic scalar reads.
//   P30 tools/probe_constructs.py k2 (pallas_call :55): k1 plus a copy of
//       an (8, 16) triangle block a step into a buffer; adds buf[0, 0].
//   P31 tools/probe_constructs.py k3 (pallas_call :79): k2 with the copy in
//       flight across the live test, and a branch on any(live) around an
//       unrolled 8-triangle accumulate.
//
// Design: one block holds an (8, 128) tile, a thread a lane of 8 rows
// (P23: 4 blocks of (8, 256); P28: a thread a lane, 1,024 lanes a block, 128
// blocks for the probe's 131,072 lanes, or the full card). The TPU's SMEM
// scalars become a shared-memory copy every thread reads at one address;
// the reduction in a loop condition and any() are block votes
// (__syncthreads_or); the DMA from ANY memory is cp.async
// (__pipeline_memcpy_async, 16 bytes a thread) into shared memory, waited
// on before use; PCG4D is csrc/rng.cuh, the megakernel's. P28's rsqrt is
// 1 / sqrtf (IEEE), so its plain version can round alike. The file is
// built with -fmad=false and without fast math.
//
// What bounds them on this card: launch latency (P23-P27, P29-P31: a few
// hundred operations on one tile), and the FP32 rate for P28 on the full
// card.
//
// Launch contract: the vimg_probe_* functions launch on the given stream,
// do not synchronise and allocate nothing; they return cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "probe_common.cuh"
#include "rng.cuh"

namespace {

constexpr int LS = 8, LANES = 128;

__global__ void __launch_bounds__(256) grid_kernel(float* __restrict__ out) {
  const int g = blockIdx.x, col = threadIdx.x;
#pragma unroll
  for (int r = 0; r < LS; r++)
    out[(g * LS + r) * 256 + col] = __fadd_rn((float)col, __fmul_rn((float)g, 1000.0f));
}

__global__ void __launch_bounds__(LANES)
    while_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const int t = threadIdx.x;
  float v[LS];
#pragma unroll
  for (int r = 0; r < LS; r++) v[r] = x[r * LANES + t];
  int it = 0;
  while (true) {
    bool stop = false;                 // not (v < 100): max(v) >= 100
#pragma unroll
    for (int r = 0; r < LS; r++) stop |= !(v[r] < 100.0f);
    if (__syncthreads_or(stop) || it >= 1000) break;
#pragma unroll
    for (int r = 0; r < LS; r++) v[r] = __fadd_rn(__fmul_rn(v[r], 1.1f), 0.01f);
    it++;
  }
#pragma unroll
  for (int r = 0; r < LS; r++)
    out[r * LANES + t] = __fadd_rn(v[r], __fmul_rn((float)it, 0.0f));
}

__global__ void __launch_bounds__(LANES) pcg_kernel(float* __restrict__ out) {
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < LS; r++) {
    const U4 u = uniform4((uint32_t)t, (uint32_t)r, 3u, 7u);
    const float s = __fadd_rn(__fadd_rn(__fadd_rn(u.a, __fmul_rn(u.b, 2.0f)),
                                        __fmul_rn(u.c, 4.0f)),
                              __fmul_rn(u.d, 8.0f));
    out[r * LANES + t] = s;
  }
}

__global__ void __launch_bounds__(LANES)
    scalars_kernel(const float* __restrict__ tbl, float* __restrict__ out) {
  __shared__ float s_tbl[24];
  const int t = threadIdx.x;
  if (t < 24) s_tbl[t] = tbl[t];
  __syncthreads();
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; i++)
#pragma unroll
    for (int k = 0; k < 3; k++) acc = __fadd_rn(acc, s_tbl[i * 12 + k]);
#pragma unroll
  for (int r = 0; r < LS; r++) out[r * LANES + t] = acc;
}

__global__ void __launch_bounds__(LANES)
    transc_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const int t = threadIdx.x;
#pragma unroll
  for (int r = 0; r < LS; r++) {
    const float v = x[r * LANES + t];
    float s = __fadd_rn(sinf(v), cosf(v));
    s = __fadd_rn(s, sqrtf(__fadd_rn(v, 1.0f)));
    s = __fadd_rn(s, logf(__fadd_rn(v, 2.0f)));
    s = __fadd_rn(s, expf(-v));
    s = __fadd_rn(s, atan2f(v, __fadd_rn(v, 1.0f)));
    s = __fadd_rn(s, powf(__fadd_rn(v, 1.0f), 1.7f));
    out[r * LANES + t] = s;
  }
}

constexpr int TP_THREADS = 1024;
constexpr int TP_LANES_PER_STEP = 64 * 128;   // a grid step of the probe
constexpr int TP_OUT = 16 * TP_LANES_PER_STEP;

__global__ void __launch_bounds__(TP_THREADS)
    throughput_kernel(int iters, float* __restrict__ out) {
  const int e = blockIdx.x * TP_THREADS + threadIdx.x;
  const float g0 = __fmul_rn((float)((e / TP_LANES_PER_STEP) % 16), 0.0f);
  float a = 0.3f, b = 0.7f;
  for (int i = 0; i < iters; i++) {
    const float t = __fadd_rn(__fmul_rn(a, 1.000001f), __fmul_rn(b, 0.5f));
    const float u = __fadd_rn(__fmul_rn(b, a), 0.25f);
    const float v = 1.0f / sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(t, t), __fmul_rn(u, u)), 1.0f));
    const float w = __fadd_rn(__fmul_rn(t, v), __fmul_rn(u, 0.1f));
    const float a2 = w > 0.5f ? __fmul_rn(w, 0.99f) : __fadd_rn(w, 0.01f);
    const float b2 = __fsub_rn(__fmul_rn(u, v), __fmul_rn(t, 0.001f));
    const float x = __fadd_rn(__fmul_rn(a2, b2), v);
    const float y = __fadd_rn(__fmul_rn(x, x), a2);
    const float z = __fadd_rn(__fmul_rn(y, 0.5f), __fmul_rn(x, b2));
    a = z;
    b = __fadd_rn(y, g0);
  }
  if (e < TP_OUT) out[e] = __fadd_rn(a, b);
}

// P29-P31 (probe_constructs): aabb (8, 8), tris (64, 16), rays (8, 128)
template <int K>
__global__ void __launch_bounds__(LANES)
    constructs_kernel(const float* __restrict__ aabb,
                      const float* __restrict__ tris,
                      const float* __restrict__ rays,
                      float* __restrict__ out) {
  __shared__ float s_aabb[64];
  __shared__ __align__(16) float s_buf[8 * 16];
  const int t = threadIdx.x;
  if (t < 64) s_aabb[t] = aabb[t];
  __syncthreads();
  float x[LS], acc[LS];
#pragma unroll
  for (int r = 0; r < LS; r++) {
    x[r] = rays[r * LANES + t];
    acc[r] = 0.0f;
  }
#pragma unroll 1
  for (int c = 0; c < 8; c++) {
    const float s = s_aabb[c * 8];               // dynamic scalar read
    if (K >= 2) {                                // start the block copy
      if (t < 32)
        __pipeline_memcpy_async(s_buf + 4 * t, tris + c * 128 + 4 * t, 16);
      __pipeline_commit();
    }
    if (K <= 2) {
      if (K == 2) {
        __pipeline_wait_prior(0);
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < LS; r++) {
        acc[r] = __fadd_rn(acc[r], __fmul_rn(s, x[r]));
        if (K == 2) acc[r] = __fadd_rn(acc[r], s_buf[0]);
      }
    } else {
      bool live[LS], any = false;
#pragma unroll
      for (int r = 0; r < LS; r++) {
        live[r] = __fmul_rn(s, x[r]) < 5.0f;
        any |= live[r];
      }
      __pipeline_wait_prior(0);
      if (__syncthreads_or(any)) {               // also the copy's barrier
#pragma unroll
        for (int k = 0; k < 8; k++)
#pragma unroll
          for (int r = 0; r < LS; r++)
            acc[r] = __fadd_rn(acc[r], __fmul_rn(s_buf[k * 16],
                                                 live[r] ? x[r] : 0.0f));
      }
    }
    if (K >= 2) __syncthreads();                 // before the next copy
  }
#pragma unroll
  for (int r = 0; r < LS; r++) out[r * LANES + t] = acc[r];
}

}  // namespace

// P23: out (32, 256) float32.
extern "C" int vimg_probe_grid(float* out, void* stream) {
  grid_kernel<<<4, 256, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}

// P24: x and out (8, 128) float32.
extern "C" int vimg_probe_while(const float* x, float* out, void* stream) {
  while_kernel<<<1, LANES, 0, (cudaStream_t)stream>>>(x, out);
  return (int)cudaGetLastError();
}

// P25: out (8, 128) float32.
extern "C" int vimg_probe_pcg(float* out, void* stream) {
  pcg_kernel<<<1, LANES, 0, (cudaStream_t)stream>>>(out);
  return (int)cudaGetLastError();
}

// P26: tbl (2, 12), out (8, 128) float32.
extern "C" int vimg_probe_scalars(const float* tbl, float* out, void* stream) {
  scalars_kernel<<<1, LANES, 0, (cudaStream_t)stream>>>(tbl, out);
  return (int)cudaGetLastError();
}

// P27: x and out (8, 128) float32.
extern "C" int vimg_probe_transc(const float* x, float* out, void* stream) {
  transc_kernel<<<1, LANES, 0, (cudaStream_t)stream>>>(x, out);
  return (int)cudaGetLastError();
}

// P28: out (1024, 128) float32; n_blocks 128 is the probe's size, <= 0 the
// full card (blocks past the 128th compute and write nothing).
extern "C" int vimg_probe_throughput(int iters, int n_blocks, int* grid_used,
                                     float* out, void* stream) {
  const int grid = probe_grid(throughput_kernel, TP_THREADS, n_blocks,
                              grid_used);
  throughput_kernel<<<grid, TP_THREADS, 0, (cudaStream_t)stream>>>(iters, out);
  return (int)cudaGetLastError();
}

// P29-P31: which 1, 2 or 3 (k1, k2, k3); aabb (8, 8), tris (64, 16) with a
// 16-byte aligned base, rays and out (8, 128) float32.
extern "C" int vimg_probe_constructs(const float* aabb, const float* tris,
                                     const float* rays, int which,
                                     float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (which) {
    case 1: constructs_kernel<1><<<1, LANES, 0, s>>>(aabb, tris, rays, out); break;
    case 2: constructs_kernel<2><<<1, LANES, 0, s>>>(aabb, tris, rays, out); break;
    case 3: constructs_kernel<3><<<1, LANES, 0, s>>>(aabb, tris, rays, out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
