// Scalar-path probes for Hopper (sm_90a): kernels P2, P3 and P4 of
// vimg_tpu_torch's probes (probes/probe_r3b.py, probe_r3c.py,
// probe_regen.py).
//
// Replaces:
//   P2 tools/probe_r3b.py::microbench_sync (pallas_call :68): N steps of
//      x = x * 1.0000001 + 1e-9 over a (32, 128) block, plus a
//      vector -> scalar any() per step in four modes (novec: no any, the
//      scalar chain n += x[0, 0] * 1e-12; scalar and cond: n += any(x >
//      0.5); any8: eight anys at 0.5 + 0.01 k). Output x + n.
//   P3 tools/probe_r3c.py::smem_read_cost (pallas_call :64): a serial
//      chain of data-dependent scalar table reads (2/4/8/16 plain reads,
//      or 4/8/16 packed: one int32 read unpacked into two halves) beside
//      x = x * 1.0000001 over an (8, 128) block. Output x + s * 1e-20.
//   P4 tools/probe_regen.py::probe_smem_dynamic_write (pallas_call :56):
//      a dynamic-index scalar stack, 16 pushes of two and pops of one, then
//      a read-back sum. Output x + sum (423 for the probe's stack).
//
// Design: one block holds the probe's block. The TPU's scalar unit and
// SMEM become a block-uniform value and shared memory:
//  - P2: 1024 threads of 4 elements each; the any() over the (32, 128)
//    block is a block-wide vote (__syncthreads_or), one barrier per any.
//    novec's scalar chain runs on thread 0, which holds x[0, 0], and is
//    broadcast once at the end.
//  - P3: the 4096-entry table is staged in shared memory; every thread
//    runs the same scalar chain (block-uniform: each read is a broadcast).
//    The table's values are non-negative (arange % 7 in the probe; the
//    wrapper refuses others), so C's truncating % equals jnp's floor-mod
//    here and every index stays in the table.
//  - P4: thread 0 pushes and pops a 64-entry stack in shared memory
//    (volatile: every store and load happens, as SMEM's do) and shares the
//    sum through shared memory.
// Constants round as XLA rounds them: the weak-typed 1.0000001, 1e-9,
// 1e-12 and 1e-20 to float32; 0.5 + 0.01 k in double, rounded once. The
// file is built with -fmad=false and without fast math.
//
// What bounds them on this card: latency, by design (a serial chain of
// dependent steps); they sit far above any bytes or flops bound.
//
// Launch contract: the vimg_probe_* functions launch on the given stream,
// do not synchronise and allocate nothing; they return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum SyncMode { NOVEC = 0, SCALAR = 1, COND = 2, ANY8 = 3 };
constexpr int SYNC_THREADS = 1024;           // (32, 128) / 4 per thread
constexpr int SYNC_PER = 4;
constexpr int TILE_THREADS = 128;            // (8, 128): 8 rows per thread
constexpr int TILE_ROWS = 8;
constexpr int TAB = 4096;

template <int MODE>
__global__ void __launch_bounds__(SYNC_THREADS)
    sync_kernel(const float* __restrict__ x_in, int n_iter,
                float* __restrict__ out) {
  __shared__ float s_n;
  const int t = threadIdx.x;
  float x[SYNC_PER];
#pragma unroll
  for (int j = 0; j < SYNC_PER; j++) x[j] = x_in[t + SYNC_THREADS * j];
  float n = 0.0f;
  for (int i = 0; i < n_iter; i++) {
#pragma unroll
    for (int j = 0; j < SYNC_PER; j++) x[j] = x[j] * 1.0000001f + 1e-9f;
    if (MODE == NOVEC) {
      if (t == 0) n = n + x[0] * 1e-12f;        // x[0] of thread 0 = x[0, 0]
    } else if (MODE == SCALAR || MODE == COND) {
      bool mine = false;
#pragma unroll
      for (int j = 0; j < SYNC_PER; j++) mine |= x[j] > 0.5f;
      const int a = __syncthreads_or(mine);
      if (MODE == SCALAR)
        n = n + (a ? 1.0f : 0.0f);
      else if (a)
        n = n + 1.0f;
    } else {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < 8; k++) {
        const float thr = (float)(0.5 + 0.01 * k);
        bool mine = false;
#pragma unroll
        for (int j = 0; j < SYNC_PER; j++) mine |= x[j] > thr;
        acc = acc + (__syncthreads_or(mine) ? 1.0f : 0.0f);
      }
      n = n + acc;
    }
  }
  if (MODE == NOVEC) {
    if (t == 0) s_n = n;
    __syncthreads();
    n = s_n;
  }
#pragma unroll
  for (int j = 0; j < SYNC_PER; j++) out[t + SYNC_THREADS * j] = x[j] + n;
}

template <int NREADS, bool PACKED>
__global__ void __launch_bounds__(TILE_THREADS)
    smem_read_kernel(const float* __restrict__ x_in,
                     const int* __restrict__ tab, int n_iter,
                     float* __restrict__ out) {
  __shared__ int s_tab[TAB];
  const int t = threadIdx.x;
  for (int e = t; e < TAB; e += TILE_THREADS) s_tab[e] = tab[e];
  __syncthreads();
  float x[TILE_ROWS];
#pragma unroll
  for (int r = 0; r < TILE_ROWS; r++) x[r] = x_in[r * TILE_THREADS + t];
  int s = 0;
  for (int i = 0; i < n_iter; i++) {
#pragma unroll
    for (int r = 0; r < TILE_ROWS; r++) x[r] = x[r] * 1.0000001f;
    const int idx = (i * 7 + s) % TAB;      // depends on s: a serial chain
    int acc = 0;
    if (PACKED) {
#pragma unroll
      for (int k = 0; k < NREADS / 2; k++) {
        const int w = s_tab[(idx + k) % TAB];
        acc = acc + (w & 0xFFFF) + (w >> 16);
      }
    } else {
#pragma unroll
      for (int k = 0; k < NREADS; k++) acc = acc + s_tab[(idx + k) % TAB];
    }
    s = (s + acc) % 65536;
  }
#pragma unroll
  for (int r = 0; r < TILE_ROWS; r++)
    out[r * TILE_THREADS + t] = x[r] + (float)s * 1e-20f;
}

__global__ void __launch_bounds__(TILE_THREADS)
    stack_kernel(const float* __restrict__ x_in, float* __restrict__ out) {
  __shared__ int stack[64];
  __shared__ float s_acc;
  const int t = threadIdx.x;
  if (t == 0) {
    volatile int* st = stack;
    int sp = 0;
    for (int i = 0; i < 16; i++) {   // push two values, pop one
      st[sp] = i * 3 + 1;
      st[sp + 1] = i * 3 + 2;
      const int v = st[sp];
      sp = sp + 1 + (v % 1);
    }
    float acc = 0.0f;
    for (int i = 0; i < sp + 1; i++) acc = acc + (float)st[i];
    s_acc = acc;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < TILE_ROWS; r++)
    out[r * TILE_THREADS + t] = x_in[r * TILE_THREADS + t] + s_acc;
}

template <int NREADS, bool PACKED>
int launch_read(cudaStream_t s, const float* x, const int* tab, int n_iter,
                float* out) {
  smem_read_kernel<NREADS, PACKED><<<1, TILE_THREADS, 0, s>>>(x, tab, n_iter,
                                                              out);
  return (int)cudaGetLastError();
}

}  // namespace

// P2: x and out are (32, 128) float32; mode 0 novec, 1 scalar, 2 cond,
// 3 any8.
extern "C" int vimg_probe_sync(const float* x, int mode, int n_iter,
                               float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case NOVEC:
      sync_kernel<NOVEC><<<1, SYNC_THREADS, 0, s>>>(x, n_iter, out);
      break;
    case SCALAR:
      sync_kernel<SCALAR><<<1, SYNC_THREADS, 0, s>>>(x, n_iter, out);
      break;
    case COND:
      sync_kernel<COND><<<1, SYNC_THREADS, 0, s>>>(x, n_iter, out);
      break;
    case ANY8:
      sync_kernel<ANY8><<<1, SYNC_THREADS, 0, s>>>(x, n_iter, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// P3: x and out are (8, 128) float32, tab 4096 non-negative int32; plain
// n_reads 2, 4, 8, 16, packed 4, 8, 16.
extern "C" int vimg_probe_smem_read(const float* x, const int* tab,
                                    int n_reads, int packed, int n_iter,
                                    float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (packed) {
    switch (n_reads) {
      case 4: return launch_read<4, true>(s, x, tab, n_iter, out);
      case 8: return launch_read<8, true>(s, x, tab, n_iter, out);
      case 16: return launch_read<16, true>(s, x, tab, n_iter, out);
    }
  } else {
    switch (n_reads) {
      case 2: return launch_read<2, false>(s, x, tab, n_iter, out);
      case 4: return launch_read<4, false>(s, x, tab, n_iter, out);
      case 8: return launch_read<8, false>(s, x, tab, n_iter, out);
      case 16: return launch_read<16, false>(s, x, tab, n_iter, out);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// P4: x and out are (8, 128) float32.
extern "C" int vimg_probe_stack(const float* x, float* out, void* stream) {
  stack_kernel<<<1, TILE_THREADS, 0, (cudaStream_t)stream>>>(x, out);
  return (int)cudaGetLastError();
}
