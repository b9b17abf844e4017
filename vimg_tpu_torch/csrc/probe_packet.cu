// Packet-primitive probes for Hopper (sm_90a): kernels P5-P10 of
// vimg_tpu_torch's probes (probes/probe_r4a.py).
//
// Replaces the pallas_calls of tools/probe_r4a.py, each a tiny kernel over
// one (8, 128) tile timed over many repetitions:
//   P5  probe_setup (:86), static and dynamic: extract 6 lane columns
//       (c * 16 + p) of the tile per packet p = r % 16, broadcast each over
//       the lanes, chain them (a * 1.000001 + b) and add the result into
//       lane p only (a lane-masked accumulate).
//   P6  probe_dynrow (:117): per step 12 dynamic (1, 128) row loads from a
//       table at idx[i % 64] * 12, each broadcast over the 8 rows, chained
//       with a * 1.000001 + b.
//   P7  probe_ffs (:160): a find-first-set loop over a 128-lane mask: each
//       step reads the table row of the lowest set lane and clears it; rows
//       are summed in ascending lane order.
//   P8  probe_epilogue (:198): per row the minimum over the lanes and the
//       least lane at it, then a strict-less update of (bt, code).
//   P9  probe_dynblock (:257), parallel and chained: one (12, 128) block
//       load per step, rows taken from the loaded value.
//   P10 probe_dynrow_par (:287): P6's row loads with P9's parallel sum.
//
// Design: one block holds the tile. For P5-P7 and P9-P10 thread k owns
// lane k (128 threads). A lane-column extract is a shared-memory broadcast
// (every thread reads one address); "static" has the column index in the
// instruction (the packet loop unrolled by 16), "dynamic" computes it at
// run time. Every lane computes the packet's value and selects it into
// lane p, as the TPU's vector ops do: computing it in lane p alone made
// the warp diverge (447 ns a packet against 25 static, H100 at 700 W). A
// (1, 128) row broadcast over 8 rows gives 8 equal rows, so a thread
// computes its lane once and stores it to all 8. P7's mask is four
// warp ballots (__ballot_sync) and the loop takes the lowest set bit with
// __ffs. P8 gives each of the 8 rows one warp: the minimum and the least
// lane at it are warp reductions (__shfl_xor_sync). Indices from the
// caller's tables (P6, P9, P10) are clamped into the table, as the plain
// versions clamp them. Sums keep the probe's order; the file is built with
// -fmad=false and without fast math.
//
// What bounds them on this card: launch and dependent-instruction latency
// (a few microseconds of work per launch), not bytes or flops.
//
// Launch contract: the vimg_probe_* functions launch on the given stream,
// do not synchronise and allocate nothing; they return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LANES = 128;
constexpr int ROWS = 8;
constexpr int NROWS = 12;       // table rows per step (P6, P9, P10)
constexpr int N_IDX = 64;
constexpr float A = 1.000001f;

__device__ __forceinline__ float qnan() { return __int_as_float(0x7fffffff); }
__device__ __forceinline__ float jmin(float a, float b) {
  return (a != a || b != b) ? qnan() : (a < b ? a : b);
}

// the six columns of packet p, chained: ((c0 * A + c1) * A + ...) + c5
__device__ __forceinline__ float packet_value(const float (*s_x)[LANES],
                                              int r, int p) {
  float v = s_x[r][p];
#pragma unroll
  for (int c = 1; c < 6; c++) v = v * A + s_x[r][c * 16 + p];
  return v;
}

template <bool kStatic>
__global__ void __launch_bounds__(LANES)
    setup_kernel(const float* __restrict__ x, int reps,
                 float* __restrict__ out) {
  __shared__ float s_x[ROWS][LANES];
  const int k = threadIdx.x;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; r++) {
    s_x[r][k] = x[r * LANES + k];
    acc[r] = 0.0f;
  }
  __syncthreads();
  if (kStatic) {
    for (int r0 = 0; r0 < reps; r0 += 16) {
#pragma unroll
      for (int p = 0; p < 16; p++) {
        if (r0 + p >= reps) break;
#pragma unroll
        for (int r = 0; r < ROWS; r++) {
          const float v = packet_value(s_x, r, p);
          acc[r] = acc[r] + (k == p ? v : 0.0f);
        }
      }
    }
  } else {
    for (int i = 0; i < reps; i++) {
      const int p = i % 16;
#pragma unroll
      for (int r = 0; r < ROWS; r++) {
        const float v = packet_value(s_x, r, p);
        acc[r] = acc[r] + (k == p ? v : 0.0f);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; r++) out[r * LANES + k] = acc[r];
}

// P6 (row loads, chained), P9 (block load, parallel or chained), P10 (row
// loads, parallel)
template <bool kBlock, bool kParallel>
__global__ void __launch_bounds__(LANES)
    rows_kernel(const float* __restrict__ tbl, const int* __restrict__ idx,
                int n_blocks, int reps, float* __restrict__ out) {
  __shared__ int s_idx[N_IDX];
  const int k = threadIdx.x;
  if (k < N_IDX) s_idx[k] = idx[k];
  __syncthreads();
  float acc = 0.0f;
  for (int i = 0; i < reps; i++) {
    const int b = min(max(s_idx[i % N_IDX], 0), n_blocks - 1);
    const float* src = tbl + (size_t)b * NROWS * LANES + k;
    float row[NROWS];
    if (kBlock) {
#pragma unroll
      for (int j = 0; j < NROWS; j++) row[j] = src[j * LANES];
    }
    if (kParallel) {
      if (!kBlock) {
#pragma unroll
        for (int j = 0; j < NROWS; j++) row[j] = src[j * LANES];
      }
      const float a = row[0] * row[1] + row[2] * row[3];
      const float bb = row[4] * row[5] + row[6] * row[7];
      const float c = row[8] * row[9] + row[10] * row[11];
      acc = acc + (a + bb) + c;
    } else {
      float v = kBlock ? row[0] : src[0];
#pragma unroll
      for (int j = 1; j < NROWS; j++)
        v = v * A + (kBlock ? row[j] : src[j * LANES]);
      acc = acc + v;
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; r++) out[r * LANES + k] = acc;
}

__global__ void __launch_bounds__(LANES)
    ffs_kernel(const float* __restrict__ mask, const float* __restrict__ tbl,
               int reps, float* __restrict__ out) {
  __shared__ unsigned s_mask[LANES / 32];
  const int k = threadIdx.x;
  const unsigned b = __ballot_sync(0xffffffffu, mask[k] > 0.5f);
  if ((k & 31) == 0) s_mask[k >> 5] = b;
  __syncthreads();
  float acc = 0.0f;
  for (int r = 0; r < reps; r++) {
    unsigned w[4] = {s_mask[0], s_mask[1], s_mask[2], s_mask[3]};
    while (w[0] | w[1] | w[2] | w[3]) {
      const int q = w[0] ? 0 : w[1] ? 1 : w[2] ? 2 : 3;
      const int bit = __ffs(w[q]) - 1;           // the lowest set lane
      acc = acc + tbl[(q * 32 + bit) * LANES + k];
      w[q] &= w[q] - 1u;
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; r++) out[r * LANES + k] = acc;
}

// one warp per row; lane l holds columns l, l + 32, l + 64, l + 96
__global__ void __launch_bounds__(ROWS * 32)
    epilogue_kernel(const float* __restrict__ x, int reps,
                    float* __restrict__ out) {
  const int row = threadIdx.x >> 5, l = threadIdx.x & 31;
  float xv[4];
#pragma unroll
  for (int j = 0; j < 4; j++) xv[j] = x[row * LANES + l + 32 * j];
  float bt = INFINITY, code = 0.0f;
  for (int i = 0; i < reps; i++) {
    const float s = 1.0f + 1e-6f * (float)i;
    float t[4];
#pragma unroll
    for (int j = 0; j < 4; j++) t[j] = xv[j] * s;
    float m = jmin(jmin(t[0], t[1]), jmin(t[2], t[3]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = jmin(m, __shfl_xor_sync(0xffffffffu, m, o));
    int win = LANES;
#pragma unroll
    for (int j = 3; j >= 0; j--)
      if (t[j] == m) win = l + 32 * j;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      win = min(win, __shfl_xor_sync(0xffffffffu, win, o));
    // no lane at the minimum only when it is NaN: the probe's 1e9 then
    const float kwin = win == LANES ? 1e9f : (float)win;
    if (m < bt) {
      bt = m;
      code = kwin + (float)i;
    }
  }
  if (l == 0) out[row] = bt + code;
}

template <bool kBlock, bool kParallel>
int launch_rows(cudaStream_t s, const float* tbl, const int* idx,
                int n_blocks, int reps, float* out) {
  rows_kernel<kBlock, kParallel><<<1, LANES, 0, s>>>(tbl, idx, n_blocks,
                                                     reps, out);
  return (int)cudaGetLastError();
}

}  // namespace

// P5: x, out (8, 128) float32
extern "C" int vimg_probe_setup(const float* x, int static_packet, int reps,
                                float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (static_packet)
    setup_kernel<true><<<1, LANES, 0, s>>>(x, reps, out);
  else
    setup_kernel<false><<<1, LANES, 0, s>>>(x, reps, out);
  return (int)cudaGetLastError();
}

// P6, P9, P10: tbl (n_blocks * 12, 128) float32, idx (64,) int32, out
// (8, 128) float32
extern "C" int vimg_probe_rows(const float* tbl, const int* idx, int n_blocks,
                               int reps, int block_load, int parallel,
                               float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (block_load)
    return parallel ? launch_rows<true, true>(s, tbl, idx, n_blocks, reps, out)
                    : launch_rows<true, false>(s, tbl, idx, n_blocks, reps,
                                               out);
  return parallel ? launch_rows<false, true>(s, tbl, idx, n_blocks, reps, out)
                  : launch_rows<false, false>(s, tbl, idx, n_blocks, reps,
                                              out);
}

// P7: mask (1, 128) float32 (a lane is set where > 0.5), tbl (128, 128)
// float32, out (8, 128) float32
extern "C" int vimg_probe_ffs(const float* mask, const float* tbl, int reps,
                              float* out, void* stream) {
  ffs_kernel<<<1, LANES, 0, (cudaStream_t)stream>>>(mask, tbl, reps, out);
  return (int)cudaGetLastError();
}

// P8: x (8, 128) float32, out (8, 1) float32
extern "C" int vimg_probe_epilogue(const float* x, int reps, float* out,
                                   void* stream) {
  epilogue_kernel<<<1, ROWS * 32, 0, (cudaStream_t)stream>>>(x, reps, out);
  return (int)cudaGetLastError();
}
