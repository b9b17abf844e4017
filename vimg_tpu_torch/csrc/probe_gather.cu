// Gather-form and matrix-unit probes for Hopper (sm_90a): kernels P16-P19,
// P21 and P22 of vimg_tpu_torch's probes (probes/probe_r2c.py,
// probe_r4j.py).
//
// Replaces:
//   P16 tools/probe_r2c.py::gather_take (pallas_call :79): sum over k < 100
//       of tab[(idx + k) % n, lane], tab (n, 128) float32.
//   P17 tools/probe_r2c.py::gather_onehot (pallas_call :115): 10 x
//       (one-hot(idx) (4096 x n) bf16 @ bf16(tab) (n x 4)), column 0.
//   P18 tools/probe_r2c.py::gather_selchain (pallas_call :142): sum over
//       k < 10 of a select chain over the n rows of tab[:, 0].
//   P19 tools/probe_r2c.py::mxu_precision (pallas_call :170): a 256 x 256
//       float32 matrix product at the default and at HIGHEST precision.
//   P21 tools/probe_r4j.py::make_fn (pallas_call :94): a per-lane lookup of
//       n_params-row material columns, as three bf16 one-hot products (hi,
//       mid, lo) summed over the parameters (mxu), or as an n_mats x
//       n_params select chain of t_hi (chain).
//   P22 tools/probe_r4j.py::make_check_fn (pallas_call :115): one row of
//       ids through the three one-hot products, bit-exact to table[:, ids].
//
// Design:
//  - P16: one thread an output, an indexed load from device memory through
//    the read-only cache (__ldg) a step, summed in k order: the card's
//    native gather.
//  - P17, P21, P22 run on the tensor cores: mma.sync m16n8k16 bf16 -> f32,
//    the one-hot fragment built in registers from the ids (P17: the
//    one-hot is A, rows = lanes; P21/P22: it is B, columns = lanes). Every
//    output of a product is one exact bf16 value times 1 plus zeros, so it
//    is exact whatever order the tensor core adds in; each product starts
//    from a zero accumulator, and the hi + mid + lo sums run in IEEE
//    float32. P17 builds the one-hot from idx, not from idx + k, as the
//    TPU kernel does (ROADMAP C15).
//  - P18: the unrolled compare-select chain (a template on n) over a
//    shared-memory copy of tab[:, 0], every lane the whole chain.
//  - P19 "default" is TF32 on the tensor cores (mma.sync m16n8k8, inputs
//    rounded by cvt.rna.tf32.f32): 32 x 32 block tiles whose A and B
//    panels cp.async stages in shared memory, K in four groups in flight
//    at once (mm_tf32_kernel); "highest" a tiled float32 kernel of
//    explicit fmaf (16 x 16 tiles through shared memory).
//  - P21 mxu: one block; warp w takes lanes 8w..8w+7; the (n_params, 128)
//    values of a row go through shared memory and 128 threads sum them
//    over the parameters in the plain version's order.
//  - P22: a grid of (128 / 8) x (ppad / 16) one-warp blocks, one output
//    tile each; a warp multiplies only the k-tiles its 8 ids touch (at
//    most 8 of npad / 16), staged by cp.async in one round trip (see
//    lookup_check_kernel for why the bits do not change).
// The file is built with -fmad=false and without fast math.
//
// What bounds them on this card: P16 and P18 latency at the probe's
// 4,096 lanes; P17 and P21 the dense one-hot products (16 x 8 x 16 MACs an
// mma, most of them on zeros), P19 the tensor-core or FP32 rate; P22 the
// latency of one launch, one load of its ids and one of its tiles. All are
// far from their bytes bound.
//
// Launch contract: the vimg_probe_* functions launch on the given stream,
// do not synchronise and allocate nothing; they return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr uint32_t BF16_ONE = 0x3F80u;

__device__ __forceinline__ uint32_t pack_onehot(bool lo, bool hi) {
  return (lo ? BF16_ONE : 0u) | (hi ? BF16_ONE << 16 : 0u);
}

// D = A (16 x 16 bf16, row) * B (16 x 8 bf16, col) + C, float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// P16: per-lane indexed load
// ---------------------------------------------------------------------------

constexpr int LANES = 128;
constexpr int TILE = 32 * 128;         // the probes' (32, 128) tile

__global__ void __launch_bounds__(LANES)
    take_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                int n, int reps, float* __restrict__ out) {
  const int e = blockIdx.x * LANES + threadIdx.x;
  const int lane = threadIdx.x;
  const int i = idx[e];
  float acc = 0.0f;
  for (int k = 0; k < reps; k++)
    acc = __fadd_rn(acc, __ldg(tab + ((i + k) % n) * LANES + lane));
  out[e] = acc;
}

// ---------------------------------------------------------------------------
// P17: one-hot (lanes x n) @ bf16 table (n x 8, columns 4..7 zero)
// ---------------------------------------------------------------------------

constexpr int OH_WARPS = 8;

// tab: (n, 4) float32, n % 16 == 0; staged as bf16, transposed to (8, n)
// with rows 4..7 zero (the B operand's 8 columns)
__global__ void __launch_bounds__(OH_WARPS * 32)
    onehot_kernel(const float* __restrict__ tab,
                  const int* __restrict__ idx, int n, int reps,
                  float* __restrict__ out) {
  extern __shared__ __nv_bfloat16 s_bt[];  // (8, n)
  for (int e = threadIdx.x; e < 8 * n; e += blockDim.x) {
    const int c = e / n, r = e % n;
    s_bt[e] = __float2bfloat16_rn(c < 4 ? tab[r * 4 + c] : 0.0f);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  const int r0 = (blockIdx.x * OH_WARPS + (threadIdx.x >> 5)) * 16 + g;
  const int id0 = idx[r0], id1 = idx[r0 + 8];
  const uint32_t* bt = reinterpret_cast<const uint32_t*>(s_bt + g * n);
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int rep = 0; rep < reps; rep++) {
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int kb = 0; kb < n; kb += 16) {
      const int c = kb + 2 * tg;
      const uint32_t a[4] = {pack_onehot(id0 == c, id0 == c + 1),
                             pack_onehot(id1 == c, id1 == c + 1),
                             pack_onehot(id0 == c + 8, id0 == c + 9),
                             pack_onehot(id1 == c + 8, id1 == c + 9)};
      mma_bf16(d, a, bt[c >> 1], bt[(c + 8) >> 1]);
    }
    acc0 = __fadd_rn(acc0, d[0]);            // (row g, column 2 tg)
    acc1 = __fadd_rn(acc1, d[2]);            // (row g + 8, column 2 tg)
  }
  if (tg == 0) {
    out[r0] = acc0;
    out[r0 + 8] = acc1;
  }
}

// ---------------------------------------------------------------------------
// P18: select chain over tab[:, 0] in shared memory
// ---------------------------------------------------------------------------

template <int N>
__global__ void __launch_bounds__(LANES)
    selchain_kernel(const float* __restrict__ tab, const int* __restrict__ idx,
                    int reps, float* __restrict__ out) {
  __shared__ float s_col[N];
  for (int r = threadIdx.x; r < N; r += LANES) s_col[r] = tab[r * 4];
  __syncthreads();
  const int e = blockIdx.x * LANES + threadIdx.x;
  const int i = idx[e];
  float acc = 0.0f;
  for (int k = 0; k < reps; k++) {
    const int ii = (i + k) % N;
    float g = 0.0f;
#pragma unroll
    for (int row = 0; row < N; row++) g = ii == row ? s_col[row] : g;
    acc = __fadd_rn(acc, g);
  }
  out[e] = acc;
}

// ---------------------------------------------------------------------------
// P19: 256 x 256 float32 products
// ---------------------------------------------------------------------------

constexpr int MM = 256;

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// TF32: a block a 32 x 32 output tile, 8 warps. All of K is issued up
// front as four cp.async groups of 64 k (A's 32-row panel and B's 32-column
// panel, 16 coalesced bytes a copy, 78,848 bytes of shared memory with the
// output tile); as each group lands, the threads that copied it round it
// to TF32 in place (cvt.rna.tf32.f32, once an element) and the block
// multiplies it. Warp w holds the 16 x 16 tile (w & 1, (w >> 1) & 1) as
// two m16n8k8 accumulators over the k steps of parity w >> 2; the two
// parities are added through shared memory and the tile leaves in
// coalesced 16-byte stores. Rows are padded (A 260, B 40 floats) so the
// fragment reads are free of bank conflicts.
constexpr int TT = 32;                   // output tile edge
constexpr int TT_THREADS = 256;
constexpr int KCH = 64;                  // k per cp.async group
constexpr int A_LD = MM + 4, B_LD = TT + 8, C_LD = TT + 4;
constexpr int TT_SMEM = (TT * A_LD + MM * B_LD + TT * C_LD) * 4;

__device__ __forceinline__ void mm_cp16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// the thread's copies of group `ch`: two float4 of A, two of B
__device__ __forceinline__ float* mm_slot(float* sa, float* sb, int ch,
                                          int u, int tid) {
  const int idx = (u & 1) * TT_THREADS + tid;
  return u < 2 ? sa + (idx >> 4) * A_LD + ch * KCH + (idx & 15) * 4
               : sb + (ch * KCH + (idx >> 3)) * B_LD + (idx & 7) * 4;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(TT_THREADS)
    mm_tf32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   float* __restrict__ c) {
  extern __shared__ float4 mm_smem4[];
  float* sa = reinterpret_cast<float*>(mm_smem4);   // [TT][A_LD]
  float* sb = sa + TT * A_LD;                        // [MM][B_LD]
  float* sc = sb + MM * B_LD;                        // [TT][C_LD]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.y * TT, n0 = blockIdx.x * TT;

#pragma unroll
  for (int ch = 0; ch < MM / KCH; ch++) {
#pragma unroll
    for (int u = 0; u < 4; u++) {
      const int idx = (u & 1) * TT_THREADS + tid;
      const float* src =
          u < 2 ? a + (m0 + (idx >> 4)) * MM + ch * KCH + (idx & 15) * 4
                : b + (ch * KCH + (idx >> 3)) * MM + n0 + (idx & 7) * 4;
      mm_cp16(mm_slot(sa, sb, ch, u, tid), src);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  const int wm = (warp & 1) * 16, wn = ((warp >> 1) & 1) * 16;
  const int kh = warp >> 2;
  float d[2][4] = {};
#pragma unroll
  for (int ch = 0; ch < MM / KCH; ch++) {
    if (ch == 0) asm volatile("cp.async.wait_group 3;\n" ::);
    if (ch == 1) asm volatile("cp.async.wait_group 2;\n" ::);
    if (ch == 2) asm volatile("cp.async.wait_group 1;\n" ::);
    if (ch == 3) asm volatile("cp.async.wait_group 0;\n" ::);
#pragma unroll
    for (int u = 0; u < 4; u++) {
      float4* p = reinterpret_cast<float4*>(mm_slot(sa, sb, ch, u, tid));
      float4 v = *p;
      v.x = __uint_as_float(to_tf32(v.x));
      v.y = __uint_as_float(to_tf32(v.y));
      v.z = __uint_as_float(to_tf32(v.z));
      v.w = __uint_as_float(to_tf32(v.w));
      *p = v;
    }
    __syncthreads();
#pragma unroll
    for (int s = kh; s < KCH / 8; s += 2) {
      const int k0 = ch * KCH + s * 8;
      const float* ar = sa + (wm + g) * A_LD + k0 + tg;
      const uint32_t af[4] = {
          __float_as_uint(ar[0]), __float_as_uint(ar[8 * A_LD]),
          __float_as_uint(ar[4]), __float_as_uint(ar[8 * A_LD + 4])};
#pragma unroll
      for (int j = 0; j < 2; j++) {
        const float* br = sb + (k0 + tg) * B_LD + wn + j * 8 + g;
        mma_tf32(d[j], af, __float_as_uint(br[0]),
                 __float_as_uint(br[4 * B_LD]));
      }
    }
  }

  // odd k steps + even k steps, then the tile in 16-byte rows
  float* cr = sc + (wm + g) * C_LD + wn + 2 * tg;
  if (kh == 1) {
#pragma unroll
    for (int j = 0; j < 2; j++) {
      cr[j * 8] = d[j][0];
      cr[j * 8 + 1] = d[j][1];
      cr[8 * C_LD + j * 8] = d[j][2];
      cr[8 * C_LD + j * 8 + 1] = d[j][3];
    }
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int j = 0; j < 2; j++) {
      cr[j * 8] = d[j][0] + cr[j * 8];
      cr[j * 8 + 1] = d[j][1] + cr[j * 8 + 1];
      cr[8 * C_LD + j * 8] = d[j][2] + cr[8 * C_LD + j * 8];
      cr[8 * C_LD + j * 8 + 1] = d[j][3] + cr[8 * C_LD + j * 8 + 1];
    }
  }
  __syncthreads();
  const int row = tid >> 3, c4 = (tid & 7) * 4;
  *reinterpret_cast<float4*>(c + (m0 + row) * MM + n0 + c4) =
      *reinterpret_cast<const float4*>(sc + row * C_LD + c4);
}

constexpr int MT = 16;

__global__ void __launch_bounds__(MT * MT)
    mm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c) {
  __shared__ float sa[MT][MT], sb[MT][MT];
  const int tx = threadIdx.x % MT, ty = threadIdx.x / MT;
  const int row = blockIdx.y * MT + ty, col = blockIdx.x * MT + tx;
  float acc = 0.0f;
  for (int k0 = 0; k0 < MM; k0 += MT) {
    sa[ty][tx] = a[row * MM + k0 + tx];
    sb[ty][tx] = b[(k0 + ty) * MM + col];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < MT; k++) acc = __fmaf_rn(sa[ty][k], sb[k][tx], acc);
    __syncthreads();
  }
  c[row * MM + col] = acc;
}

// ---------------------------------------------------------------------------
// P21 / P22: bf16 x 3 one-hot lookup of (n_params, n_mats) tables
// ---------------------------------------------------------------------------

constexpr int LK_WARPS = 16;          // 16 warps x 8 lanes = 128 lanes
constexpr int MAX_PARAMS = 64;

// the three products of one row of ids: s_val[p][lane] = (hi + mid) + lo
// tables: (ppad, npad) bf16 bits, ppad % 16 == 0, npad % 8 == 0; the k
// steps of 16 read zeros past npad
__device__ __forceinline__ uint32_t pair(const uint16_t* __restrict__ t,
                                         int row, int col, int npad) {
  return col < npad
             ? __ldg(reinterpret_cast<const uint32_t*>(t + row * npad + col))
             : 0u;
}

__device__ __forceinline__ void lookup_row(
    const uint16_t* __restrict__ hi, const uint16_t* __restrict__ mid,
    const uint16_t* __restrict__ lo, int id, int ppad, int npad,
    float (*s_val)[LANES]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  const int n0 = (threadIdx.x >> 5) * 8;
  const uint16_t* tabs[3] = {hi, mid, lo};
  for (int m0 = 0; m0 < ppad; m0 += 16) {
    float d[3][4] = {};
    for (int kb = 0; kb < npad; kb += 16) {
      const int c = kb + 2 * tg;
      const uint32_t b0 = pack_onehot(id == c, id == c + 1);
      const uint32_t b1 = pack_onehot(id == c + 8, id == c + 9);
#pragma unroll
      for (int q = 0; q < 3; q++) {
        const uint32_t a[4] = {pair(tabs[q], m0 + g, c, npad),
                               pair(tabs[q], m0 + g + 8, c, npad),
                               pair(tabs[q], m0 + g, c + 8, npad),
                               pair(tabs[q], m0 + g + 8, c + 8, npad)};
        mma_bf16(d[q], a, b0, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; j++) {
      const int p = m0 + g + (j >= 2 ? 8 : 0);
      const int l = n0 + 2 * tg + (j & 1);
      s_val[p][l] = __fadd_rn(__fadd_rn(d[0][j], d[1][j]), d[2][j]);
    }
  }
}

// the sum over the parameters in order, as XLA's CPU reduction over the
// major axis computes it (and the plain version)
__device__ __forceinline__ float param_sum(float (*s_val)[LANES], int n,
                                           int lane) {
  float s = s_val[0][lane];
  for (int p = 1; p < n; p++) s = __fadd_rn(s, s_val[p][lane]);
  return s;
}

// ids (rows, 128); out (rows, 128), every row the same (the probe's
// broadcast of its (1, 128) sum)
__global__ void __launch_bounds__(LK_WARPS * 32)
    lookup_mxu_kernel(const int* __restrict__ ids,
                      const uint16_t* __restrict__ hi,
                      const uint16_t* __restrict__ mid,
                      const uint16_t* __restrict__ lo, int n_params,
                      int ppad, int npad, int rows, int reps,
                      float* __restrict__ out) {
  __shared__ float s_val[MAX_PARAMS][LANES];
  const int t = threadIdx.x;
  const int lane_id = (t >> 5) * 8 + (t & 31) / 4;   // this thread's B column
  float acc = 0.0f;                                   // threads t < 128
  for (int rep = 0; rep < reps; rep++) {
    float s = 0.0f;
    for (int r = 0; r < rows; r++) {
      lookup_row(hi, mid, lo, ids[r * LANES + lane_id], ppad, npad, s_val);
      __syncthreads();
      if (t < LANES) s = __fadd_rn(s, param_sum(s_val, n_params, t));
      __syncthreads();
    }
    acc = __fadd_rn(acc, s);
  }
  if (t < LANES)
    for (int r = 0; r < rows; r++) out[r * LANES + t] = acc;
}

// P22: one warp a (16-parameter m-tile, 8-lane n-tile) pair of the
// (ppad, 128) output, one warp a block. The warp's 8 ids touch at most 8 of
// the npad / 16 k-tiles; only those are multiplied, in increasing order.
// A skipped tile would add products that are all +-0 to an accumulator
// that starts at +0, and x + (+-0) = x for x != 0, (+0) + (-0) = +0, so
// every output keeps its bits. The touched tiles of the three tables are
// staged in shared memory by cp.async, all in flight at once, then read as
// A fragments for the mma.
constexpr int CK_TILES = 8;           // at most one k-tile per column

__global__ void __launch_bounds__(32)
    lookup_check_kernel(const int* __restrict__ ids,
                        const uint16_t* __restrict__ hi,
                        const uint16_t* __restrict__ mid,
                        const uint16_t* __restrict__ lo, int npad,
                        float* __restrict__ out) {
  __shared__ __align__(16) uint16_t s_a[CK_TILES][3][16][16];
  const int lane = threadIdx.x, g = lane >> 2, tg = lane & 3;
  const int n0 = blockIdx.x * 8, m0 = blockIdx.y * 16;
  const int id = ids[n0 + g];
  const int tile = id >> 4;
  const uint16_t* tabs[3] = {hi, mid, lo};
  // the distinct touched tiles, smallest first; each lane copies 16 bytes
  // (row lane / 2, half lane % 2) of each, zero-filled past npad
  const int row = lane >> 1, half = (lane & 1) * 8;
  int tiles[CK_TILES];
  int last = -1;
#pragma unroll
  for (int j = 0; j < CK_TILES; j++) {
    tiles[j] = __reduce_min_sync(0xffffffffu, tile > last ? tile : INT_MAX);
    if (tiles[j] != INT_MAX) {
      const int col = tiles[j] * 16 + half;
      const bool in = col < npad;
#pragma unroll
      for (int q = 0; q < 3; q++)
        __pipeline_memcpy_async(&s_a[j][q][row][half],
                                tabs[q] + (m0 + row) * npad + (in ? col : 0),
                                16, in ? 0 : 16);
      last = tiles[j];
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncwarp();
  float d[3][4] = {};
#pragma unroll
  for (int j = 0; j < CK_TILES; j++) {
    if (tiles[j] == INT_MAX) break;
    const int c = tiles[j] * 16 + 2 * tg;
    const uint32_t b0 = pack_onehot(id == c, id == c + 1);
    const uint32_t b1 = pack_onehot(id == c + 8, id == c + 9);
#pragma unroll
    for (int q = 0; q < 3; q++) {
      const uint32_t a[4] = {
          *reinterpret_cast<const uint32_t*>(&s_a[j][q][g][2 * tg]),
          *reinterpret_cast<const uint32_t*>(&s_a[j][q][g + 8][2 * tg]),
          *reinterpret_cast<const uint32_t*>(&s_a[j][q][g][2 * tg + 8]),
          *reinterpret_cast<const uint32_t*>(&s_a[j][q][g + 8][2 * tg + 8])};
      mma_bf16(d[q], a, b0, b1);
    }
  }
#pragma unroll
  for (int j = 0; j < 4; j++) {
    const int p = m0 + g + (j >= 2 ? 8 : 0);
    const int l = n0 + 2 * tg + (j & 1);
    out[p * LANES + l] = __fadd_rn(__fadd_rn(d[0][j], d[1][j]), d[2][j]);
  }
}

// chain: t_hi (>= n_params, npad) bf16, widened to float32 in shared
// memory; one thread a lane of (rows, 128)
__global__ void __launch_bounds__(1024)
    lookup_chain_kernel(const int* __restrict__ ids,
                        const __nv_bfloat16* __restrict__ t_hi, int n_mats,
                        int n_params, int npad, int reps,
                        float* __restrict__ out) {
  extern __shared__ float s_th[];            // (n_params, n_mats)
  for (int e = threadIdx.x; e < n_params * n_mats; e += blockDim.x)
    s_th[e] = __bfloat162float(t_hi[(e / n_mats) * npad + e % n_mats]);
  __syncthreads();
  const int e = threadIdx.x;
  const int id = ids[e];
  float acc = 0.0f;
  for (int rep = 0; rep < reps; rep++) {
    float tot = 0.0f;
    for (int k = 0; k < n_mats; k++) {
      const bool m = id == k;
#pragma unroll 8
      for (int p = 0; p < n_params; p++)
        tot = __fadd_rn(tot, m ? s_th[p * n_mats + k] : 0.0f);
    }
    acc = __fadd_rn(acc, tot);
  }
  out[e] = acc;
}

}  // namespace

// P16: tab (n, 128) float32, idx and out (32, 128).
extern "C" int vimg_probe_take(const float* tab, const int* idx, int n,
                               int reps, float* out, void* stream) {
  take_kernel<<<TILE / LANES, LANES, 0, (cudaStream_t)stream>>>(tab, idx, n,
                                                                reps, out);
  return (int)cudaGetLastError();
}

// P17: tab (n, 4) float32, n % 16 == 0 and n <= 2048; idx and out
// (32, 128).
extern "C" int vimg_probe_onehot(const float* tab, const int* idx, int n,
                                 int reps, float* out, void* stream) {
  if (n % 16 || n > 2048) return (int)cudaErrorInvalidValue;
  onehot_kernel<<<TILE / 16 / OH_WARPS, OH_WARPS * 32, 8 * n * 2,
                  (cudaStream_t)stream>>>(tab, idx, n, reps, out);
  return (int)cudaGetLastError();
}

// P18: tab (n, 4) float32, n 64 or 256; idx and out (32, 128).
extern "C" int vimg_probe_selchain(const float* tab, const int* idx, int n,
                                   int reps, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 64:
      selchain_kernel<64><<<TILE / LANES, LANES, 0, s>>>(tab, idx, reps, out);
      break;
    case 256:
      selchain_kernel<256><<<TILE / LANES, LANES, 0, s>>>(tab, idx, reps, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// P19: a, b, c (256, 256) float32; tf32 1: the TF32 tensor-core kernel,
// 0: the float32 FMA kernel.
extern "C" int vimg_probe_matmul(const float* a, const float* b, int tf32,
                                 float* c, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tf32) {
    // the opt-in is per device: set it on every launch (it is cheap)
    const cudaError_t e = cudaFuncSetAttribute(
        mm_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, TT_SMEM);
    if (e != cudaSuccess) return (int)e;
    mm_tf32_kernel<<<dim3(MM / TT, MM / TT), TT_THREADS, TT_SMEM, s>>>(a, b,
                                                                       c);
  } else {
    mm_f32_kernel<<<dim3(MM / MT, MM / MT), MT * MT, 0, s>>>(a, b, c);
  }
  return (int)cudaGetLastError();
}

// P21 (mxu) and P22 (check: rows 1, reps 1, out (ppad, 128)): ids (rows,
// 128) int32; hi, mid, lo (ppad, npad) bf16 bits; ppad % 16 == 0,
// ppad <= 64, npad % 8 == 0.
extern "C" int vimg_probe_lookup_mxu(const int* ids, const uint16_t* hi,
                                     const uint16_t* mid, const uint16_t* lo,
                                     int n_params, int ppad, int npad,
                                     int rows, int reps, int check,
                                     float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ppad % 16 || ppad > MAX_PARAMS || npad % 8 || n_params > ppad)
    return (int)cudaErrorInvalidValue;
  if (check)
    lookup_check_kernel<<<dim3(LANES / 8, ppad / 16), 32, 0, s>>>(
        ids, hi, mid, lo, npad, out);
  else
    lookup_mxu_kernel<<<1, LK_WARPS * 32, 0, s>>>(ids, hi, mid, lo, n_params,
                                                   ppad, npad, rows, reps,
                                                   out);
  return (int)cudaGetLastError();
}

// P21 (chain): ids and out (rows, 128) int32 / float32, rows * 128 <=
// 1024; t_hi (>= n_params, npad) bf16 bits, n_mats <= npad.
extern "C" int vimg_probe_lookup_chain(const int* ids, const uint16_t* t_hi,
                                       int n_mats, int n_params, int npad,
                                       int rows, int reps, float* out,
                                       void* stream) {
  const int smem = n_params * n_mats * 4;
  if (rows * LANES > 1024 || smem > 48 * 1024 || n_mats > npad)
    return (int)cudaErrorInvalidValue;
  lookup_chain_kernel<<<1, rows * LANES, smem, (cudaStream_t)stream>>>(
      ids, reinterpret_cast<const __nv_bfloat16*>(t_hi), n_mats, n_params,
      npad, reps, out);
  return (int)cudaGetLastError();
}
