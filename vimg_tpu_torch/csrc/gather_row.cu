// Launcher of kernel B6 (gather_row.cuh) over a batch of ids: out[q, j] =
// table[q, ids[j]] for q < p, j < n_ids, from the three bfloat16 tables of
// ops/mxu_gather.py::split3.
//
// Replaces: vimg_tpu/ops/mxu_gather.py::gather_row (see gather_row.cuh).
// Design: one thread per id; the thread reads its id once and writes its p
// outputs, each store coalesced across the warp (neighbouring ids,
// neighbouring addresses). The tables (p * n_rows * 6 bytes) stay in L1/L2.
// What bounds it on this card: bytes, the ids read and the p float32
// outputs written per id.
//
// Launch contract: vimg_gather_rows() launches on the given stream, does not
// synchronise and allocates nothing; it returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gather_row.cuh"

namespace {

constexpr int BLOCK = 256;

__global__ void __launch_bounds__(BLOCK)
    gather_rows_kernel(const __nv_bfloat16* __restrict__ hi,
                       const __nv_bfloat16* __restrict__ mid,
                       const __nv_bfloat16* __restrict__ lo,
                       const int* __restrict__ ids, int p, int n_rows,
                       int n_ids, float* __restrict__ out) {
  const int j = blockIdx.x * BLOCK + threadIdx.x;
  if (j >= n_ids) return;
  const int id = ids[j];
  for (int q = 0; q < p; q++)
    out[(size_t)q * n_ids + j] = gather::gather_row(hi, mid, lo, n_rows, q, id);
}

}  // namespace

extern "C" int vimg_gather_rows(const void* hi, const void* mid,
                                const void* lo, const int* ids, int p,
                                int n_rows, int n_ids, float* out,
                                void* stream) {
  const int blocks = (n_ids + BLOCK - 1) / BLOCK;
  gather_rows_kernel<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)hi, (const __nv_bfloat16*)mid,
      (const __nv_bfloat16*)lo, ids, p, n_rows, n_ids, out);
  return (int)cudaGetLastError();
}
