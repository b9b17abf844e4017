// Exact float32 lookup in a table kept as three bfloat16 tables (kernel B6's
// device helper, for in-kernel table lookups of the megakernels).
//
// Replaces: vimg_tpu/ops/mxu_gather.py::gather_row, which looks a row up
// inside a Pallas kernel as a one-hot bf16 matmul on the MXU (Mosaic has no
// per-lane gather). A GPU thread loads by index, so the lookup here is three
// indexed loads; what is kept is the contract: ops/mxu_gather.py::split3
// splits the float32 table into hi, mid, lo with hi + mid + lo exact, and
// (hi + mid) + lo in float32 (the MXU's order of the three products)
// returns the entry bit for bit. An id outside [0, n_rows) reads nothing
// and returns 0, as the one-hot product does.
//
// Tables are (p, n_rows) row-major: entry q of table row id at [q*n_rows+id].
#pragma once

#include <cuda_bf16.h>
#include <stddef.h>

namespace gather {

__device__ __forceinline__ float gather_row(
    const __nv_bfloat16* __restrict__ hi, const __nv_bfloat16* __restrict__ mid,
    const __nv_bfloat16* __restrict__ lo, int n_rows, int q, int id) {
  if (id < 0 || id >= n_rows) return 0.0f;
  const size_t i = (size_t)q * n_rows + id;
  return (__bfloat162float(hi[i]) + __bfloat162float(mid[i])) +
         __bfloat162float(lo[i]);
}

}  // namespace gather
