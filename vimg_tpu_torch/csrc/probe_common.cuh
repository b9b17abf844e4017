// Shared launch helper of the probe kernels (csrc/probe_vpu.cu,
// probe_gather.cu, probe_lowering.cu).
#pragma once

#include <cuda_runtime.h>

// Blocks of a probe launch: n_blocks when it is positive (the probe's own
// size); otherwise the full card, every SM times the blocks of this kernel
// that fit on one at once (its occupancy). Written to *grid_used when that
// is not null.
template <class Kernel>
inline int probe_grid(Kernel kernel, int threads, int n_blocks,
                      int* grid_used) {
  int grid = n_blocks;
  if (grid <= 0) {
    int dev = 0, sms = 0, per = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, threads, 0);
    grid = sms * (per > 0 ? per : 1);
  }
  if (grid_used) *grid_used = grid;
  return grid;
}
