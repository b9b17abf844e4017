// Counter RNG: PCG4D in native uint32 (vimg_tpu.core.rng, the port's
// core/rng.py), shared by the megakernel (B1/B2) and probe P25.
#pragma once

#include <stdint.h>

struct U4 { float a, b, c, d; };

__device__ __forceinline__ float u2f(uint32_t u) {
  return (float)(u >> 8) * 5.9604645e-08f;
}

__device__ __forceinline__ U4 uniform4(uint32_t pix, uint32_t samp,
                                       uint32_t bounce, uint32_t draw) {
  uint32_t x = pix * 1664525u + 1013904223u;
  uint32_t y = samp * 1664525u + 1013904223u;
  uint32_t z = bounce * 1664525u + 1013904223u;
  uint32_t w = draw * 1664525u + 1013904223u;
  x += y * w; y += z * x; z += x * y; w += y * z;
  x ^= x >> 16; y ^= y >> 16; z ^= z >> 16; w ^= w >> 16;
  x += y * w; y += z * x; z += x * y; w += y * z;
  U4 r = {u2f(x), u2f(y), u2f(z), u2f(w)};
  return r;
}
