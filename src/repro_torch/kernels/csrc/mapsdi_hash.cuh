// The 32-bit row hash shared by the rowhash, neighbor-flag and radix
// partition kernels. It must equal the plain PyTorch version
// (repro_torch/kernels/rowhash/ref.py) bit for bit:
//
//   h = FNV_OFFSET
//   for each column j:  h = (h ^ fmix32(uint32(x_j) + GOLDEN * (j + 1)))
//                             * FNV_PRIME
//   hash = fmix32(h)
//
// All arithmetic is native uint32_t, which wraps modulo 2^32 exactly as
// the reference's uint32 arithmetic does.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define MAPSDI_FNV_OFFSET 2166136261u
#define MAPSDI_FNV_PRIME 16777619u
#define MAPSDI_GOLDEN 0x9E3779B9u
#define MAPSDI_PAD_ID 2147483647

__device__ __forceinline__ uint32_t mapsdi_fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Hash of one row's K consecutive int32 columns.
__device__ __forceinline__ uint32_t mapsdi_row_hash(const int32_t* row,
                                                    int k) {
  uint32_t h = MAPSDI_FNV_OFFSET;
  for (int j = 0; j < k; ++j) {
    uint32_t salt = MAPSDI_GOLDEN * (uint32_t)(j + 1);
    uint32_t v = mapsdi_fmix32((uint32_t)row[j] + salt);
    h = (h ^ v) * MAPSDI_FNV_PRIME;
  }
  return mapsdi_fmix32(h);
}
