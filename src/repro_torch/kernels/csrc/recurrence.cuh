// Helpers shared by the chunked-recurrence kernels (rwkv6.cu,
// mamba2_ssd.cu): element conversion for the two input types they take
// (float32 and bfloat16) and a register-tiled product of two operands in
// shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace recurrence {

// dtype codes passed by the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 256 threads as a 16 x 16 grid; thread (ty, tx) owns output rows
// ty + 16 i (i < RI) and columns tx + 16 j (j < 4) of a (16 RI) x 64 tile.
// acc[i][j] += sum_{kk < K} A(row_i, kk) * B(kk, col_j), where
// A(r, kk) = A[r * a_r + kk * a_k] and B(kk, c) = B[kk * b_k + c * b_c].
// Each step reads RI + 4 values and does 4 RI multiply-adds.
template <int RI>
__device__ __forceinline__ void tile_product(float (&acc)[RI][4], int K,
                                             const float* A, int a_r,
                                             int a_k, const float* B,
                                             int b_k, int b_c, int ty,
                                             int tx) {
  for (int kk = 0; kk < K; ++kk) {
    float a[RI], b[4];
#pragma unroll
    for (int i = 0; i < RI; ++i) a[i] = A[(ty + 16 * i) * a_r + kk * a_k];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[kk * b_k + (tx + 16 * j) * b_c];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int RI>
__device__ __forceinline__ void tile_zero(float (&acc)[RI][4]) {
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

}  // namespace recurrence
