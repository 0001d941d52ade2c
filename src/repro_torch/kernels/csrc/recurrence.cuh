// Helpers shared by the chunked-recurrence kernels (rwkv6.cu,
// mamba2_ssd.cu); flash_attention.cu takes the bf16 route's copies,
// ldmatrix, mma.sync, ex2 and split from here too.
//
// The float32 route (selfcheck cases only) keeps the register-tiled
// CUDA-core product (tile_product). The bfloat16 route, the one the
// models take, runs its products on the tensor cores: mma.sync m16n8k16
// with bf16 operands and float32 accumulation, fragments read from shared
// memory with ldmatrix. A float32 operand (a decayed score, a decayed key,
// the state) is split into a bf16 high part and a bf16 low part,
// x ~ hi + lo with |x - hi - lo| <= 2^-16 |x|: a float32 x bf16 product
// takes two passes (hi, lo), a float32 x float32 product three
// (hi.hi + hi.lo + lo.hi). Rounding such an operand to bf16 once would
// cost 2^-9 of each term, which the stated tolerances do not allow.
//
// Tile layout in shared memory: row-major bf16 with a row stride of 72
// elements (144 bytes), so the eight rows an ldmatrix reads fall on eight
// distinct 16-byte bank groups.
//
// Register fragments (PTX ISA, mma.m16n8k16, g = lane / 4, c = lane % 4):
//   A 16x16: a0 (row g, cols 2c, 2c+1), a1 (row g+8, same cols),
//            a2 (row g, cols 2c+8, 2c+9), a3 (row g+8, cols 2c+8, 2c+9)
//   B 16x8:  b0 (rows 2c, 2c+1, col g), b1 (rows 2c+8, 2c+9, col g)
//   C 16x8:  c0, c1 (row g, cols 2c, 2c+1), c2, c3 (row g+8, same cols)
// The state tiles below are held as C fragments, each warp a slab of 16
// rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace recurrence {

// dtype codes passed by the Python wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int LDS = 72;                    // bf16 row stride of a 64-wide tile
constexpr float kLog2e = 1.4426950408889634f;

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

// ---------------------------------------------------------------------------
// bf16 route: asynchronous copies, ldmatrix, mma.sync, operand splitting
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without the registers; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; zeros when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] b[16x8]: bf16 operands, float32 accumulation
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (one instruction); a subnormal result
// flushes to 0. Every exponent the kernels take is <= 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (x, y) ~ hi + lo as two bf16 pairs: hi = bf16(x, y), lo = bf16(rest)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// eight bf16 (16 bytes) to float
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// ROWS x 64 bf16 rows (device row stride 64) into shared memory with row
// stride LDS, asynchronously; rows at and past rows_left read as 0
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int rows_left, int tid) {
  constexpr int kChunks = ROWS * 8;            // 16-byte pieces
  static_assert(kChunks % THREADS == 0, "whole pieces per thread");
#pragma unroll
  for (int it = 0; it < kChunks / THREADS; ++it) {
    const int i = tid + it * THREADS, r = i >> 3, c = (i & 7) * 8;
    const bool valid = r < rows_left;
    cp_async16(dst + r * LDS + c, src + (valid ? r * 64 + c : 0), valid);
  }
}

// A warp's slab of a [64][64] float32 state tile as C fragments: rows
// row0 .. row0+15, columns col0 .. col0 + 8 NT - 1 (S[j] holds columns
// col0 + 8j .. col0 + 8j + 7).
//
// S = dec S + A^T B, where A^T is read transposed from a [K][64] split
// operand (rows k, columns the state's rows) and B from a bf16 [K][64]
// tile. Decays dec0 / dec1 apply to rows g / g+8 of the slab.
template <int KSTEPS, int NT>
__device__ __forceinline__ void state_update(float (&S)[NT][4], float dec0,
                                             float dec1, const bf16* a_hi,
                                             const bf16* a_lo, const bf16* b,
                                             int row0, int col0, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    S[j][0] *= dec0;
    S[j][1] *= dec0;
    S[j][2] *= dec1;
    S[j][3] *= dec1;
  }
  const int i8 = lane & 7;
  const int a_row = i8 + ((lane >> 4) & 1) * 8;
  const int a_col = row0 + ((lane >> 3) & 1) * 8;
  const int b_row = i8 + ((lane >> 3) & 1) * 8;
  const int b_col = col0 + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t ah[4], al[4];
    ldsm_x4_t(ah, a_hi + (16 * kk + a_row) * LDS + a_col);
    ldsm_x4_t(al, a_lo + (16 * kk + a_row) * LDS + a_col);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t bx[4];
      ldsm_x4_t(bx, b + (16 * kk + b_row) * LDS + 16 * jp + b_col);
      mma(S[2 * jp], ah, bx[0], bx[1]);
      mma(S[2 * jp], al, bx[0], bx[1]);
      mma(S[2 * jp + 1], ah, bx[2], bx[3]);
      mma(S[2 * jp + 1], al, bx[2], bx[3]);
    }
  }
}

// The slab into shared memory as split bf16 [64][LDS] tiles (the B
// operand of q S)
template <int NT>
__device__ __forceinline__ void store_state_split(const float (&S)[NT][4],
                                                  bf16* s_hi, bf16* s_lo,
                                                  int row0, int col0,
                                                  int lane) {
  const int r0 = row0 + (lane >> 2), c0 = col0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t hi, lo;
    split_bf16(S[j][0], S[j][1], hi, lo);
    *reinterpret_cast<uint32_t*>(s_hi + r0 * LDS + 8 * j + c0) = hi;
    *reinterpret_cast<uint32_t*>(s_lo + r0 * LDS + 8 * j + c0) = lo;
    split_bf16(S[j][2], S[j][3], hi, lo);
    *reinterpret_cast<uint32_t*>(s_hi + (r0 + 8) * LDS + 8 * j + c0) = hi;
    *reinterpret_cast<uint32_t*>(s_lo + (r0 + 8) * LDS + 8 * j + c0) = lo;
  }
}

// The slab from / to a float32 [64][64] tile in device memory
template <int NT>
__device__ __forceinline__ void state_load(float (&S)[NT][4],
                                           const float* src, int row0,
                                           int col0, int lane) {
  const int r0 = row0 + (lane >> 2), c0 = col0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 a = *reinterpret_cast<const float2*>(src + r0 * 64 + 8 * j
                                                      + c0);
    const float2 b = *reinterpret_cast<const float2*>(
        src + (r0 + 8) * 64 + 8 * j + c0);
    S[j][0] = a.x;
    S[j][1] = a.y;
    S[j][2] = b.x;
    S[j][3] = b.y;
  }
}

template <int NT>
__device__ __forceinline__ void state_store(const float (&S)[NT][4],
                                            float* dst, int row0, int col0,
                                            int lane) {
  const int r0 = row0 + (lane >> 2), c0 = col0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    *reinterpret_cast<float2*>(dst + r0 * 64 + 8 * j + c0) =
        make_float2(S[j][0], S[j][1]);
    *reinterpret_cast<float2*>(dst + (r0 + 8) * 64 + 8 * j + c0) =
        make_float2(S[j][2], S[j][3]);
  }
}

// The state entering segment `seg`: the initial state (or zeros) carried
// through the transitions S <- D_i S + M_i of segments 0 .. seg-1, where
// M is [seg][64][64] and D is [seg][64] (a decay per state row, rwkv6) or
// [seg] (one per segment, mamba2).
template <bool kRowDecay, int NT>
__device__ __forceinline__ void state_entering(float (&S)[NT][4],
                                               const float* s0,
                                               const float* M, const float* D,
                                               int seg, int row0, int col0,
                                               int lane) {
  if (s0) {
    state_load(S, s0, row0, col0, lane);
  } else {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[j][e] = 0.0f;
  }
  const int r0 = row0 + (lane >> 2);
  for (int i = 0; i < seg; ++i) {
    const float d0 = kRowDecay ? D[i * 64 + r0] : D[i];
    const float d1 = kRowDecay ? D[i * 64 + r0 + 8] : D[i];
    float m[NT][4];
    state_load(m, M + (size_t)i * 64 * 64, row0, col0, lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      S[j][0] = fmaf(d0, S[j][0], m[j][0]);
      S[j][1] = fmaf(d0, S[j][1], m[j][1]);
      S[j][2] = fmaf(d1, S[j][2], m[j][2]);
      S[j][3] = fmaf(d1, S[j][3], m[j][3]);
    }
  }
}

}  // namespace recurrence
