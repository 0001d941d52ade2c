// Mamba2 SSD (state-space dual) chunk scan, for one card.
//
// Replaces the TPU kernel mamba2_ssd_pallas
// (src/repro/kernels/mamba2/mamba2.py), whose grid ran (B*H, T/L) with the
// chunk axis sequential and the [N, P] state in VMEM scratch.
//
// Per (batch, head), over chunks of L = 64 tokens (state N = 64, head dim
// P = 64), with xdt = x * dt, la = dt * A, and b/c shared by the heads of
// a batch row:
//   cum = inclusive cumsum of la over the chunk
//   scores[t, s] = (c b^T)[t, s] * exp(cum[t] - cum[s])   for s <= t
//   y = scores xdt + (c exp(cum)) S
//   S = exp(cum[L-1]) S + (b exp(cum[L-1] - cum))^T xdt
// all in float32, with y written in xdt's type. Tokens at and past T read
// as xdt = b = c = 0, la = 0 (padding that changes neither the first T
// outputs nor the final state), so any T is taken.
//
// What bounds it on the card: float32 operations. Per chunk and head it
// does about 4 L N P multiply-adds against 2 L P + L values read and
// written, far above the card's bytes-per-operation line. Design: one
// block per (batch, head) loops over the chunks with the state in shared
// memory for the whole sequence; the four products (c b^T, scores xdt,
// q S, bw^T xdt) are register-tiled 64 x 64 tiles in which each of the
// 256 threads owns 4 x 4 outputs and reads 8 shared values per 16
// multiply-adds. c b^T is recomputed by every head of a batch row (a
// later PR could share it across heads).
#include "recurrence.cuh"

namespace {

using namespace recurrence;

constexpr int L = 64;          // chunk
constexpr int N = 64;          // state size
constexpr int P = 64;          // head dim
constexpr int LD = N + 1;      // padded row stride of the [L, N] tiles
constexpr int kThreads = 256;

struct Smem {
  float x[L * P];              // xdt
  float b[L * LD];             // b, then b * exp(cum[L-1] - cum)
  float c[L * LD];             // c, then q = c * exp(cum)
  float S[N * P];              // the state, float32
  float scores[L * LD];
  float cum[L];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ xdt, const float* __restrict__ la,
           const T* __restrict__ bm, const T* __restrict__ cm,
           const float* __restrict__ s0, T* __restrict__ y,
           float* __restrict__ s_out, int n_heads, int t_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long bh = blockIdx.x;
  const size_t xbase = (size_t)bh * t_len * P;
  const size_t lbase = (size_t)bh * t_len;
  const size_t bbase = (size_t)(bh / n_heads) * t_len * N;

  for (int i = tid; i < N * P; i += kThreads)
    sm.S[i] = s0 ? s0[bh * N * P + i] : 0.0f;

  for (int c0 = 0; c0 < t_len; c0 += L) {
    // load the chunk; past T: xdt = b = c = 0, la = 0
    for (int idx = tid; idx < L * P; idx += kThreads) {
      const int t = idx / P, j = idx % P;
      const bool in = c0 + t < t_len;
      sm.x[t * P + j] = in ? to_f32(xdt[xbase + (size_t)(c0 + t) * P + j])
                           : 0.0f;
      sm.b[t * LD + j] = in ? to_f32(bm[bbase + (size_t)(c0 + t) * N + j])
                            : 0.0f;
      sm.c[t * LD + j] = in ? to_f32(cm[bbase + (size_t)(c0 + t) * N + j])
                            : 0.0f;
    }
    if (tid < L) sm.cum[tid] = c0 + tid < t_len ? la[lbase + c0 + tid] : 0.0f;
    __syncthreads();

    if (tid == 0) {
      float run = 0.0f;
#pragma unroll
      for (int t = 0; t < L; ++t) {
        run += sm.cum[t];
        sm.cum[t] = run;
      }
    }
    __syncthreads();

    // scores = (c b^T) * exp(cum[t] - cum[s]) on s <= t, zero above
    {
      float cb[4][4];
      tile_zero(cb);
      tile_product<4>(cb, N, sm.c, LD, 1, sm.b, 1, LD, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          sm.scores[t * LD + s] =
              s <= t ? cb[i][j] * expf(sm.cum[t] - sm.cum[s]) : 0.0f;
        }
      }
    }
    __syncthreads();

    // q = c exp(cum); bw = b exp(cum[L-1] - cum)
    for (int idx = tid; idx < L * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      sm.c[t * LD + n] *= expf(sm.cum[t]);
      sm.b[t * LD + n] *= expf(sm.cum[L - 1] - sm.cum[t]);
    }
    __syncthreads();

    // y = scores xdt + q S
    {
      float sx[4][4], qs[4][4];
      tile_zero(sx);
      tile_zero(qs);
      tile_product<4>(sx, L, sm.scores, LD, 1, sm.x, P, 1, ty, tx);
      tile_product<4>(qs, N, sm.c, LD, 1, sm.S, P, 1, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + 16 * i;
        if (c0 + t >= t_len) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          y[xbase + (size_t)(c0 + t) * P + p] = from_f32<T>(sx[i][j] +
                                                             qs[i][j]);
        }
      }
    }
    __syncthreads();

    // S = exp(cum[L-1]) S + bw^T xdt
    {
      float bx[4][4];
      tile_zero(bx);
      tile_product<4>(bx, L, sm.b, 1, LD, sm.x, P, 1, ty, tx);
      const float decay = expf(sm.cum[L - 1]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          sm.S[n * P + p] = decay * sm.S[n * P + p] + bx[i][j];
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < N * P; i += kThreads) s_out[bh * N * P + i] = sm.S[i];
}

template <typename T>
int launch(const void* xdt, const void* la, const void* b, const void* c,
           const void* s0, void* y, void* s_out, int bsz, int h, int t,
           cudaStream_t stream) {
  const int smem = (int)sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ssd_kernel<T><<<(unsigned)(bsz * h), kThreads, smem, stream>>>(
      (const T*)xdt, (const float*)la, (const T*)b, (const T*)c,
      (const float*)s0, (T*)y, (float*)s_out, h, t);
  return (int)cudaGetLastError();
}

}  // namespace

// xdt [B, H, T, P] and b/c [B, T, N] contiguous, all of one type; la
// [B, H, T] f32; s0 [B, H, N, P] f32 or null (zeros); writes y [B, H, T, P]
// in that type and the final state s_out [B, H, N, P] f32.
extern "C" int mapsdi_mamba2_ssd(const void* xdt, const void* la,
                                 const void* b, const void* c, const void* s0,
                                 void* y, void* s_out, int bsz, int h, int t,
                                 int p, int n, int chunk, int dtype,
                                 int device, void* stream) {
  cudaSetDevice(device);
  if (p != P || n != N || chunk != L || bsz * h <= 0 || t < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == recurrence::kBFloat16)
    return launch<__nv_bfloat16>(xdt, la, b, c, s0, y, s_out, bsz, h, t, st);
  if (dtype == recurrence::kFloat32)
    return launch<float>(xdt, la, b, c, s0, y, s_out, bsz, h, t, st);
  return (int)cudaErrorInvalidValue;
}
