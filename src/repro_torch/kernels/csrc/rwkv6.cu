// RWKV6 (Finch) time-mix recurrence, chunked, for one card.
//
// Replaces the TPU kernel rwkv6_pallas (src/repro/kernels/rwkv6/rwkv6.py),
// whose grid ran (B*H, T/L) with the chunk axis sequential and the [N, N]
// state in VMEM scratch between grid steps.
//
// Per (batch, head), over chunks of L = 32 tokens (head size N = 64):
//   lw = log(max(w, 1e-30)); cum = inclusive cumsum of lw over the chunk;
//   cum_excl = cum - lw
//   scores[t, s] = sum_n exp(cum_excl[t, n] - cum[s, n]) r[t, n] k[s, n]
//                  for s < t (exact log-space decay: the exponent is <= 0)
//   y = scores v + (sum_n r u k) v + (r exp(cum_excl)) S
//   S = diag(exp(cum[L-1])) S + (k exp(cum[L-1] - cum))^T v
// all in float32, with y written in the input type. Tokens at and past T
// read as r = k = v = 0, w = 1 (padding that changes neither the first T
// outputs nor the final state), so any T is taken.
//
// What bounds it on the card: operations, not bytes. Per chunk it does
// L(L-1)/2 * N exponentials for the scores (the SFU's rate) and about
// 4 L N^2 multiply-adds for the two state products, against 4 L N inputs
// read once. Design: blocks run in parallel and in no order, so the
// sequential grid axis becomes a loop over chunks inside one block per
// (batch, head), with the state in shared memory for the whole sequence
// (it never goes to device memory until the end). 256 threads; the two
// state products are register-tiled (each thread owns a 2x4 or 4x4 tile,
// reading 6 or 8 shared values per 8 or 16 multiply-adds); the scores
// loop gives each warp one row t and its 32 lanes the 32 columns s, with
// rows padded to N + 1 floats so those reads hit 32 banks.
#include "recurrence.cuh"

namespace {

using namespace recurrence;

constexpr int L = 32;          // chunk
constexpr int N = 64;          // head size
constexpr int LD = N + 1;      // padded row stride of the [L, N] tiles
constexpr int kThreads = 256;

struct Smem {
  float r[L * LD];             // r, then q = r * exp(cum_excl)
  float k[L * LD];             // k, then k * exp(cum[L-1] - cum)
  float v[L * N];
  float cum[L * LD];           // inclusive cumsum of log w
  float cex[L * LD];           // log w, then cum - log w
  float S[N * N];              // the state, float32
  float scores[L * (L + 1)];
  float u[N];
  float bonus[L];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
rwkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             T* __restrict__ y, float* __restrict__ s_out, int n_heads,
             int t_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long bh = blockIdx.x;
  const size_t base = (size_t)bh * t_len * N;

  for (int i = tid; i < N * N; i += kThreads)
    sm.S[i] = s0 ? s0[bh * N * N + i] : 0.0f;
  for (int i = tid; i < N; i += kThreads)
    sm.u[i] = u[(bh % n_heads) * N + i];

  for (int c0 = 0; c0 < t_len; c0 += L) {
    // load the chunk; past T: r = k = v = 0, w = 1
    for (int idx = tid; idx < L * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      float rv = 0.0f, kv = 0.0f, vv = 0.0f, wv = 1.0f;
      if (c0 + t < t_len) {
        const size_t o = base + (size_t)(c0 + t) * N + n;
        rv = to_f32(r[o]);
        kv = to_f32(k[o]);
        vv = to_f32(v[o]);
        wv = to_f32(w[o]);
      }
      sm.r[t * LD + n] = rv;
      sm.k[t * LD + n] = kv;
      sm.v[t * N + n] = vv;
      sm.cex[t * LD + n] = logf(fmaxf(wv, 1e-30f));
    }
    __syncthreads();

    // cumulative log-decay per column
    if (tid < N) {
      float run = 0.0f;
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const float lw = sm.cex[t * LD + tid];
        run += lw;
        sm.cum[t * LD + tid] = run;
        sm.cex[t * LD + tid] = run - lw;
      }
    }
    __syncthreads();

    // intra-chunk scores (strictly lower triangle) and the bonus term
    for (int p = tid; p < L * L; p += kThreads) {
      const int t = p / L, s = p % L;
      float acc = 0.0f;
      if (s < t) {
        const float* rt = sm.r + t * LD;
        const float* et = sm.cex + t * LD;
        const float* ks = sm.k + s * LD;
        const float* cs = sm.cum + s * LD;
        for (int n = 0; n < N; ++n)
          acc = fmaf(expf(et[n] - cs[n]) * rt[n], ks[n], acc);
      }
      sm.scores[t * (L + 1) + s] = acc;
    }
    if (tid < L) {
      float acc = 0.0f;
      for (int n = 0; n < N; ++n)
        acc = fmaf(sm.r[tid * LD + n] * sm.u[n], sm.k[tid * LD + n], acc);
      sm.bonus[tid] = acc;
    }
    __syncthreads();

    // bonus applied; q = r exp(cum_excl); k scaled to the chunk's end
    for (int idx = tid; idx < L * N; idx += kThreads) {
      const int t = idx / N, n = idx % N;
      sm.r[t * LD + n] *= expf(sm.cex[t * LD + n]);
      sm.k[t * LD + n] *= expf(sm.cum[(L - 1) * LD + n] - sm.cum[t * LD + n]);
    }
    __syncthreads();

    // y = scores v + bonus v + q S, rows t = ty + 16 i, columns tx + 16 j
    {
      float sv[2][4], qs[2][4];
      tile_zero(sv);
      tile_zero(qs);
      tile_product<2>(sv, L, sm.scores, L + 1, 1, sm.v, N, 1, ty, tx);
      tile_product<2>(qs, N, sm.r, LD, 1, sm.S, N, 1, ty, tx);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = ty + 16 * i;
        if (c0 + t >= t_len) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = tx + 16 * j;
          const float out =
              (sv[i][j] + sm.bonus[t] * sm.v[t * N + m]) + qs[i][j];
          y[base + (size_t)(c0 + t) * N + m] = from_f32<T>(out);
        }
      }
    }
    __syncthreads();

    // S = diag(exp(cum[L-1])) S + (k exp(cum[L-1] - cum))^T v
    {
      float kv[4][4];
      tile_zero(kv);
      tile_product<4>(kv, L, sm.k, 1, LD, sm.v, N, 1, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = ty + 16 * i;
        const float decay = expf(sm.cum[(L - 1) * LD + n]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = tx + 16 * j;
          sm.S[n * N + m] = decay * sm.S[n * N + m] + kv[i][j];
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < N * N; i += kThreads) s_out[bh * N * N + i] = sm.S[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, int b,
           int h, int t, cudaStream_t stream) {
  const int smem = (int)sizeof(Smem);
  cudaError_t e = cudaFuncSetAttribute(
      rwkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  rwkv6_kernel<T><<<(unsigned)(b * h), kThreads, smem, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const float*)u,
      (const float*)s0, (T*)y, (float*)s_out, h, t);
  return (int)cudaGetLastError();
}

}  // namespace

// r/k/v/w [B, H, T, N] contiguous, all of one type; u [H, N] f32; s0
// [B, H, N, N] f32 or null (zeros); writes y [B, H, T, N] in that type and
// the final state s_out [B, H, N, N] f32.
extern "C" int mapsdi_rwkv6(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            void* y, void* s_out, int b, int h, int t, int n,
                            int chunk, int dtype, int device, void* stream) {
  cudaSetDevice(device);
  if (n != N || chunk != L || b * h <= 0 || t < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == recurrence::kBFloat16)
    return launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, b, h, t, st);
  if (dtype == recurrence::kFloat32)
    return launch<float>(r, k, v, w, u, s0, y, s_out, b, h, t, st);
  return (int)cudaErrorInvalidValue;
}
