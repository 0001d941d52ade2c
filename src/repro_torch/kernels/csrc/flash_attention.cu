// Flash attention (online-softmax block attention), forward, for one card.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention/flash_attention.py, body _fa_kernel),
// whose grid ran (B*H, Sq/BQ, Sk/BK) with the k axis sequential and the
// running max, denominator and accumulator in VMEM scratch between steps.
//
// For q [B, H, Sq, D] and k/v [B, KH, Sk, D] (H % KH == 0, q head i reads
// kv head i / (H / KH)), per q row at absolute position
// qp = row + kv_len - Sq and key position kp < kv_len:
//   s = (q . k) * scale, masked where kp >= kv_len, or causal and kp > qp,
//       or window > 0 and qp - kp >= window (masked scores read -1e30)
//   m_new = max(m, max s); p = masked ? 0 : exp(s - m_new)
//   alpha = exp(m - m_new); l = alpha l + sum p; acc = alpha acc + p v
//   o = acc / (l == 0 ? 1 : l)
// in float32, with o written in q's type: the TPU kernel's arithmetic, so
// a row that no key reaches gives 0.
//
// What bounds it on the card: operations. Per unmasked (q, k) pair it does
// 2 D multiply-adds and one exponential against 4 D values read and
// written per row; at the paths' lengths (Sk = 448 to 2048) that is far
// above the card's bytes-per-operation line, and the bound is the tensor
// cores' bf16 rate. This first design runs on the float32 lanes (no mma /
// wgmma yet): one block of 256 threads per (batch*head, 64-row q tile)
// loops over 64-row k/v tiles staged in shared memory as float32; the two
// products are register-tiled (each thread owns 4 rows x D/16 columns,
// reading q and k as float4 from rows padded to D + 4 floats, which keeps
// each quarter-warp on distinct banks); each warp runs the online softmax
// of 8 rows with shuffles. Tiles that the kv_len, causal or window masks
// cover entirely are skipped with the TPU kernel's predicate. Ragged
// Sq and Sk tails are masked in the kernel (no padding copies); GQA maps
// the q head to its kv head (k and v are never copied per q head).
#include "recurrence.cuh"

namespace {

using recurrence::from_f32;
using recurrence::to_f32;

constexpr int BQ = 64;           // q rows per block
constexpr int BK = 64;           // k rows per tile
constexpr int SLD = BK + 4;      // row stride of the score tile
constexpr int kThreads = 256;    // 16 x 16; 8 warps
constexpr float kMask = -1e30f;  // the reference's MASK_VALUE

template <int D>
struct Layout {
  static constexpr int LD = D + 4;   // row stride of the q and k tiles
  static constexpr int NJ = D / 16;  // output columns per thread
  static constexpr size_t q = 0;
  static constexpr size_t k = q + (size_t)BQ * LD;
  static constexpr size_t v = k + (size_t)BK * LD;
  static constexpr size_t s = v + (size_t)BK * D;
  static constexpr size_t m = s + (size_t)BQ * SLD;
  static constexpr size_t l = m + BQ;
  static constexpr size_t alpha = l + BQ;
  static constexpr size_t floats = alpha + BQ;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int rows_left, int D, int tid) {
  // rows at and past rows_left read as 0
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    dst[r * ld + c] = r < rows_left ? to_f32(src[idx]) : 0.0f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int h,
                       int kh, int sq, int sk, int kv_len, int causal,
                       int window, float scale) {
  using Lay = Layout<D>;
  constexpr int LD = Lay::LD;
  constexpr int NJ = Lay::NJ;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem + Lay::q;
  float* ks = smem + Lay::k;
  float* vs = smem + Lay::v;
  float* ss = smem + Lay::s;
  float* ms = smem + Lay::m;
  float* ls = smem + Lay::l;
  float* as = smem + Lay::alpha;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int kvh = (bh / h) * kh + (bh % h) / (h / kh);
  const T* qb = q + ((size_t)bh * sq + q0) * D;
  const T* kb = k + (size_t)kvh * sk * D;
  const T* vb = v + (size_t)kvh * sk * D;

  load_tile(qs, LD, qb, sq - q0, D, tid);
  if (tid < BQ) {
    ms[tid] = kMask;
    ls[tid] = 0.0f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  const int q_first = q0 + kv_len - sq;   // absolute position of row 0
  const int q_last = q_first + BQ - 1;
  const int n_tiles = (sk + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k_first = t * BK, k_last = k_first + BK - 1;
    // the TPU kernel's predicate: skip a tile every pair of which is masked
    bool live = k_first < kv_len;
    if (causal) live = live && k_first <= q_last;
    if (window > 0) live = live && k_last > q_first - window;
    if (!live) continue;                   // uniform over the block

    __syncthreads();                       // the last tile's readers are done
    load_tile(ks, LD, kb + (size_t)k_first * D, sk - k_first, D, tid);
    load_tile(vs, D, vb + (size_t)k_first * D, sk - k_first, D, tid);
    __syncthreads();

    // s = q k^T * scale: rows ty + 16 i, columns tx + 16 j
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ss[(ty + 16 * i) * SLD + tx + 16 * j] = s[i][j] * scale;
    }
    __syncthreads();

    // online softmax: warp w takes rows 8 w .. 8 w + 7, lanes the columns
    // lane and lane + 32
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      const int qp = q_first + r;
      float sv[2];
      bool keep[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const int kp = k_first + c;
        bool mk = kp < kv_len;
        if (causal) mk = mk && qp >= kp;
        if (window > 0) mk = mk && qp - kp < window;
        keep[half] = mk;
        sv[half] = mk ? ss[r * SLD + c] : kMask;
      }
      float mx = fmaxf(sv[0], sv[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = ms[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = keep[0] ? expf(sv[0] - m_new) : 0.0f;
      const float p1 = keep[1] ? expf(sv[1] - m_new) : 0.0f;
      ss[r * SLD + lane] = p0;
      ss[r * SLD + lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        ls[r] = alpha * ls[r] + sum;
        ms[r] = m_new;
        as[r] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha acc + p v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = as[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(ss + (ty + 16 * i) * SLD + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) vv[j] = vs[(c + cc) * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pi = cc == 0 ? p[i].x : cc == 1 ? p[i].y
                         : cc == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pi, vv[j], acc[i][j]);
        }
      }
    }
  }
  __syncthreads();   // ls is final (also when no tile was live)

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= sq) continue;
    float l = ls[r];
    l = l == 0.0f ? 1.0f : l;
    T* orow = o + ((size_t)bh * sq + q0 + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      orow[tx + 16 * j] = from_f32<T>(acc[i][j] / l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int kh, int sq, int sk, int kv_len, int causal, int window,
           float scale, cudaStream_t stream) {
  const int smem = (int)Layout<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)(b * h));
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, h, kh, sq, sk, kv_len,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int b,
               int h, int kh, int sq, int sk, int d, int kv_len, int causal,
               int window, float scale, cudaStream_t st) {
#define MAPSDI_FA_CASE(DD)                                                  \
  case DD:                                                                  \
    return launch<T, DD>(q, k, v, o, b, h, kh, sq, sk, kv_len, causal,      \
                         window, scale, st);
  switch (d) {
    MAPSDI_FA_CASE(16)
    MAPSDI_FA_CASE(32)
    MAPSDI_FA_CASE(64)
    MAPSDI_FA_CASE(80)
    MAPSDI_FA_CASE(112)
    MAPSDI_FA_CASE(128)
    MAPSDI_FA_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MAPSDI_FA_CASE
}

}  // namespace

// q [B, H, Sq, D], k/v [B, KH, Sk, D] contiguous, all of one type; writes
// o [B, H, Sq, D] in that type. 0 <= kv_len <= Sk; window 0 means none;
// D one of 16, 32, 64, 80, 112, 128, 256.
extern "C" int mapsdi_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, int b, int h,
                                      int kh, int sq, int sk, int d,
                                      int kv_len, int causal, int window,
                                      float scale, int dtype, int device,
                                      void* stream) {
  cudaSetDevice(device);
  if (b <= 0 || h <= 0 || kh <= 0 || h % kh || sq <= 0 || sk < 0 ||
      kv_len < 0 || kv_len > sk || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == recurrence::kBFloat16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, b, h, kh, sq, sk, d, kv_len,
                                     causal, window, scale, st);
  if (dtype == recurrence::kFloat32)
    return dispatch_d<float>(q, k, v, o, b, h, kh, sq, sk, d, kv_len, causal,
                             window, scale, st);
  return (int)cudaErrorInvalidValue;
}
