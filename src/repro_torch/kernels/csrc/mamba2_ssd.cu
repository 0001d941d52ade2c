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
// outputs nor the final state), so any T is taken. Every exponent is
// <= 0 (la <= 0), so nothing overflows.
//
// What bounds it on the card (B = 2, H = 80, T = 2048, bf16): the bytes.
// Its products come to about 16 GFLOP-equivalent on the bf16 tensor cores
// with the split passes below (~0.016 ms), its exponentials to 0.005 ms,
// its 89 MB read once and written once to 0.0265 ms.
//
// Design, bf16 (the models' route), three launches:
//  1. ssd_cb: c b^T per (batch row, chunk) on the tensor cores, once for
//     all the heads of the row, float32 into the workspace (only the 16x8
//     tiles on or below the diagonal).
//  2. ssd_transition: per (batch*head, segment of seg_chunks chunks)
//     except the last segment, the segment's transition
//     S_out = D S_in + M, run from a zero state: D = prod exp(cum[L-1])
//     over its chunks, M the state the segment alone leaves.
//  3. ssd_scan: per (batch*head, segment), the state entering the segment
//     (the initial state carried through the earlier transitions,
//     elementwise), then the segment's chunks in order; the last segment
//     writes the final state.
// seg_chunks is the wrapper's SEGMENT_CHUNKS (mamba2/kernel.py). Segments
// give B*H*ceil(chunks / seg_chunks) blocks (1280 at the path shape for
// 132 SMs, against the 160 of one block per (batch, head)); the
// float32 transitions of all but the last segment (18 MB there) and c b^T
// (1 MB) stay in the 50 MB L2.
// 256 threads (8 warps) a block, two blocks an SM; warp w owns rows
// 16 (w % 4) and columns 32 (w / 4) of y and of the state, and rows 8w of
// bw. Products on mma.sync: (c S) two passes (S split), scores xdt two
// (scores split), bw^T xdt two (bw split), c b^T one (bf16 x bf16 is
// exact); y = exp(cum) (c S) + scores xdt, so q = c exp(cum) is never
// formed. The next chunk's rows are copied with cp.async while the
// current one computes; every warp scans the 64 decays itself with warp
// shuffles, so a chunk needs two barriers. The float32 route (selfcheck
// cases only) keeps one block per (batch, head) and CUDA-core products.
#include "recurrence.cuh"

namespace {

using namespace recurrence;

constexpr int L = 64;          // chunk
constexpr int N = 64;          // state size
constexpr int P = 64;          // head dim
constexpr int LD = N + 1;      // padded row stride of the float32 tiles
constexpr int kF32Threads = 256;
constexpr int kThreads = 256;  // bf16 route: 8 warps
constexpr int kCbThreads = 128;   // c b^T: 4 warps, 16 rows each

// ---------------------------------------------------------------------------
// float32 route: one block per (batch, head), CUDA-core products
// ---------------------------------------------------------------------------

struct F32Smem {
  float x[L * P];              // xdt
  float b[L * LD];             // b, then b * exp(cum[L-1] - cum)
  float c[L * LD];             // c, then q = c * exp(cum)
  float S[N * P];              // the state, float32
  float scores[L * LD];
  float cum[L];
};

template <typename T>
__global__ void __launch_bounds__(kF32Threads)
ssd_f32_kernel(const T* __restrict__ xdt, const float* __restrict__ la,
               const T* __restrict__ bm, const T* __restrict__ cm,
               const float* __restrict__ s0, T* __restrict__ y,
               float* __restrict__ s_out, int n_heads, int t_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  F32Smem& sm = *reinterpret_cast<F32Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long bh = blockIdx.x;
  const size_t xbase = (size_t)bh * t_len * P;
  const size_t lbase = (size_t)bh * t_len;
  const size_t bbase = (size_t)(bh / n_heads) * t_len * N;

  for (int i = tid; i < N * P; i += kF32Threads)
    sm.S[i] = s0 ? s0[bh * N * P + i] : 0.0f;

  for (int c0 = 0; c0 < t_len; c0 += L) {
    // load the chunk; past T: xdt = b = c = 0, la = 0
    for (int idx = tid; idx < L * P; idx += kF32Threads) {
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
    for (int idx = tid; idx < L * N; idx += kF32Threads) {
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

  for (int i = tid; i < N * P; i += kF32Threads)
    s_out[bh * N * P + i] = sm.S[i];
}


// ---------------------------------------------------------------------------
// bf16 route
// ---------------------------------------------------------------------------

// one chunk's rows of b and xdt and its decays
struct StageBX {
  bf16 b[L * LDS];
  bf16 x[L * LDS];
  float la[L];
};

struct TransitionSmem {
  StageBX st[2];
  bf16 bw_hi[L * LDS], bw_lo[L * LDS];
};

struct ScanSmem {
  StageBX st[2];
  bf16 c[2][L * LDS];
  bf16 bw_hi[L * LDS], bw_lo[L * LDS];
  bf16 s_hi[N * LDS], s_lo[N * LDS];
};

__device__ __forceinline__ void load_bx(StageBX& st, const bf16* bm,
                                        const bf16* xdt, const float* la,
                                        int rows_left, int tid) {
  load_rows<L, kThreads>(st.b, bm, rows_left, tid);
  load_rows<L, kThreads>(st.x, xdt, rows_left, tid);
  if (tid < L) cp_async4(st.la + tid, la + (tid < rows_left ? tid : 0),
                         tid < rows_left);
}

// log2-scaled inclusive cumsum of the chunk's decays: lane l returns
// cum[2l] and cum[2l+1] (every warp scans for itself)
__device__ __forceinline__ void cum_scan(const float* la, int lane,
                                         float& cum_a, float& cum_b) {
  const float a = la[2 * lane] * kLog2e, b = la[2 * lane + 1] * kLog2e;
  float s = a + b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s += v;
  }
  float excl = __shfl_up_sync(kFull, s, 1);
  if (lane == 0) excl = 0.0f;
  cum_a = excl + a;
  cum_b = cum_a + b;
}

// cum[t] for any t, from the lanes' pairs
__device__ __forceinline__ float cum_at(float cum_a, float cum_b, int t) {
  const float a = __shfl_sync(kFull, cum_a, t >> 1);
  const float b = __shfl_sync(kFull, cum_b, t >> 1);
  return (t & 1) ? b : a;
}

// cum[L-1], taken at the chunk's last real token: the padding's la = 0
// leave it unchanged in exact arithmetic, but the scan's tree of sums need
// not reproduce it bit for bit, and exp(cum[L-1] - cum[s]) must be exactly
// 1 at that token, as the plain version's sequential sum gives it
__device__ __forceinline__ float chunk_end(float cum_a, float cum_b,
                                          int rows_left) {
  return cum_at(cum_a, cum_b, min(L, rows_left) - 1);
}

// bw = b exp(cum[L-1] - cum) for rows 8w .. 8w+7, split into bf16 hi/lo
__device__ __forceinline__ void make_bw(const StageBX& st, bf16* bw_hi,
                                        bf16* bw_lo, float cum_a,
                                        float cum_b, float cl, int w,
                                        int lane) {
  const int s = 8 * w + (lane >> 2), c0 = (lane & 3) * 16;
  const float f = ex2(cl - cum_at(cum_a, cum_b, s));
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    float v[8];
    unpack8(*reinterpret_cast<const uint4*>(st.b + s * LDS + c0 + 8 * q), v);
    uint4 hi, lo;
    split_bf16(v[0] * f, v[1] * f, hi.x, lo.x);
    split_bf16(v[2] * f, v[3] * f, hi.y, lo.y);
    split_bf16(v[4] * f, v[5] * f, hi.z, lo.z);
    split_bf16(v[6] * f, v[7] * f, hi.w, lo.w);
    *reinterpret_cast<uint4*>(bw_hi + s * LDS + c0 + 8 * q) = hi;
    *reinterpret_cast<uint4*>(bw_lo + s * LDS + c0 + 8 * q) = lo;
  }
}

// c b^T for one (batch row, chunk): warp w computes rows 16w .. 16w+15,
// column tiles 0 .. 2w+1 (those on or below the diagonal)
__global__ void __launch_bounds__(kCbThreads)
ssd_cb_kernel(const bf16* __restrict__ bm, const bf16* __restrict__ cm,
              float* __restrict__ cb, int t_len, int n_chunks) {
  __shared__ __align__(16) bf16 sc[L * LDS];
  __shared__ __align__(16) bf16 sb[L * LDS];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int ch = blockIdx.x, row = blockIdx.y;
  const int c0 = ch * L;
  const size_t base = ((size_t)row * t_len + c0) * N;
  load_rows<L, kCbThreads>(sc, cm + base, t_len - c0, tid);
  load_rows<L, kCbThreads>(sb, bm + base, t_len - c0, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t ca[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(ca[kk], sc + (16 * w + (lane & 15)) * LDS + 16 * kk
                        + (lane >> 4) * 8);
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    if (jp > w) break;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t bf[4];
      ldsm_x4(bf, sb + (16 * jp + b_row) * LDS + 16 * kk + b_col);
      mma(acc[2 * jp], ca[kk], bf[0], bf[1]);
      mma(acc[2 * jp + 1], ca[kk], bf[2], bf[3]);
    }
  }
  float* out = cb + ((size_t)row * n_chunks + ch) * L * L;
  const int t0 = 16 * w + (lane >> 2), s0 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j > 2 * w + 1) break;
    *reinterpret_cast<float2*>(out + t0 * L + 8 * j + s0) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(out + (t0 + 8) * L + 8 * j + s0) =
        make_float2(acc[j][2], acc[j][3]);
  }
}

// the transition of segment blockIdx.y (every segment but the last) of
// (batch, head) blockIdx.x, from a zero state
__global__ void __launch_bounds__(kThreads)
ssd_transition_kernel(const bf16* __restrict__ xdt,
                      const float* __restrict__ la,
                      const bf16* __restrict__ bm, float* __restrict__ m_out,
                      float* __restrict__ d_out, int n_heads, int t_len,
                      int n_seg, int seg_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TransitionSmem& sm = *reinterpret_cast<TransitionSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int bh = blockIdx.x, seg = blockIdx.y;
  const bf16* xb = xdt + (size_t)bh * t_len * P;
  const float* lb = la + (size_t)bh * t_len;
  const bf16* bb = bm + (size_t)(bh / n_heads) * t_len * N;
  const int ch0 = seg * seg_chunks;
  const int row0 = 16 * (w & 3), col0 = 32 * (w >> 2);

  float S[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[j][e] = 0.0f;
  float d = 1.0f;

  load_bx(sm.st[0], bb + (size_t)ch0 * L * N, xb + (size_t)ch0 * L * P,
          lb + ch0 * L, t_len - ch0 * L, tid);
  cp_async_commit();
  for (int i = 0; i < seg_chunks; ++i) {
    const int ch = ch0 + i, c0 = ch * L;
    const StageBX& st = sm.st[i & 1];
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < seg_chunks)
      load_bx(sm.st[(i + 1) & 1], bb + (size_t)(c0 + L) * N,
              xb + (size_t)(c0 + L) * P, lb + c0 + L, t_len - c0 - L, tid);
    cp_async_commit();
    float cum_a, cum_b;
    cum_scan(st.la, lane, cum_a, cum_b);
    const float cl = chunk_end(cum_a, cum_b, t_len - c0);
    make_bw(st, sm.bw_hi, sm.bw_lo, cum_a, cum_b, cl, w, lane);
    __syncthreads();
    const float dec = ex2(cl);
    state_update<L / 16>(S, dec, dec, sm.bw_hi, sm.bw_lo, st.x, row0, col0,
                         lane);
    d *= dec;
  }
  const size_t slot = (size_t)bh * (n_seg - 1) + seg;
  state_store(S, m_out + slot * N * P, row0, col0, lane);
  if (tid == 0) d_out[slot] = d;
}

// y for segment blockIdx.y of (batch, head) blockIdx.x; the last segment
// also writes the final state. Warp w takes rows 16 (w % 4) and columns
// 32 (w / 4) of y and of the state; the two warps of a row block both form
// its scores.
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const bf16* __restrict__ xdt, const float* __restrict__ la,
                const bf16* __restrict__ bm, const bf16* __restrict__ cm,
                const float* __restrict__ s0, const float* __restrict__ cbw,
                const float* __restrict__ m_in, const float* __restrict__ d_in,
                bf16* __restrict__ y, float* __restrict__ s_out, int n_heads,
                int t_len, int n_chunks, int n_seg, int seg_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScanSmem& sm = *reinterpret_cast<ScanSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int rw = w & 3, row0 = 16 * rw, col0 = 32 * (w >> 2);
  const int bh = blockIdx.x, seg = blockIdx.y, row = bh / n_heads;
  const bool last_seg = seg == n_seg - 1;
  const bf16* xb = xdt + (size_t)bh * t_len * P;
  const float* lb = la + (size_t)bh * t_len;
  const bf16* bb = bm + (size_t)row * t_len * N;
  const bf16* cc = cm + (size_t)row * t_len * N;
  bf16* yb = y + (size_t)bh * t_len * P;
  const int ch0 = seg * seg_chunks;
  const int ch1 = min(ch0 + seg_chunks, n_chunks);

  if (ch0 < ch1) {
    const int c0 = ch0 * L;
    load_bx(sm.st[0], bb + (size_t)c0 * N, xb + (size_t)c0 * P, lb + c0,
            t_len - c0, tid);
    load_rows<L, kThreads>(sm.c[0], cc + (size_t)c0 * N, t_len - c0, tid);
  }
  cp_async_commit();

  float S[4][4];
  state_entering<false>(S, s0 ? s0 + (size_t)bh * N * P : nullptr,
                        m_in + (size_t)bh * (n_seg - 1) * N * P,
                        d_in + (size_t)bh * (n_seg - 1), seg, row0, col0,
                        lane);
  store_state_split(S, sm.s_hi, sm.s_lo, row0, col0, lane);

  const int t0 = row0 + g, t1 = t0 + 8;
  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = col0 + (lane >> 4) * 8;
  for (int ch = ch0; ch < ch1; ++ch) {
    const int i = ch - ch0, c0 = ch * L;
    const StageBX& st = sm.st[i & 1];
    const bf16* sc = sm.c[i & 1];
    cp_async_wait_all();
    __syncthreads();
    if (ch + 1 < ch1) {
      const int c1 = c0 + L;
      load_bx(sm.st[(i + 1) & 1], bb + (size_t)c1 * N, xb + (size_t)c1 * P,
              lb + c1, t_len - c1, tid);
      load_rows<L, kThreads>(sm.c[(i + 1) & 1], cc + (size_t)c1 * N,
                             t_len - c1, tid);
    }
    cp_async_commit();

    // this warp's rows of c b^T (tiles on or below the diagonal)
    const float* cbp = cbw + ((size_t)row * n_chunks + ch) * L * L;
    float2 cbv[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j <= 2 * rw + 1) {
        cbv[j][0] = *reinterpret_cast<const float2*>(cbp + t0 * L + 8 * j
                                                     + c2);
        cbv[j][1] = *reinterpret_cast<const float2*>(cbp + t1 * L + 8 * j
                                                     + c2);
      }
    }
    float cum_a, cum_b;
    cum_scan(st.la, lane, cum_a, cum_b);
    const float cl = chunk_end(cum_a, cum_b, t_len - c0);
    const float ct0 = cum_at(cum_a, cum_b, t0);
    const float ct1 = cum_at(cum_a, cum_b, t1);

    // y = exp(cum[t]) (c S): S split, two passes
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ca[4];
      ldsm_x4(ca, sc + (row0 + (lane & 15)) * LDS + 16 * kk
                      + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t sh[4], sl[4];
        ldsm_x4_t(sh, sm.s_hi + (16 * kk + b_row) * LDS + 16 * jp + b_col);
        ldsm_x4_t(sl, sm.s_lo + (16 * kk + b_row) * LDS + 16 * jp + b_col);
        mma(acc[2 * jp], ca, sh[0], sh[1]);
        mma(acc[2 * jp], ca, sl[0], sl[1]);
        mma(acc[2 * jp + 1], ca, sh[2], sh[3]);
        mma(acc[2 * jp + 1], ca, sl[2], sl[3]);
      }
    }
    const float e0 = ex2(ct0), e1 = ex2(ct1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[j][0] *= e0;
      acc[j][1] *= e0;
      acc[j][2] *= e1;
      acc[j][3] *= e1;
    }

    // y += scores xdt: scores = (c b^T) exp(cum[t] - cum[s]) on s <= t,
    // split, two passes; key steps past the warp's rows are all zero
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > rw) break;
      uint32_t ah[4], al[4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = 2 * kk + hf, s = 8 * j + c2;
        const float cs_a = __shfl_sync(kFull, cum_a, 4 * j + (lane & 3));
        const float cs_b = __shfl_sync(kFull, cum_b, 4 * j + (lane & 3));
        const float v00 = s <= t0 ? cbv[j][0].x * ex2(ct0 - cs_a) : 0.0f;
        const float v01 = s + 1 <= t0 ? cbv[j][0].y * ex2(ct0 - cs_b) : 0.0f;
        const float v10 = s <= t1 ? cbv[j][1].x * ex2(ct1 - cs_a) : 0.0f;
        const float v11 = s + 1 <= t1 ? cbv[j][1].y * ex2(ct1 - cs_b) : 0.0f;
        split_bf16(v00, v01, ah[2 * hf], al[2 * hf]);
        split_bf16(v10, v11, ah[2 * hf + 1], al[2 * hf + 1]);
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t xb4[4];
        ldsm_x4_t(xb4, st.x + (16 * kk + b_row) * LDS + 16 * jp + b_col);
        mma(acc[2 * jp], ah, xb4[0], xb4[1]);
        mma(acc[2 * jp], al, xb4[0], xb4[1]);
        mma(acc[2 * jp + 1], ah, xb4[2], xb4[3]);
        mma(acc[2 * jp + 1], al, xb4[2], xb4[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = col0 + 8 * j + c2;
      if (c0 + t0 < t_len)
        *reinterpret_cast<uint32_t*>(yb + (size_t)(c0 + t0) * P + p) =
            pack_bf16(acc[j][0], acc[j][1]);
      if (c0 + t1 < t_len)
        *reinterpret_cast<uint32_t*>(yb + (size_t)(c0 + t1) * P + p) =
            pack_bf16(acc[j][2], acc[j][3]);
    }

    // S = exp(cum[L-1]) S + bw^T xdt (not needed after a segment's last
    // chunk, except for the final state)
    const bool update = ch + 1 < ch1 || last_seg;
    if (update) make_bw(st, sm.bw_hi, sm.bw_lo, cum_a, cum_b, cl, w, lane);
    __syncthreads();
    if (update) {
      const float dec = ex2(cl);
      state_update<L / 16>(S, dec, dec, sm.bw_hi, sm.bw_lo, st.x, row0,
                           col0, lane);
      if (ch + 1 < ch1)
        store_state_split(S, sm.s_hi, sm.s_lo, row0, col0, lane);
    }
  }
  if (last_seg)
    state_store(S, s_out + (size_t)bh * N * P, row0, col0, lane);
}

int n_segments(int t, int seg_chunks) {
  return t <= 0 ? 1 : ((t + L - 1) / L + seg_chunks - 1) / seg_chunks;
}

// workspace: c b^T [B][chunks][L][L], then the transitions M
// [B*H][segments-1][N][P] and D [B*H][segments-1], float32 (the wrapper
// allocates as many)
size_t workspace_floats(int bsz, int h, int t, int seg_chunks) {
  const size_t chunks = t <= 0 ? 0 : (size_t)((t + L - 1) / L);
  const size_t prev = (size_t)n_segments(t, seg_chunks) - 1;
  return (size_t)bsz * chunks * L * L + (size_t)bsz * h * prev * (N * P + 1);
}

int launch_bf16(const void* xdt, const void* la, const void* b,
                const void* c, const void* s0, void* y, void* s_out,
                void* work, int bsz, int h, int t, int seg_chunks,
                cudaStream_t stream) {
  const int chunks = t <= 0 ? 0 : (t + L - 1) / L;
  const int n_seg = n_segments(t, seg_chunks);
  float* cbw = static_cast<float*>(work);
  float* m = cbw + (size_t)bsz * chunks * L * L;
  float* d = m + (size_t)bsz * h * (n_seg - 1) * N * P;
  const bf16 *xb = (const bf16*)xdt, *bb = (const bf16*)b,
             *cc = (const bf16*)c;
  const float* lf = (const float*)la;
  if (chunks > 0) {
    ssd_cb_kernel<<<dim3(chunks, bsz), kCbThreads, 0, stream>>>(bb, cc, cbw,
                                                                t, chunks);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (n_seg > 1) {
    const int smem = (int)sizeof(TransitionSmem);
    cudaError_t e = cudaFuncSetAttribute(
        ssd_transition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    ssd_transition_kernel<<<dim3(bsz * h, n_seg - 1), kThreads, smem,
                            stream>>>(xb, lf, bb, m, d, h, t, n_seg,
                                      seg_chunks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int smem = (int)sizeof(ScanSmem);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ssd_scan_kernel<<<dim3(bsz * h, n_seg), kThreads, smem, stream>>>(
      xb, lf, bb, cc, (const float*)s0, cbw, m, d, (bf16*)y, (float*)s_out,
      h, t, chunks, n_seg, seg_chunks);
  return (int)cudaGetLastError();
}

int launch_f32(const void* xdt, const void* la, const void* b, const void* c,
               const void* s0, void* y, void* s_out, int bsz, int h, int t,
               cudaStream_t stream) {
  const int smem = (int)sizeof(F32Smem);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_f32_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  ssd_f32_kernel<float><<<(unsigned)(bsz * h), kF32Threads, smem, stream>>>(
      (const float*)xdt, (const float*)la, (const float*)b, (const float*)c,
      (const float*)s0, (float*)y, (float*)s_out, h, t);
  return (int)cudaGetLastError();
}

}  // namespace

// xdt [B, H, T, P] and b/c [B, T, N] contiguous, all of one type; la
// [B, H, T] f32; s0 [B, H, N, P] f32 or null (zeros); seg_chunks: chunks
// per segment of the bf16 route; work: work_bytes of device workspace, at
// least workspace_floats() floats on the bf16 route; writes y [B, H, T, P]
// in that type and the final state s_out [B, H, N, P] f32.
extern "C" int mapsdi_mamba2_ssd(const void* xdt, const void* la,
                                 const void* b, const void* c, const void* s0,
                                 void* y, void* s_out, void* work,
                                 long long work_bytes, int bsz, int h, int t,
                                 int p, int n, int chunk, int seg_chunks,
                                 int dtype, int device, void* stream) {
  cudaSetDevice(device);
  if (p != P || n != N || chunk != L || bsz * h <= 0 || t < 0 ||
      seg_chunks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == recurrence::kBFloat16) {
    const size_t need =
        workspace_floats(bsz, h, t, seg_chunks) * sizeof(float);
    if (need && (!work || (size_t)work_bytes < need))
      return (int)cudaErrorInvalidValue;
    return launch_bf16(xdt, la, b, c, s0, y, s_out, work, bsz, h, t,
                       seg_chunks, st);
  }
  if (dtype == recurrence::kFloat32)
    return launch_f32(xdt, la, b, c, s0, y, s_out, bsz, h, t, st);
  return (int)cudaErrorInvalidValue;
}
