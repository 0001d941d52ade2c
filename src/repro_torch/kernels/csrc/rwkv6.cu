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
// What bounds it on the card (B = 2, H = 64, T = 2048, bf16): the
// exponentials. The scores take one per (t, s < t, n), L(L-1)/2 N per
// chunk and head (294 M in all, 0.070 ms on the special-function units);
// they cannot be one matrix product, and factoring them through a shared
// point could overflow. The products (q S, scores v, kw^T v) come to about
// 12 GFLOP-equivalent on the bf16 tensor cores with the split passes
// below, the bytes to 0.051 ms.
//
// Design, bf16 (the models' route), two launches:
//  1. rwkv6_transition: per (batch*head, segment of seg_chunks chunks)
//     except the last segment, the segment's transition
//     S_out = diag(D) S_in + M run from a zero state: D = prod
//     exp(cum[L-1]) per state row, M the state the segment alone leaves.
//  2. rwkv6_scan: per (batch*head, segment), the state entering the
//     segment (the initial state carried through the earlier transitions,
//     elementwise), then the segment's chunks in order; the last segment
//     writes the final state.
// seg_chunks is the wrapper's SEGMENT_CHUNKS (rwkv6/kernel.py). Segments
// of 512 tokens give B*H*ceil(chunks / seg_chunks) blocks (512 at the
// path shape: two waves of two blocks an SM, against the 128 blocks of
// one per (batch, head)); the float32 transitions of all but the last
// segment take 6.4 MB there, in the 50 MB L2. Each scan block carries the
// initial state through every earlier segment's transition, so that
// traffic grows with the square of the segment count: 256-token segments
// (1024 blocks) took longer.
// 256 threads (8 warps) a block, two blocks an SM. Per chunk: every
// thread takes logs of w and copies r and k to float32; threads 0-63 sum
// the logs column by column, in the plain version's order (see
// chunk_cumsum: on long runs of zero decay the exponents must carry the
// same bits); every thread then forms q and kw. The scores'
// exponentials run on the CUDA cores as ex2.approx: warps 0-6 take the 28
// 4x4 tiles below the diagonal (eight lanes a tile, an eighth of n each),
// warp 7 the 8 diagonal tiles' 6 pairs and the bonus (r u k) on the
// diagonal, so no warp runs two paths and each issues 96-128
// exponentials a lane. q S (three passes: q and S split), scores v and
// kw^T v (two passes: scores, kw split) run on mma.sync, warp w taking
// rows 16 (w / 4) and columns 16 (w % 4) of y, rows 16 (w % 4) and
// columns 32 (w / 4) of the state. The next chunk's rows are copied with
// cp.async while the current one computes; five barriers a chunk. The
// float32 route (selfcheck cases only) keeps one block per (batch, head)
// and CUDA-core products.
#include "recurrence.cuh"

namespace {

using namespace recurrence;

constexpr int L = 32;          // chunk
constexpr int N = 64;          // head size
constexpr int LD = N + 1;      // padded row stride of the float32 tiles
constexpr int kF32Threads = 256;
constexpr int kWarps = 8;      // bf16 route
constexpr int kThreads = 32 * kWarps;
constexpr int LDC = 40;        // bf16 row stride of the [L, L] scores
// float32 row stride of the bf16 route's [L, N] tiles: rows 4 apart fall
// 8 banks apart, so the scores' loads of neighbouring tiles do not collide
constexpr int LDF = 66;

// ---------------------------------------------------------------------------
// float32 route: one block per (batch, head), CUDA-core products
// ---------------------------------------------------------------------------

struct F32Smem {
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
__global__ void __launch_bounds__(kF32Threads)
rwkv6_f32_kernel(const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 T* __restrict__ y, float* __restrict__ s_out, int n_heads,
                 int t_len) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  F32Smem& sm = *reinterpret_cast<F32Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long long bh = blockIdx.x;
  const size_t base = (size_t)bh * t_len * N;

  for (int i = tid; i < N * N; i += kF32Threads)
    sm.S[i] = s0 ? s0[bh * N * N + i] : 0.0f;
  for (int i = tid; i < N; i += kF32Threads)
    sm.u[i] = u[(bh % n_heads) * N + i];

  for (int c0 = 0; c0 < t_len; c0 += L) {
    // load the chunk; past T: r = k = v = 0, w = 1
    for (int idx = tid; idx < L * N; idx += kF32Threads) {
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
    for (int p = tid; p < L * L; p += kF32Threads) {
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
    for (int idx = tid; idx < L * N; idx += kF32Threads) {
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

  for (int i = tid; i < N * N; i += kF32Threads)
    s_out[bh * N * N + i] = sm.S[i];
}


// ---------------------------------------------------------------------------
// bf16 route
// ---------------------------------------------------------------------------

// one chunk's rows of k, v and w
struct StageKVW {
  bf16 k[L * LDS];
  bf16 v[L * LDS];
  bf16 w[L * LDS];
};

struct TransitionSmem {
  StageKVW st[2];
  bf16 kw_hi[L * LDS], kw_lo[L * LDS];
  float cex[L * LDF], cum[L * LDF];    // [t][n], natural log
  float cl[N];                 // cum[L-1]
};

struct ScanSmem {
  StageKVW st[2];
  bf16 r[2][L * LDS];
  bf16 q_hi[L * LDS], q_lo[L * LDS];
  bf16 kw_hi[L * LDS], kw_lo[L * LDS];
  bf16 s_hi[N * LDS], s_lo[N * LDS];
  bf16 sc_hi[L * LDC], sc_lo[L * LDC];
  float cex[L * LDF], cum[L * LDF];    // [t][n], natural log
  float rf[L * LDF], kf[L * LDF];
  float cl[N];
  float u[N];
};

__device__ __forceinline__ void load_kvw(StageKVW& st, const bf16* k,
                                         const bf16* v, const bf16* w,
                                         int rows_left, int tid) {
  load_rows<L, kThreads>(st.k, k, rows_left, tid);
  load_rows<L, kThreads>(st.v, v, rows_left, tid);
  load_rows<L, kThreads>(st.w, w, rows_left, tid);
}

__device__ __forceinline__ void store8_split(const float (&f)[8], bf16* hi,
                                             bf16* lo) {
  uint4 h, l;
  split_bf16(f[0], f[1], h.x, l.x);
  split_bf16(f[2], f[3], h.y, l.y);
  split_bf16(f[4], f[5], h.z, l.z);
  split_bf16(f[6], f[7], h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

// lw = logf(max(w, 1e-30)) of the chunk (0 past T), by every thread (row
// tid / 8, columns 8 (tid % 8) ..), into lw_s [t][n]; with kScan also r
// and k as float32 [t][n] for the scores
template <bool kScan>
__device__ __forceinline__ void chunk_logs(const StageKVW& st, const bf16* sr,
                                           int rows_left, float* lw_s,
                                           float* rf_s, float* kf_s,
                                           int tid) {
  const int t = tid >> 3, n0 = (tid & 7) * 8;
  float wv[8];
  unpack8(*reinterpret_cast<const uint4*>(st.w + t * LDS + n0), wv);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    lw_s[t * LDF + n0 + j] = t < rows_left ? logf(fmaxf(wv[j], 1e-30f))
                                           : 0.0f;
  if constexpr (kScan) {
    float rv[8], kv[8];
    unpack8(*reinterpret_cast<const uint4*>(sr + t * LDS + n0), rv);
    unpack8(*reinterpret_cast<const uint4*>(st.k + t * LDS + n0), kv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      rf_s[t * LDF + n0 + j] = rv[j];
      kf_s[t * LDF + n0 + j] = kv[j];
    }
  }
}

// The chunk's cumulative log decays, summed as the plain version sums
// them: thread n < N takes column n token after token, cum = running sum
// of lw, cum_excl = cum - lw (written over lw), and cum[L-1] (the padding
// adds exact zeros). On long runs of zero decay |cum| reaches ~1300, where
// float32 resolves the exponents cum_excl[t] - cum[s] only to ~1e-4 of
// their size: a warp scan's tree of sums, or sums of log2-scaled values,
// round differently there, and that difference showed in y (selfcheck's
// 35-zero case). The exponents are therefore formed in these exact bits
// and scaled by log2(e) only inside the exponential.
__device__ __forceinline__ void chunk_cumsum(float* cex_s, float* cum_s,
                                             float* cl_s, int n) {
  float run = 0.0f;
#pragma unroll 8
  for (int t = 0; t < L; ++t) {
    const float lw = cex_s[t * LDF + n];
    run += lw;
    cum_s[t * LDF + n] = run;
    cex_s[t * LDF + n] = run - lw;
  }
  cl_s[n] = run;
}

// kw = k exp(cum[L-1] - cum) and, with kScan, q = r exp(cum_excl), split
// into bf16 hi/lo: thread tid takes row tid / 8, columns 8 (tid % 8) ..
template <bool kScan>
__device__ __forceinline__ void chunk_decays(
    const StageKVW& st, const bf16* sr, const float* cum_s,
    const float* cex_s, const float* cl_s, bf16* kw_hi, bf16* kw_lo,
    bf16* q_hi, bf16* q_lo, int tid) {
  const int t = tid >> 3, n0 = (tid & 7) * 8;
  float kf[8], kw[8];
  unpack8(*reinterpret_cast<const uint4*>(st.k + t * LDS + n0), kf);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    kw[j] = kf[j] * ex2((cl_s[n0 + j] - cum_s[t * LDF + n0 + j]) * kLog2e);
  store8_split(kw, kw_hi + t * LDS + n0, kw_lo + t * LDS + n0);
  if constexpr (kScan) {
    float rf[8], q[8];
    unpack8(*reinterpret_cast<const uint4*>(sr + t * LDS + n0), rf);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      q[j] = rf[j] * ex2(cex_s[t * LDF + n0 + j] * kLog2e);
    store8_split(q, q_hi + t * LDS + n0, q_lo + t * LDS + n0);
  }
}

// The intra-chunk scores into sc_hi / sc_lo ([t][s], split bf16): below the
// diagonal sum_n exp(cum_excl[t, n] - cum[s, n]) r[t, n] k[s, n], on it the
// bonus sum_n r u k; above it the zeros written at the kernel's start.
// Warps 0-6: the 28 off-diagonal 4x4 tiles (row block I > column block
// J), four to a warp, eight lanes a tile with an eighth of n each
// (n = 8i + lane % 8), summed over the eight with shuffles: 128
// exponentials a lane. Warp 7: the 8 diagonal tiles' 6 pairs s < t and
// their 4 bonus terms, four lanes a tile with a quarter of n each: 96
// exponentials a lane. No warp runs two paths.
__device__ __forceinline__ void chunk_scores(ScanSmem& sm, int tid) {
  float v[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] = 0.0f;
  const bool diag = tid >= 7 * 32;
  int t0, s0;
  if (!diag) {
    const int task = tid >> 3, e8 = tid & 7;
    int I = 1, base = 0;
    while (task >= base + I) {
      base += I;
      ++I;
    }
    t0 = 4 * I;
    s0 = 4 * (task - base);
#pragma unroll 2
    for (int i = 0; i < 8; ++i) {
      const int n = 8 * i + e8;
      float ca[4], ra[4], cb[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ca[a] = sm.cex[(t0 + a) * LDF + n];
        ra[a] = sm.rf[(t0 + a) * LDF + n];
        cb[a] = sm.cum[(s0 + a) * LDF + n];
        kb[a] = sm.kf[(s0 + a) * LDF + n];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          v[4 * a + b] = fmaf(ex2((ca[a] - cb[b]) * kLog2e) * ra[a], kb[b],
                              v[4 * a + b]);
    }
  } else {
    const int d = tid - 7 * 32, h = d & 3;
    t0 = s0 = 4 * (d >> 2);
#pragma unroll 2
    for (int i = 0; i < 16; ++i) {
      const int n = 4 * i + h;
      const float un = sm.u[n];
      float ca[4], ra[4], cb[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        ca[a] = sm.cex[(t0 + a) * LDF + n];
        ra[a] = sm.rf[(t0 + a) * LDF + n];
        cb[a] = sm.cum[(s0 + a) * LDF + n];
        kb[a] = sm.kf[(s0 + a) * LDF + n];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < a; ++b)
          v[4 * a + b] = fmaf(ex2((ca[a] - cb[b]) * kLog2e) * ra[a], kb[b],
                              v[4 * a + b]);
        v[5 * a] = fmaf(ra[a] * un, kb[a], v[5 * a]);     // the bonus
      }
    }
  }
  // sum over the lanes that share a tile: 4 (diagonal) or 8
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    if (diag && o == 4) break;
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] += __shfl_xor_sync(kFull, v[e], o);
  }
  const int part = tid & (diag ? 3 : 7);
  if (!diag && part >= 4) return;
  if (diag && part != 0) return;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if (!diag && a != part) continue;          // one row a lane
    uint2 hi, lo;
    split_bf16(v[4 * a], v[4 * a + 1], hi.x, lo.x);
    split_bf16(v[4 * a + 2], v[4 * a + 3], hi.y, lo.y);
    *reinterpret_cast<uint2*>(sm.sc_hi + (t0 + a) * LDC + s0) = hi;
    *reinterpret_cast<uint2*>(sm.sc_lo + (t0 + a) * LDC + s0) = lo;
  }
}

// the transition of segment blockIdx.y (every segment but the last) of
// (batch, head) blockIdx.x, from a zero state
__global__ void __launch_bounds__(kThreads)
rwkv6_transition_kernel(const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ w, float* __restrict__ m_out,
                        float* __restrict__ d_out, int t_len, int n_seg,
                        int seg_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TransitionSmem& sm = *reinterpret_cast<TransitionSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int bh = blockIdx.x, seg = blockIdx.y;
  const size_t base = (size_t)bh * t_len * N;
  const int ch0 = seg * seg_chunks;
  const int row0 = 16 * (wp & 3), col0 = 32 * (wp >> 2);

  float S[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[j][e] = 0.0f;
  float d0 = 1.0f, d1 = 1.0f;
  const int n0 = row0 + (lane >> 2);

  {
    const size_t o = base + (size_t)ch0 * L * N;
    load_kvw(sm.st[0], k + o, v + o, w + o, t_len - ch0 * L, tid);
  }
  cp_async_commit();
  for (int i = 0; i < seg_chunks; ++i) {
    const int c0 = (ch0 + i) * L;
    const StageKVW& st = sm.st[i & 1];
    cp_async_wait_all();
    __syncthreads();
    if (i + 1 < seg_chunks) {
      const size_t o = base + (size_t)(c0 + L) * N;
      load_kvw(sm.st[(i + 1) & 1], k + o, v + o, w + o, t_len - c0 - L, tid);
    }
    cp_async_commit();
    chunk_logs<false>(st, nullptr, t_len - c0, sm.cex, nullptr, nullptr,
                      tid);
    __syncthreads();
    if (tid < N) chunk_cumsum(sm.cex, sm.cum, sm.cl, tid);
    __syncthreads();
    chunk_decays<false>(st, nullptr, sm.cum, sm.cex, sm.cl, sm.kw_hi,
                        sm.kw_lo, nullptr, nullptr, tid);
    __syncthreads();
    const float e0 = ex2(sm.cl[n0] * kLog2e);
    const float e1 = ex2(sm.cl[n0 + 8] * kLog2e);
    state_update<L / 16>(S, e0, e1, sm.kw_hi, sm.kw_lo, st.v, row0, col0,
                         lane);
    d0 *= e0;
    d1 *= e1;
  }
  const size_t slot = (size_t)bh * (n_seg - 1) + seg;
  state_store(S, m_out + slot * N * N, row0, col0, lane);
  if (col0 == 0 && (lane & 3) == 0) {
    d_out[slot * N + n0] = d0;
    d_out[slot * N + n0 + 8] = d1;
  }
}

// y for segment blockIdx.y of (batch, head) blockIdx.x; the last segment
// also writes the final state
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_scan_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  const float* __restrict__ m_in,
                  const float* __restrict__ d_in, bf16* __restrict__ y,
                  float* __restrict__ s_out, int n_heads, int t_len,
                  int n_chunks, int n_seg, int seg_chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScanSmem& sm = *reinterpret_cast<ScanSmem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int wr = wp >> 2, wc = wp & 3;       // y: rows 16 wr, cols 16 wc
  const int row0 = 16 * (wp & 3), col0 = 32 * (wp >> 2);   // the state
  const int bh = blockIdx.x, seg = blockIdx.y;
  const bool last_seg = seg == n_seg - 1;
  const size_t base = (size_t)bh * t_len * N;
  const int ch0 = seg * seg_chunks;
  const int ch1 = min(ch0 + seg_chunks, n_chunks);

  if (ch0 < ch1) {
    const size_t o = base + (size_t)ch0 * L * N;
    load_kvw(sm.st[0], k + o, v + o, w + o, t_len - ch0 * L, tid);
    load_rows<L, kThreads>(sm.r[0], r + o, t_len - ch0 * L, tid);
  }
  cp_async_commit();
  if (tid < N) sm.u[tid] = u[(bh % n_heads) * N + tid];
  for (int i = tid; i < L * LDC; i += kThreads) {
    sm.sc_hi[i] = __float2bfloat16_rn(0.0f);
    sm.sc_lo[i] = __float2bfloat16_rn(0.0f);
  }

  float S[4][4];
  state_entering<true>(S, s0 ? s0 + (size_t)bh * N * N : nullptr,
                       m_in + (size_t)bh * (n_seg - 1) * N * N,
                       d_in + (size_t)bh * (n_seg - 1) * N, seg, row0, col0,
                       lane);
  store_state_split(S, sm.s_hi, sm.s_lo, row0, col0, lane);

  const int b_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int b_col = 16 * wc + (lane >> 4) * 8;
  const int a_row = 16 * wr + (lane & 15), a_col = (lane >> 4) * 8;
  for (int ch = ch0; ch < ch1; ++ch) {
    const int i = ch - ch0, c0 = ch * L;
    const StageKVW& st = sm.st[i & 1];
    cp_async_wait_all();
    __syncthreads();
    if (ch + 1 < ch1) {
      const size_t o = base + (size_t)(c0 + L) * N;
      load_kvw(sm.st[(i + 1) & 1], k + o, v + o, w + o, t_len - c0 - L, tid);
      load_rows<L, kThreads>(sm.r[(i + 1) & 1], r + o, t_len - c0 - L, tid);
    }
    cp_async_commit();
    chunk_logs<true>(st, sm.r[i & 1], t_len - c0, sm.cex, sm.rf, sm.kf,
                     tid);
    __syncthreads();
    if (tid < N) chunk_cumsum(sm.cex, sm.cum, sm.cl, tid);
    __syncthreads();
    chunk_decays<true>(st, sm.r[i & 1], sm.cum, sm.cex, sm.cl, sm.kw_hi,
                       sm.kw_lo, sm.q_hi, sm.q_lo, tid);
    __syncthreads();

    chunk_scores(sm, tid);
    // y = q S: q and S split, three passes
    float acc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t qh[4], ql[4], sh[4], sl[4];
      ldsm_x4(qh, sm.q_hi + a_row * LDS + 16 * kk + a_col);
      ldsm_x4(ql, sm.q_lo + a_row * LDS + 16 * kk + a_col);
      ldsm_x4_t(sh, sm.s_hi + (16 * kk + b_row) * LDS + b_col);
      ldsm_x4_t(sl, sm.s_lo + (16 * kk + b_row) * LDS + b_col);
      mma(acc[0], qh, sh[0], sh[1]);
      mma(acc[0], qh, sl[0], sl[1]);
      mma(acc[0], ql, sh[0], sh[1]);
      mma(acc[1], qh, sh[2], sh[3]);
      mma(acc[1], qh, sl[2], sl[3]);
      mma(acc[1], ql, sh[2], sh[3]);
    }
    __syncthreads();

    // y += scores v: scores split, two passes; key steps past the warp's
    // rows are all zero
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      if (kk > wr) break;
      uint32_t ah[4], al[4], vb[4];
      ldsm_x4(ah, sm.sc_hi + a_row * LDC + 16 * kk + a_col);
      ldsm_x4(al, sm.sc_lo + a_row * LDC + 16 * kk + a_col);
      ldsm_x4_t(vb, st.v + (16 * kk + b_row) * LDS + b_col);
      mma(acc[0], ah, vb[0], vb[1]);
      mma(acc[0], al, vb[0], vb[1]);
      mma(acc[1], ah, vb[2], vb[3]);
      mma(acc[1], al, vb[2], vb[3]);
    }
    const int t0 = 16 * wr + g, t1 = t0 + 8;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 16 * wc + 8 * j + c2;
      if (c0 + t0 < t_len)
        *reinterpret_cast<uint32_t*>(y + base + (size_t)(c0 + t0) * N + col)
            = pack_bf16(acc[j][0], acc[j][1]);
      if (c0 + t1 < t_len)
        *reinterpret_cast<uint32_t*>(y + base + (size_t)(c0 + t1) * N + col)
            = pack_bf16(acc[j][2], acc[j][3]);
    }

    // S = diag(exp(cum[L-1])) S + kw^T v (not needed after a segment's
    // last chunk, except for the final state)
    if (ch + 1 < ch1 || last_seg) {
      const int n0 = row0 + g;
      state_update<L / 16>(S, ex2(sm.cl[n0] * kLog2e),
                           ex2(sm.cl[n0 + 8] * kLog2e), sm.kw_hi,
                           sm.kw_lo, st.v, row0, col0, lane);
      if (ch + 1 < ch1)
        store_state_split(S, sm.s_hi, sm.s_lo, row0, col0, lane);
    }
  }
  if (last_seg) state_store(S, s_out + (size_t)bh * N * N, row0, col0, lane);
}

int n_segments(int t, int seg_chunks) {
  return t <= 0 ? 1 : ((t + L - 1) / L + seg_chunks - 1) / seg_chunks;
}

// workspace: the transitions M [B*H][segments-1][N][N] and D
// [B*H][segments-1][N], float32 (the wrapper allocates as many)
size_t workspace_floats(int b, int h, int t, int seg_chunks) {
  return (size_t)b * h * (n_segments(t, seg_chunks) - 1) * (N * N + N);
}

int launch_bf16(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* y, void* s_out,
                void* work, int b, int h, int t, int seg_chunks,
                cudaStream_t stream) {
  const int chunks = t <= 0 ? 0 : (t + L - 1) / L;
  const int n_seg = n_segments(t, seg_chunks);
  float* m = static_cast<float*>(work);
  float* d = m + (size_t)b * h * (n_seg - 1) * N * N;
  const bf16 *rb = (const bf16*)r, *kb = (const bf16*)k,
             *vb = (const bf16*)v, *wb = (const bf16*)w;
  if (n_seg > 1) {
    const int smem = (int)sizeof(TransitionSmem);
    cudaError_t e = cudaFuncSetAttribute(
        rwkv6_transition_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    rwkv6_transition_kernel<<<dim3(b * h, n_seg - 1), kThreads, smem,
                              stream>>>(kb, vb, wb, m, d, t, n_seg,
                                        seg_chunks);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int smem = (int)sizeof(ScanSmem);
  cudaError_t e = cudaFuncSetAttribute(
      rwkv6_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  rwkv6_scan_kernel<<<dim3(b * h, n_seg), kThreads, smem, stream>>>(
      rb, kb, vb, wb, (const float*)u, (const float*)s0, m, d, (bf16*)y,
      (float*)s_out, h, t, chunks, n_seg, seg_chunks);
  return (int)cudaGetLastError();
}

int launch_f32(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* s0, void* y, void* s_out, int b,
               int h, int t, cudaStream_t stream) {
  const int smem = (int)sizeof(F32Smem);
  cudaError_t e = cudaFuncSetAttribute(
      rwkv6_f32_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  rwkv6_f32_kernel<float><<<(unsigned)(b * h), kF32Threads, smem, stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (const float*)s0, (float*)y, (float*)s_out, h, t);
  return (int)cudaGetLastError();
}

}  // namespace

// r/k/v/w [B, H, T, N] contiguous, all of one type; u [H, N] f32; s0
// [B, H, N, N] f32 or null (zeros); seg_chunks: chunks per segment of the
// bf16 route; work: work_bytes of device workspace, at least
// workspace_floats() floats on the bf16 route; writes y [B, H, T, N] in
// that type and the final state s_out [B, H, N, N] f32.
extern "C" int mapsdi_rwkv6(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            void* y, void* s_out, void* work,
                            long long work_bytes, int b, int h, int t, int n,
                            int chunk, int seg_chunks, int dtype, int device,
                            void* stream) {
  cudaSetDevice(device);
  if (n != N || chunk != L || b * h <= 0 || t < 0 || seg_chunks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == recurrence::kBFloat16) {
    const size_t need =
        workspace_floats(b, h, t, seg_chunks) * sizeof(float);
    if (need && (!work || (size_t)work_bytes < need))
      return (int)cudaErrorInvalidValue;
    return launch_bf16(r, k, v, w, u, s0, y, s_out, work, b, h, t,
                       seg_chunks, st);
  }
  if (dtype == recurrence::kFloat32)
    return launch_f32(r, k, v, w, u, s0, y, s_out, b, h, t, st);
  return (int)cudaErrorInvalidValue;
}
