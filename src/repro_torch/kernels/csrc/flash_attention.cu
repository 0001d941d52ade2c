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
//       or window > 0 and qp - kp >= window
//   m_new = max(m, max s); p = masked ? 0 : exp(s - m_new)
//   alpha = exp(m - m_new); l = alpha l + sum p; acc = alpha acc + p v
//   o = acc / (l == 0 ? 1 : l)
// with p, l and acc in float32 and o written in q's type: the TPU kernel's
// arithmetic, so a row that no key reaches gives 0. Tiles that the kv_len,
// causal or window masks cover entirely are skipped with the TPU kernel's
// predicate; ragged Sq and Sk are masked in the kernel (no padding
// copies); GQA maps the q head to its kv head (k and v are never copied
// per q head).
//
// What bounds it on the card: operations. Per unmasked (q, k) pair it does
// 2 D multiply-adds and one exponential against 4 D values read and
// written per row; at the paths' lengths (Sk = 448 to 2048) that is far
// above the card's bytes-per-operation line. The bound is the tensor
// cores' bf16 rate, with the exponentials close behind (whisper's encoder
// shape: 0.0466 ms of products, 0.0430 ms of exponentials).
//
// bfloat16 inputs (the models' route) take the tensor cores: mma.sync
// m16n8k16, bf16 operands, float32 accumulation. A block of 4 warps owns a
// q tile of block_q = 64 rows (16 a warp) and loops over k/v tiles of
// block_k rows. Both tile sizes are the wrapper's choice
// (flash_attention/kernel.py: tiles), passed to the C entry point; this
// file compiles the pairs that tc::dispatch_tiles lists for every head
// size and refuses any other pair, so the two cannot drift apart
// silently.
// - q's A fragments are loaded once into registers with ldmatrix where
//   they fit beside the accumulators (Tc::kQRegs); otherwise (D = 256)
//   they are read from shared memory at every k tile.
// - k and v are staged as bf16 in shared memory, rows padded to D + 8
//   values (an odd number of 16-byte chunks, so the 8 rows one ldmatrix
//   phase reads fall on distinct banks), in two stages filled with
//   cp.async 16-byte copies: tile t+1 is in flight while tile t computes;
//   rows past Sk are zero-filled by the copy itself. One barrier per k
//   tile: tile t has landed and tile t-1's stage is free for tile t+1.
// - s = q k^T accumulates in float32 registers; bf16 x bf16 products are
//   exact in float32, so q k^T needs no split. The online softmax runs in
//   registers: row max and sum over the 4 lanes that share an accumulator
//   row, exp2 with scale * log2(e) folded into one fma, alpha applied to
//   the accumulator in place and skipped when no row's max moved. The
//   element mask is evaluated only on tiles that a kv_len, causal or
//   window boundary cuts.
// - p v takes p as the A operand straight from the score accumulators, no
//   trip through shared memory. p stays float32 in the TPU kernel (its
//   _step), so it is split into two bf16 parts, hi = bf16(p) and
//   lo = bf16(p - hi), both multiplied by v into the same float32
//   accumulator: p to about 16 bits. Rounding p once (8 bits) puts outputs
//   that cancel near 0 outside the bf16 tolerance of the float32 plain
//   version. The split makes three products per pair where two would do:
//   half again the tensor-core work, which caps the kernel at about 67% of
//   the bound the useful products set.
// - The q tiles with the most live k tiles go first (the last ones under
//   a causal mask), the (batch, head) index varying fastest.
// A later design would move to Hopper's wgmma (64-row warpgroup products
// with k and v read straight from shared memory), TMA loads into a ring
// of stages fed by a producer warp, and two consumer warpgroups whose
// softmax overlaps each other's products.
//
// float32 inputs keep the first design, on the float32 lanes: one block of
// 256 threads per (batch*head, 64-row q tile) loops over 64-row k/v tiles
// staged as float32 (tiles of its own, which nothing outside this file
// depends on); both products are register-tiled fmaf loops. Only the
// reduced-depth float32 comparisons and the float32 edge cases reach it.
#include "recurrence.cuh"

namespace {

using recurrence::bf16;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------
namespace tc {

using recurrence::cp_async16;
using recurrence::cp_async_commit;
using recurrence::cp_async_wait_all;
using recurrence::ex2;
using recurrence::kFull;
using recurrence::ldsm_x4;
using recurrence::ldsm_x4_t;
using recurrence::mma;
using recurrence::split_bf16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

template <int D, int BK>
struct Tc {
  static constexpr int BQ = 16 * kWarps;   // q rows per block, 16 a warp
  static constexpr int LD = D + 8;    // shared row stride, bf16 values
  static constexpr int CH = D / 8;    // 16-byte chunks per row
  static constexpr int NS = BK / 8;   // score tiles (16 x 8) per warp
  static constexpr int NO = D / 8;    // output tiles per warp
  static constexpr int KD = D / 16;   // k16 steps of q k^T
  // q's fragments (D / 4 registers) stay in registers where, with the
  // output (D / 2) and score (BK / 2) accumulators, they take at most 200
  // of the 255
  static constexpr bool kQRegs = 3 * D / 4 + BK / 2 <= 200;
  // blocks per SM the registers must allow (ptxas left to itself trades
  // occupancy for a few spilled bytes at some head sizes)
  static constexpr int kMinBlocks = D <= 32 ? 4 : D <= 80 ? 3 : 1;
  static constexpr size_t q = 0;      // offsets in bf16 values
  static constexpr size_t k = q + (size_t)BQ * LD;          // 2 stages
  static constexpr size_t v = k + 2 * (size_t)BK * LD;      // 2 stages
  static constexpr size_t bytes = (v + 2 * (size_t)BK * LD) * sizeof(bf16);
};

// ROWS x D rows (device row stride D) into shared memory (row stride
// D + 8), asynchronously; rows at and past rows_left read as 0
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int rows_left, int tid) {
  constexpr int CH = D / 8, LD = D + 8, N = ROWS * CH;
#pragma unroll
  for (int i = 0; i < (N + kThreads - 1) / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / CH, c = idx - r * CH;
    const bool valid = r < rows_left;
    if (N % kThreads == 0 || idx < N)
      cp_async16(dst + r * LD + c * 8,
                 src + (valid ? (size_t)r * D + c * 8 : 0), valid);
  }
}

template <int D, int BK>
__global__ void __launch_bounds__(kThreads, (Tc<D, BK>::kMinBlocks))
flash_attention_bf16_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            bf16* __restrict__ o, int h, int kh, int sq,
                            int sk, int kv_len, int causal, int window,
                            float scale_log2) {
  using C = Tc<D, BK>;
  constexpr int BQ = C::BQ, LD = C::LD, CH = C::CH;
  constexpr int NS = C::NS, NO = C::NO, KD = C::KD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw) + C::q;
  bf16* ks = reinterpret_cast<bf16*>(smem_raw) + C::k;
  bf16* vs = reinterpret_cast<bf16*>(smem_raw) + C::v;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;   // accumulator row, column pair
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest first
  const int kvh = (bh / h) * kh + (bh % h) / (h / kh);
  const bf16* kb = k + (size_t)kvh * sk * D;
  const bf16* vb = v + (size_t)kvh * sk * D;

  // the TPU kernel's predicate: a tile every pair of which is masked is
  // skipped; the live tiles form one range [t_begin, t_end)
  const int q_first = q0 + kv_len - sq;   // absolute position of row 0
  const int q_last = q_first + BQ - 1;
  const int n_tiles = (sk + BK - 1) / BK;
  int t_begin = n_tiles, t_end = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int k_first = t * BK, k_last = k_first + BK - 1;
    bool live = k_first < kv_len;
    if (causal) live = live && k_first <= q_last;
    if (window > 0) live = live && k_last > q_first - window;
    if (live) {
      t_begin = min(t_begin, t);
      t_end = t + 1;
    }
  }

  load_tile<D, BQ>(qs, q + ((size_t)bh * sq + q0) * D, sq - q0, tid);
  if (t_begin < t_end) {
    const int k0 = t_begin * BK;
    load_tile<D, BK>(ks, kb + (size_t)k0 * D, sk - k0, tid);
    load_tile<D, BK>(vs, vb + (size_t)k0 * D, sk - k0, tid);
  }
  cp_async_commit();

  // ldmatrix row addresses: lane l feeds row l % 8 of matrix l / 8.
  // q (A, 16 x 16): matrices (rows 0-7, d 0-7), (8-15, 0-7), (0-7, 8-15),
  // (8-15, 8-15)
  const int row_w = warp * 16;   // this warp's first row in the tile
  const bf16* q_lane =
      qs + (row_w + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
  // k (B of q k^T): (keys 0-7, d 0-7), (0-7, 8-15), (8-15, 0-7), (8-15, 8-15)
  const int k_off =
      ((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
  // v (B of p v), transposed: (keys 0-7, d 0-7), (8-15, 0-7), (0-7, 8-15),
  // (8-15, 8-15)
  const int v_off =
      ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  // the scale goes into the exponent, exp2(s c - base) with c > 0: a
  // negative scale flips q's sign bits instead, and a zero scale zeroes q
  // (every score then reads 0, as s * 0 does)
  const uint32_t q_and = scale_log2 == 0.0f ? 0u : 0xffffffffu;
  const uint32_t q_xor = scale_log2 < 0.0f ? 0x80008000u : 0u;
  const float c = scale_log2 == 0.0f ? 1.0f : fabsf(scale_log2);
  uint32_t qf[C::kQRegs ? KD : 1][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  // rows g and g + 8 of the warp: running max (log2 units) and this
  // lane's share of the denominator
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    // tile t (and, at the first, q) has landed, and every warp is done
    // with tile t - 1, whose stage tile t + 1 now refills
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < t_end) {
      const int nxt = (t + 1) * BK;
      load_tile<D, BK>(ks + (stage ^ 1) * BK * LD, kb + (size_t)nxt * D,
                       sk - nxt, tid);
      load_tile<D, BK>(vs + (stage ^ 1) * BK * LD, vb + (size_t)nxt * D,
                       sk - nxt, tid);
      cp_async_commit();
    }
    if constexpr (C::kQRegs) {
      if (t == t_begin) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          ldsm_x4(qf[kd], q_lane + kd * 16);
#pragma unroll
          for (int e = 0; e < 4; ++e) qf[kd][e] = (qf[kd][e] & q_and) ^ q_xor;
        }
      }
    }

    // s = q k^T
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
    const bf16* k_lane = ks + stage * BK * LD + k_off;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t a[4];
      if constexpr (C::kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kd][e];
      } else {
        ldsm_x4(a, q_lane + kd * 16);
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = (a[e] & q_and) ^ q_xor;
      }
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t b[4];
        ldsm_x4(b, k_lane + j * 16 * LD + kd * 16);
        mma(s[2 * j], a, b[0], b[1]);
        mma(s[2 * j + 1], a, b[2], b[3]);
      }
    }

    // the element mask, only where a boundary cuts the tile (uniform over
    // the block)
    const int k_first = t * BK;
    bool cut = k_first + BK > kv_len;
    if (causal) cut = cut || k_first + BK - 1 > q_first;
    if (window > 0) cut = cut || q_last - k_first >= window;
    if (cut) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = q_first + row_w + g + (e >> 1) * 8;
          const int kp = k_first + n * 8 + tig * 2 + (e & 1);
          bool keep = kp < kv_len;
          if (causal) keep = keep && kp <= qp;
          if (window > 0) keep = keep && qp - kp < window;
          s[n][e] = keep ? s[n][e] : -INFINITY;
        }
    }

    // online softmax in log2 units; a row that has seen no key keeps
    // m = -inf and takes 0 as its exponent base, so its p and alpha are 0
    float mx[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tm = -INFINITY;   // the tile's row max, unscaled
#pragma unroll
      for (int n = 0; n < NS; ++n)
        tm = fmaxf(tm, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      tm = fmaxf(tm, __shfl_xor_sync(kFull, tm, 1));
      tm = fmaxf(tm, __shfl_xor_sync(kFull, tm, 2));
      mx[r] = fmaxf(m[r], tm * c);
      base[r] = mx[r] == -INFINITY ? 0.0f : mx[r];
    }
    // alpha is exactly 1 where the max did not move: the warp skips the
    // rescale when that holds for all its rows
    if (__any_sync(kFull, mx[0] != m[0] || mx[1] != m[1])) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float alpha = ex2(m[r] - base[r]);
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = mx[r];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        s[n][2 * r] = ex2(fmaf(s[n][2 * r], c, -base[r]));
        s[n][2 * r + 1] = ex2(fmaf(s[n][2 * r + 1], c, -base[r]));
        l[r] += s[n][2 * r] + s[n][2 * r + 1];
      }
    }

    // acc += p v with p = hi + lo: the score accumulators of keys
    // 16 kk .. 16 kk + 15 are the A fragment of that k16 step
    const bf16* v_lane = vs + stage * BK * LD + v_off;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        uint32_t b[4];
        ldsm_x4_t(b, v_lane + kk * 16 * LD + j * 16);
        mma(acc[2 * j], ph, b[0], b[1]);
        mma(acc[2 * j], pl, b[0], b[1]);
        mma(acc[2 * j + 1], ph, b[2], b[3]);
        mma(acc[2 * j + 1], pl, b[2], b[3]);
      }
    }
  }

  // o = acc / l, staged through this warp's own rows of the q tile (no
  // other warp reads them) and written as 16-byte rows
  cp_async_wait_all();   // the q copy (any thread's), when no tile was live
  __syncthreads();
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    inv[r] = 1.0f / (l[r] == 0.0f ? 1.0f : l[r]);
  }
  bf16* os = qs + row_w * LD;
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<__nv_bfloat162*>(os + (g + 8 * r) * LD + n * 8 +
                                         tig * 2) =
          __floats2bfloat162_rn(acc[n][2 * r] * inv[r],
                                acc[n][2 * r + 1] * inv[r]);
  __syncwarp();
  bf16* ob = o + ((size_t)bh * sq + q0 + row_w) * D;
#pragma unroll
  for (int it = 0; it < (16 * CH + 31) / 32; ++it) {
    const int idx = lane + 32 * it;
    const int r = idx / CH, cc = idx - r * CH;
    if (idx < 16 * CH && q0 + row_w + r < sq)
      *reinterpret_cast<uint4*>(ob + (size_t)r * D + cc * 8) =
          *reinterpret_cast<const uint4*>(os + r * LD + cc * 8);
  }
}

template <int D, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int kh, int sq, int sk, int kv_len, int causal, int window,
           float scale, cudaStream_t stream) {
  using C = Tc<D, BK>;
  const int smem = (int)C::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_bf16_kernel<D, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(b * h), (unsigned)((sq + C::BQ - 1) / C::BQ));
  flash_attention_bf16_kernel<D, BK><<<grid, kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, h, kh, sq,
      sk, kv_len, causal, window, scale * recurrence::kLog2e);
  return (int)cudaGetLastError();
}

// The tiles compiled for every head size: q tiles of 64 rows (16 a warp)
// and k tiles of 32 or 64 rows (the 64-row tile spills at D = 256)
template <int D>
int dispatch_tiles(int block_q, int block_k, const void* q, const void* k,
                   const void* v, void* o, int b, int h, int kh, int sq,
                   int sk, int kv_len, int causal, int window, float scale,
                   cudaStream_t st) {
  if (block_q != Tc<D, 64>::BQ) return (int)cudaErrorInvalidValue;
  if (block_k == 64)
    return launch<D, 64>(q, k, v, o, b, h, kh, sq, sk, kv_len, causal,
                         window, scale, st);
  if (block_k == 32)
    return launch<D, 32>(q, k, v, o, b, h, kh, sq, sk, kv_len, causal,
                         window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// float32: the float32 lanes
// ---------------------------------------------------------------------------
namespace f32 {

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

__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, int rows_left,
                                          int D, int tid) {
  // rows at and past rows_left read as 0
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    dst[r * ld + c] = r < rows_left ? src[idx] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ o, int h, int kh, int sq,
                           int sk, int kv_len, int causal, int window,
                           float scale) {
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
  const float* qb = q + ((size_t)bh * sq + q0) * D;
  const float* kb = k + (size_t)kvh * sk * D;
  const float* vb = v + (size_t)kvh * sk * D;

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
    float* orow = o + ((size_t)bh * sq + q0 + r) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) orow[tx + 16 * j] = acc[i][j] / l;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int h, int kh, int sq, int sk, int kv_len, int causal, int window,
           float scale, cudaStream_t stream) {
  const int smem = (int)Layout<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((sq + BQ - 1) / BQ), (unsigned)(b * h));
  flash_attention_f32_kernel<D><<<grid, kThreads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, h, kh,
      sq, sk, kv_len, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace f32

template <int D>
int dispatch(bool bf16_route, int block_q, int block_k, const void* q,
             const void* k, const void* v, void* o, int b, int h, int kh,
             int sq, int sk, int kv_len, int causal, int window, float scale,
             cudaStream_t st) {
  if (bf16_route)
    return tc::dispatch_tiles<D>(block_q, block_k, q, k, v, o, b, h, kh, sq,
                                 sk, kv_len, causal, window, scale, st);
  return f32::launch<D>(q, k, v, o, b, h, kh, sq, sk, kv_len, causal, window,
                        scale, st);
}

}  // namespace

// q [B, H, Sq, D], k/v [B, KH, Sk, D] contiguous, all of one type (bf16
// pointers 16-byte aligned); writes o [B, H, Sq, D] in that type.
// 0 <= kv_len <= Sk; window 0 means none; D one of 16, 32, 64, 80, 112,
// 128, 256; block_q and block_k are the bf16 route's tiles (see the
// header; the float32 route ignores them).
extern "C" int mapsdi_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, int b, int h,
                                      int kh, int sq, int sk, int d,
                                      int kv_len, int causal, int window,
                                      float scale, int block_q, int block_k,
                                      int dtype, int device, void* stream) {
  cudaSetDevice(device);
  if (b <= 0 || h <= 0 || kh <= 0 || h % kh || sq <= 0 || sk < 0 ||
      kv_len < 0 || kv_len > sk || window < 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != recurrence::kBFloat16 && dtype != recurrence::kFloat32)
    return (int)cudaErrorInvalidValue;
  const bool bf16_route = dtype == recurrence::kBFloat16;
  cudaStream_t st = (cudaStream_t)stream;
#define MAPSDI_FA_CASE(DD)                                                  \
  case DD:                                                                  \
    return dispatch<DD>(bf16_route, block_q, block_k, q, k, v, o, b, h, kh, \
                        sq, sk, kv_len, causal, window, scale, st);
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
