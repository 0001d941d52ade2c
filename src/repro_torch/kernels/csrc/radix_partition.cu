// Stable radix partition of the first `count` rows of data[N, K] int32 into
// n_buckets x cap_bucket row slots by a hash of the key columns:
//   target = h % nb                (exchange mode, shift == 0; any nb in
//                                   [1, 1024], a mask when nb is a power
//                                   of two)
//   target = h >> shift            (order-preserving mode, shift = 32 - log2 nb)
// Rows keep their original relative order inside a bucket. A row is
// written only if its slot is below cap_bucket; the unused slots of every
// bucket hold PAD. The clamped per-bucket counts and the overflow flag
// (some bucket's raw count above cap_bucket) are written here too.
//
// Replaces the TPU kernel radix_partition_pallas
// (src/repro/kernels/radix_partition/radix_partition.py). That kernel walked
// row tiles in order on one core, kept the whole bucketed output resident
// in VMEM and carried the per-bucket running totals from one grid step to
// the next. On the card blocks run in parallel and in no fixed order, so
// the running totals become a chained scan with decoupled look-back, in
// one pass over the rows, one tile a block:
//
//   1. Each block takes a tile index from a global ticket, so a block only
//      ever waits on tiles whose blocks are already running (forward
//      progress without co-residency).
//   2. It stages its tile (R rows x K int32, one contiguous span) in shared
//      memory with 16-byte cp.async copies; the ragged last tile and the
//      rows at and past `count` are not read.
//   3. It hashes every staged row, then ranks each among the tile's earlier
//      rows of the same bucket, by rounds of 256 rows: __match_any_sync +
//      popcount rank a row inside its warp; the warps' leaders post their
//      bucket counts in a shared table (tagged by round, two tables used
//      by turns, so none is ever cleared); one thread per bucket turns a
//      column into exclusive prefixes over the lower warps and the earlier
//      rounds. No atomic decides an order.
//   4. It publishes its per-bucket counts as aggregates, one 64-bit status
//      word per (bucket, tile), a bucket's words side by side so that a
//      window of lower tiles is one contiguous read: a flag in the high
//      word (1 aggregate, 2 inclusive prefix) and the count in the low
//      word, written in one store, so no fence orders flag and value.
//   5. It groups the tile's rows by bucket (a stable order: bucket, then
//      rank), then looks back over lower tiles for each bucket: a group of
//      lanes reads a window of lower tiles' words at once (one tile a lane;
//      a tile not yet published is waited for with a backoff), sums the
//      aggregates down to the nearest inclusive prefix, and goes on to the
//      next window if there is none. It then publishes its own inclusive
//      prefix.
//   6. It writes each bucket's run as one contiguous span of run x K int32
//      at the bucket's slot offset, neighbouring threads on neighbouring
//      words, and drops slots at or past cap_bucket. Each row is read from
//      device memory once and each row slot written once.
//
// The tickets past the last tile make finishing blocks in the same launch:
// they wait for the last tile's inclusive prefix (the raw bucket totals)
// and write the clamped counts, the overflow flag and the PAD tail
// [min(raw, cap_bucket), cap_bucket) of every bucket, in 16-byte stores.
// The ticket and status words are cleared on the stream first
// (cudaMemsetAsync): two CUDA launches a call.
//
// Tiles: the wrapper chooses R from K (radix_partition/kernel.py::tiles)
// and passes it; R is compiled for 32..1024 rows (powers of two) and any
// other R is refused. Past the wrapper's staging budget (K > 320 at R = 32)
// the tile is not staged: the rows are hashed and copied straight from
// device memory, a row at a time.
//
// What bounds it on the card: bytes, in principle. The rows are read once
// and every output slot is written once (rows or PAD), which is what the
// bound counts; the status words (nb x T x 8 bytes) are small beside the
// rows. At the main path's sizes (768 tiles at N = 786,432, K = 5) it
// reaches about a third of that bound: the tiles run as one wave whose
// blocks load, rank, look back and write in step, so the reads and the
// writes never overlap and each block's chain of barriers is exposed; the
// look-back and the write-out each add about a fifth
// (PERF.md section 6). Overlapping one tile's loads with
// another's writes inside a block (warp-specialised copies) is the next
// design.
#include "mapsdi_hash.cuh"

namespace {

constexpr int kThreads = 256;            // threads per block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;
constexpr unsigned long long kValue = 0xffffffffull;
constexpr int kFinishBlocks = 256;       // finishing blocks (at least one
                                         // per bucket)
constexpr int kMinBlocks = 6;            // blocks an SM's registers must
                                         // hold: 768 tiles in one wave

struct Keys {
  int n_key;
  unsigned long long lo, hi;   // column index j in byte j of (lo, hi)
  __device__ __forceinline__ int col(int j) const {
    return j < 8 ? (int)((lo >> (8 * j)) & 0xff)
                 : (int)((hi >> (8 * (j - 8))) & 0xff);
  }
};

__device__ __forceinline__ int row_target(const int32_t* row, int nb,
                                          int shift, Keys keys) {
  uint32_t h = MAPSDI_FNV_OFFSET, salt = MAPSDI_GOLDEN;
  for (int j = 0; j < keys.n_key; ++j, salt += MAPSDI_GOLDEN) {
    const uint32_t v = mapsdi_fmix32((uint32_t)row[keys.col(j)] + salt);
    h = (h ^ v) * MAPSDI_FNV_PRIME;
  }
  h = mapsdi_fmix32(h);
  if (shift) return (int)(h >> shift);
  // exchange mode: one bucket a shard, so any count (a mask for a power
  // of two, the common case)
  return (nb & (nb - 1)) ? (int)(h % (uint32_t)nb)
                         : (int)(h & (uint32_t)(nb - 1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Shared memory of one block, in this order (8-byte arrays first):
//   base  int64  [nb, rounded up to even] output word of grouped position
//                          0 of the bucket (even, so the tile after it
//                          starts on a 16-byte boundary for cp.async)
//   tile  int32  [R * K]   the staged rows (staged tiles only)
//   gp    uint32 [R]       grouped order: source row | bucket << 16
//   hist  int32  [nb]      the tile's rows per bucket
//   start int32  [nb]      grouped position of the bucket's first row
//   lim   int32  [nb]      grouped positions below it are written
//   wcnt  uint32 [2][kWarps][nb]  per round (by parity), round << 16 | a
//                          warp's count, then its exclusive prefix
//   scan  int32  [kWarps]
__host__ __device__ inline int base_words(int nb) { return (nb + 1) & ~1; }

__host__ __device__ inline size_t smem_bytes(int rows, bool staged, int k,
                                             int nb) {
  return (size_t)base_words(nb) * 8 + (staged ? (size_t)rows * k * 4 : 0) +
         (size_t)rows * 4 + (size_t)nb * 12 + (size_t)2 * kWarps * nb * 4 +
         kWarps * 4;
}

// out[i] = exclusive prefix sum of in[0..nb), by the whole block
__device__ void block_exclusive_scan(const int* in, int* out, int nb,
                                     int* tmp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (nb + kThreads - 1) / kThreads;
  const int s0 = min(tid * per, nb), s1 = min(s0 + per, nb);
  int s = 0;
  for (int i = s0; i < s1; ++i) s += in[i];
  int v = s;                             // inclusive scan within the warp
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += y;
  }
  if (lane == 31) tmp[warp] = v;
  __syncthreads();
  if (warp == 0) {                       // inclusive scan of warp totals
    int w = lane < kWarps ? tmp[lane] : 0;
    for (int off = 1; off < kWarps; off <<= 1) {
      const int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kWarps) tmp[lane] = w;
  }
  __syncthreads();
  int run = (warp ? tmp[warp - 1] : 0) + v - s;
  for (int i = s0; i < s1; ++i) {
    out[i] = run;
    run += in[i];
  }
  __syncthreads();
}

// The last tile's inclusive prefix for one bucket (its raw total), once
// published.
__device__ __forceinline__ long long raw_total(const unsigned long long* p) {
  unsigned long long w = load_status(p);
  for (unsigned ns = 64; (w >> 32) != 2; ns = min(2 * ns, 1024u)) {
    __nanosleep(ns);
    w = load_status(p);
  }
  return (long long)(w & kValue);
}

// Finishing block f of n_fin (a multiple of nb): from the last tile's
// inclusive prefixes, block 0 writes the clamped counts and the overflow
// flag, and each block writes its share of bucket f % nb's PAD tail,
// walked down from the bucket's end in 16-byte groups; a group that
// straddles the tail's edge is written a word at a time.
__device__ void finish(const unsigned long long* __restrict__ status,
                       int n_tiles, int f, int n_fin, int nb, int cb, int k,
                       int32_t* __restrict__ out,
                       int32_t* __restrict__ counts,
                       unsigned char* __restrict__ overflow) {
  __shared__ long long s_raw;
  if (f == 0) {
    int over = 0;
    for (int i = threadIdx.x; i < nb; i += kThreads) {
      const long long raw =
          raw_total(status + (long long)i * n_tiles + n_tiles - 1);
      counts[i] = (int)min(raw, (long long)cb);
      over |= raw > cb;
    }
    over = __syncthreads_or(over);
    if (threadIdx.x == 0) *overflow = (unsigned char)(over != 0);
  }
  const int b = f % nb, part = f / nb, parts = n_fin / nb;
  if (threadIdx.x == 0)
    s_raw = raw_total(status + (long long)b * n_tiles + n_tiles - 1);
  __syncthreads();
  const long long raw = s_raw;
  const long long lo = ((long long)b * cb + min(raw, (long long)cb)) * k;
  const long long hi = ((long long)b * cb + cb) * k;
  if (lo >= hi) return;
  const long long g_lo = lo >> 2, g_top = ((hi + 3) >> 2) - 1;
  const int4 pad4 = make_int4(MAPSDI_PAD_ID, MAPSDI_PAD_ID, MAPSDI_PAD_ID,
                              MAPSDI_PAD_ID);
  for (long long i = (long long)part * kThreads + threadIdx.x;
       g_top - i >= g_lo; i += (long long)parts * kThreads) {
    const long long grp = g_top - i, w0 = grp << 2;
    if (w0 >= lo && w0 + 4 <= hi) {
      reinterpret_cast<int4*>(out)[grp] = pad4;
    } else {
      for (int j = 0; j < 4; ++j)
        if (w0 + j >= lo && w0 + j < hi) out[w0 + j] = MAPSDI_PAD_ID;
    }
  }
}

template <int R, bool STAGED>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rp_tiles(const int32_t* __restrict__ x, const int32_t* __restrict__ count,
         int n, int k, int nb, int cb, int shift, Keys keys, int n_tiles,
         int n_fin, unsigned long long* __restrict__ scratch,
         int32_t* __restrict__ out, int32_t* __restrict__ counts,
         unsigned char* __restrict__ overflow) {
  constexpr int kRounds = (R + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  long long* base = reinterpret_cast<long long*>(smem);
  int32_t* tile = reinterpret_cast<int32_t*>(base + base_words(nb));
  uint32_t* gp = reinterpret_cast<uint32_t*>(tile + (STAGED ? R * k : 0));
  int* hist = reinterpret_cast<int*>(gp + R);
  int* start = hist + nb;
  int* lim = start + nb;
  uint32_t* wcnt = reinterpret_cast<uint32_t*>(lim + nb);
  int* scan_tmp = reinterpret_cast<int*>(wcnt + 2 * kWarps * nb);
  __shared__ int s_tile;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned long long* status = scratch + 1;
  if (tid == 0) s_tile = (int)atomicAdd(scratch, 1ull);
  const long long valid = min((long long)n, max((long long)*count, 0ll));
  for (int i = tid; i < nb; i += kThreads) hist[i] = 0;
  for (int i = tid; i < 2 * kWarps * nb; i += kThreads) wcnt[i] = 0;
  __syncthreads();
  const long long t = s_tile;
  if (t >= n_tiles) {                    // every tile's block has started
    finish(status, n_tiles, (int)(t - n_tiles), n_fin, nb, cb, k, out, counts,
           overflow);
    return;
  }
  const int rows_here = (int)max(0ll, min((long long)R, valid - t * R));
  const int32_t* src = x + t * R * k;
  if (STAGED) {                          // 16-byte aligned: R * K % 4 == 0
    const int words = rows_here * k, vec = words >> 2;
    for (int i = tid; i < vec; i += kThreads)
      cp_async16(tile + 4 * i, src + 4 * i);
    for (int i = 4 * vec + tid; i < words; i += kThreads)
      cp_async4(tile + i, src + i);
    cp_async_wait_all();
    __syncthreads();
  }
  const int32_t* rows = STAGED ? tile : src;

  // 3. target and stable in-tile rank of each row, by rounds of kThreads
  // rows: a warp's leaders post their bucket counts, one thread per bucket
  // turns them into exclusive prefixes (lower warps, earlier rounds) and
  // keeps the running count, and each row adds its lanes below
  int tg[kRounds], rk[kRounds];
#pragma unroll
  for (int rd = 0; rd < kRounds; ++rd) {   // the hashes first: independent
    const int r = rd * kThreads + tid;
    tg[rd] = r < rows_here
                 ? row_target(rows + (long long)r * k, nb, shift, keys)
                 : nb;
  }
#pragma unroll
  for (int rd = 0; rd < kRounds; ++rd) {
    const int b = tg[rd];
    const unsigned peers = __match_any_sync(kFull, b);
    const unsigned below = peers & ((1u << lane) - 1u);
    const uint32_t tag = (uint32_t)(rd + 1) << 16;
    uint32_t* wc = wcnt + (rd & 1) * kWarps * nb;    // last read 2 rounds ago
    if (b < nb && below == 0) wc[warp * nb + b] = tag | __popc(peers);
    __syncthreads();
    for (int bb = tid; bb < nb; bb += kThreads) {
      uint32_t run = (uint32_t)hist[bb];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const uint32_t v = wc[w * nb + bb];
        wc[w * nb + bb] = tag | run;
        if ((v & 0xffff0000u) == tag) run += v & 0xffffu;
      }
      hist[bb] = (int)run;
    }
    __syncthreads();
    rk[rd] = b < nb ? (int)(wc[warp * nb + b] & 0xffffu) + __popc(below) : 0;
  }
  __syncthreads();

  // 4. publish the tile's aggregates (tile 0's are its inclusive prefix)
  for (int b = tid; b < nb; b += kThreads)
    store_status(status + (long long)b * n_tiles + t,
                 (t == 0 ? kInclusive : kAggregate) | (unsigned)hist[b]);

  // 5. stable grouping by bucket, then the look-back
  block_exclusive_scan(hist, start, nb, scan_tmp);
#pragma unroll
  for (int rd = 0; rd < kRounds; ++rd)
    if (tg[rd] < nb)
      gp[start[tg[rd]] + rk[rd]] =
          (uint32_t)(rd * kThreads + tid) | ((uint32_t)tg[rd] << 16);

  // groups of g lanes, one bucket at a time, each lane one lower tile of
  // the window: g = 32 for nb <= 8, 1 from nb = 256 up; rounded down to a
  // power of two, since the groups split the warp evenly
  const int g = 1 << (31 - __clz(min(32, max(1, kThreads / nb))));
  const int li = lane & (g - 1);
  const unsigned gshift = lane & ~(g - 1);
  const unsigned gbits = g == 32 ? kFull : (1u << g) - 1u;
  const unsigned gmask = gbits << gshift;
  for (int b = tid / g; b < nb; b += kThreads / g) {
    long long excl = 0;
    if (t > 0) {
      for (long long j = t - 1 - li;; j -= g) {
        // a tile that has not published yet is waited for, with a backoff;
        // every tile below an inclusive prefix has published
        unsigned long long w =
            j >= 0 ? load_status(status + (long long)b * n_tiles + j) : kInclusive;
        for (unsigned ns = 32; !(w >> 32); ns = min(2 * ns, 1024u)) {
          __nanosleep(ns);
          w = load_status(status + (long long)b * n_tiles + j);
        }
        const unsigned incl =
            (__ballot_sync(gmask, (w >> 32) == 2) >> gshift) & gbits;
        // the lanes down to the one with the nearest inclusive prefix
        const unsigned upto =
            incl ? (((incl & (0u - incl)) << 1) - 1u) : gbits;
        unsigned long long part = ((upto >> li) & 1u) ? (w & kValue) : 0ull;
        for (int off = g >> 1; off > 0; off >>= 1)
          part += __shfl_xor_sync(gmask, part, off, g);
        excl += (long long)part;
        if (incl) break;
      }
      if (li == 0)
        store_status(status + (long long)b * n_tiles + t,
                     kInclusive | (unsigned long long)(excl + hist[b]));
    }
    if (li == 0) {
      base[b] = ((long long)b * cb + excl - start[b]) * k;
      lim[b] = start[b] +
               (int)max(0ll, min((long long)hist[b], (long long)cb - excl));
    }
  }
  __syncthreads();

  // 6. each bucket's run, contiguous, at its slots
  if (STAGED) {
    const int words = rows_here * k;
    const unsigned kdiv = 0xffffffffu / (unsigned)k + 1u;   // exact: w k < 2^32
#pragma unroll 4
    for (int w = tid; w < words; w += kThreads) {
      const int p = k == 1 ? w : (int)__umulhi((unsigned)w, kdiv);
      const int c = w - p * k;
      const uint32_t e = gp[p];
      const int b = (int)(e >> 16);
      if (p < lim[b]) out[base[b] + w] = rows[(int)(e & 0xffffu) * k + c];
    }
  } else {
    for (int p = 0; p < rows_here; ++p) {
      const uint32_t e = gp[p];
      const int b = (int)(e >> 16);
      if (p >= lim[b]) continue;
      const int32_t* s = src + (long long)(e & 0xffffu) * k;
      int32_t* d = out + base[b] + (long long)p * k;
      for (int c = tid; c < k; c += kThreads) d[c] = s[c];
    }
  }
}

template <int R, bool STAGED>
int launch_tiles(int tiles, size_t smem, const int32_t* x,
                 const int32_t* count, int n, int k, int nb, int cb,
                 int shift, Keys keys, unsigned long long* scratch,
                 int32_t* out, int32_t* counts, unsigned char* overflow,
                 cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rp_tiles<R, STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // a multiple of nb: each bucket gets the same share of finishing blocks
  const int n_fin = (max(nb, kFinishBlocks) + nb - 1) / nb * nb;
  rp_tiles<R, STAGED><<<(unsigned)(tiles + n_fin), kThreads, smem, s>>>(
      x, count, n, k, nb, cb, shift, keys, tiles, n_fin, scratch, out,
      counts, overflow);
  return (int)cudaGetLastError();
}

}  // namespace

// data [n, k] int32, contiguous and 16-byte aligned; count a device int32
// (rows at and past it are invalid); out [n_buckets * cap_bucket, k]
// int32, counts [n_buckets] int32 and overflow (one byte) are written
// whole. tile_rows is the wrapper's R (32..1024, a power of two); staged
// 0 reads the rows from device memory (only at R = 32). scratch holds the
// ticket and the status words: 8 * (1 + ceil(n / R) * n_buckets) bytes.
extern "C" int mapsdi_radix_partition(
    const void* data, const void* count, int n, int k, int n_buckets,
    int cap_bucket, int shift, int n_key, unsigned long long key_lo,
    unsigned long long key_hi, int tile_rows, int staged, void* scratch,
    long long scratch_bytes, void* out, void* counts, void* overflow,
    int device, void* stream) {
  cudaSetDevice(device);
  const int nb = n_buckets;
  // exchange mode takes any bucket count in [1, 1024]; the
  // order-preserving mode's top-bits target needs a power of two >= 2
  if (n < 1 || k < 1 || cap_bucket < 1 || nb < 1 || nb > 1024 ||
      n_key < 1 || n_key > 16 || shift < 0 || shift > 31 ||
      (shift && (nb < 2 || (nb & (nb - 1)) || shift != 32 - __builtin_ctz(nb))))
    return (int)cudaErrorInvalidValue;
  const bool staged_rows = tile_rows >= 32 && tile_rows <= 1024 &&
                           !(tile_rows & (tile_rows - 1));
  if (staged ? !staged_rows : tile_rows != 32)
    return (int)cudaErrorInvalidValue;   // an R this file is not built for
  const int tiles = (int)(((long long)n + tile_rows - 1) / tile_rows);
  const long long need = 8 * (1 + (long long)tiles * nb);
  if (scratch_bytes < need) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(tile_rows, staged != 0, k, nb);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* sc = (unsigned long long*)scratch;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)need, s);
  if (e != cudaSuccess) return (int)e;
  const Keys keys{n_key, key_lo, key_hi};
  const int32_t* x = (const int32_t*)data;
  const int32_t* cnt = (const int32_t*)count;
  int32_t* o = (int32_t*)out;
  int32_t* cts = (int32_t*)counts;
  unsigned char* ovf = (unsigned char*)overflow;
  int rc = 0;
#define MAPSDI_RP_CASE(RR)                                                 \
  case RR:                                                                 \
    rc = launch_tiles<RR, true>(tiles, smem, x, cnt, n, k, nb, cap_bucket, \
                                shift, keys, sc, o, cts, ovf, s);          \
    break;
  if (staged) {
    switch (tile_rows) {
      MAPSDI_RP_CASE(32)
      MAPSDI_RP_CASE(64)
      MAPSDI_RP_CASE(128)
      MAPSDI_RP_CASE(256)
      MAPSDI_RP_CASE(512)
      MAPSDI_RP_CASE(1024)
    }
  } else {
    rc = launch_tiles<32, false>(tiles, smem, x, cnt, n, k, nb, cap_bucket,
                                 shift, keys, sc, o, cts, ovf, s);
  }
#undef MAPSDI_RP_CASE
  return rc;
}
