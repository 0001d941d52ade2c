// Stable radix partition of the first `count` rows of data[N, K] int32 into
// n_buckets x cap_bucket row slots by a hash of the key columns:
//   target = h & (nb - 1)          (exchange mode, shift == 0)
//   target = h >> shift            (order-preserving mode, shift = 32 - log2 nb)
// Rows keep their original relative order inside a bucket. A row is
// written only if its slot is below cap_bucket; the raw per-bucket counts
// are returned, so the caller clamps them and raises the overflow flag.
// The output must arrive PAD-filled (the wrapper allocates it so).
//
// Replaces the TPU kernel radix_partition_pallas
// (src/repro/kernels/radix_partition/radix_partition.py). That kernel walked
// row tiles in order on one core, kept the whole bucketed output resident
// in VMEM, and built each tile's grouping permutation with one-hot matrix
// products on 16-bit limbs. On the card blocks run in parallel and in no
// order, so the running per-bucket totals become three launches:
//   1. per-block histogram of targets in shared memory (nb+1 bins: the
//      extra bin takes invalid rows);
//   2. per bucket, an exclusive scan over the blocks' histograms, which
//      gives each block its starting slot in every bucket, and the raw
//      bucket totals;
//   3. a scatter: each block recomputes its targets, ranks each row among
//      the same-bucket rows of its warp with __match_any_sync + popcount,
//      adds the same-bucket counts of the lower warps of the block (a
//      shared-memory table) and its block's starting slot. No atomics
//      decide slot order, so the result is bit-identical to the stable
//      plain version.
//
// What bounds it on the card: bytes. The rows are read twice (passes 1 and
// 3; the hash is recomputed instead of storing targets) and every output
// slot is written once (PAD fill plus the row scatter). The scratch
// histogram is N/256 x nb int32, small beside the rows.
#include "mapsdi_hash.cuh"

namespace {

constexpr int kThreads = 256;            // rows per block, one per thread
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

struct Keys {
  int n_key;
  unsigned long long lo, hi;   // column index j in byte j of (lo, hi)
  __device__ __forceinline__ int col(int j) const {
    return j < 8 ? (int)((lo >> (8 * j)) & 0xff)
                 : (int)((hi >> (8 * (j - 8))) & 0xff);
  }
};

__device__ __forceinline__ int target_of(const int32_t* __restrict__ x,
                                         long long i, int n, int cnt, int k,
                                         int nb, int shift, Keys keys) {
  if (i >= n || i >= cnt) return nb;     // invalid row: the sentinel bin
  const int32_t* row = x + i * k;
  uint32_t h = MAPSDI_FNV_OFFSET;
  for (int j = 0; j < keys.n_key; ++j) {
    uint32_t salt = MAPSDI_GOLDEN * (uint32_t)(j + 1);
    uint32_t v = mapsdi_fmix32((uint32_t)row[keys.col(j)] + salt);
    h = (h ^ v) * MAPSDI_FNV_PRIME;
  }
  h = mapsdi_fmix32(h);
  return shift ? (int)(h >> shift) : (int)(h & (uint32_t)(nb - 1));
}

__global__ void rp_hist(const int32_t* __restrict__ x,
                        const int32_t* __restrict__ count, int n, int k,
                        int nb, int shift, Keys keys,
                        int32_t* __restrict__ block_hist) {
  extern __shared__ int hist[];          // nb + 1 bins
  for (int t = threadIdx.x; t <= nb; t += blockDim.x) hist[t] = 0;
  __syncthreads();
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int t = target_of(x, i, n, *count, k, nb, shift, keys);
  atomicAdd(&hist[t], 1);                // a count: order does not matter
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += blockDim.x)
    block_hist[(long long)blockIdx.x * nb + b] = hist[b];
}

// One block per bucket: exclusive scan of the bucket's column of
// block_hist[n_blocks, nb], in place; raw[b] = the bucket's total.
__global__ void rp_scan(int32_t* __restrict__ block_hist, int n_blocks,
                        int nb, int32_t* __restrict__ raw) {
  __shared__ int warp_tot[32];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int per = (n_blocks + blockDim.x - 1) / blockDim.x;
  const int start = threadIdx.x * per;
  const int end = min(start + per, n_blocks);
  int s = 0;
  for (int j = start; j < end; ++j) s += block_hist[(long long)j * nb + b];
  int v = s;                             // inclusive scan within the warp
  for (int off = 1; off < 32; off <<= 1) {
    int y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += y;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {                       // inclusive scan of warp totals
    int w = lane < n_warps ? warp_tot[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      int y = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += y;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  int run = (warp ? warp_tot[warp - 1] : 0) + v - s;   // exclusive prefix
  for (int j = start; j < end; ++j) {
    long long idx = (long long)j * nb + b;
    int c = block_hist[idx];
    block_hist[idx] = run;
    run += c;
  }
  if (threadIdx.x == 0) raw[b] = warp_tot[n_warps - 1];
}

__global__ void rp_scatter(const int32_t* __restrict__ x,
                           const int32_t* __restrict__ count, int n, int k,
                           int nb, int cb, int shift, Keys keys,
                           const int32_t* __restrict__ block_off,
                           int32_t* __restrict__ out) {
  extern __shared__ int warp_cnt[];      // [kWarps][nb + 1]
  for (int idx = threadIdx.x; idx < kWarps * (nb + 1); idx += blockDim.x)
    warp_cnt[idx] = 0;
  __syncthreads();
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int t = target_of(x, i, n, *count, k, nb, shift, keys);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned peers = __match_any_sync(kFull, t);
  int rank = __popc(peers & ((1u << lane) - 1u));   // same-bucket lanes below
  if (lane == __ffs(peers) - 1) warp_cnt[warp * (nb + 1) + t] = __popc(peers);
  __syncthreads();
  if (t >= nb) return;
  int slot = block_off[(long long)blockIdx.x * nb + t] + rank;
  for (int w = 0; w < warp; ++w) slot += warp_cnt[w * (nb + 1) + t];
  if (slot >= cb) return;                // dropped: the caller flags overflow
  const int32_t* src = x + i * k;
  int32_t* dst = out + ((long long)t * cb + slot) * k;
  for (int j = 0; j < k; ++j) dst[j] = src[j];
}

}  // namespace

extern "C" int mapsdi_radix_partition(
    const void* data, const void* count, int n, int k, int n_buckets,
    int cap_bucket, int shift, int n_key, unsigned long long key_lo,
    unsigned long long key_hi, void* block_scratch, void* raw_counts,
    void* out, int device, void* stream) {
  cudaSetDevice(device);
  cudaStream_t s = (cudaStream_t)stream;
  const Keys keys{n_key, key_lo, key_hi};
  const int n_blocks = (n + kThreads - 1) / kThreads;
  const int32_t* x = (const int32_t*)data;
  const int32_t* cnt = (const int32_t*)count;
  int32_t* scratch = (int32_t*)block_scratch;
  rp_hist<<<n_blocks, kThreads, (n_buckets + 1) * sizeof(int), s>>>(
      x, cnt, n, k, n_buckets, shift, keys, scratch);
  rp_scan<<<n_buckets, kScanThreads, 0, s>>>(scratch, n_blocks, n_buckets,
                                             (int32_t*)raw_counts);
  rp_scatter<<<n_blocks, kThreads, kWarps * (n_buckets + 1) * sizeof(int),
               s>>>(x, cnt, n, k, n_buckets, cap_bucket, shift, keys,
                    scratch, (int32_t*)out);
  return (int)cudaGetLastError();
}
