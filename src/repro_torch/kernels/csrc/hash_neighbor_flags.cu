// Fused hash + sorted-neighbour flags over hash-sorted rows[N, K] int32:
//   hash[i]    — the row hash (uint32 value in an int64),
//   keep[i]    — 1 iff row i differs from row i-1 in hash or content
//                (row 0 always 1),
//   collide[i] — 1 iff hash[i] == hash[i-1] but the rows differ
//                (row 0 always 0).
//
// Replaces the TPU kernel hash_neighbor_flags_pallas
// (src/repro/kernels/rowhash/rowhash.py). On the TPU each tile compared its
// first row against a boundary row gathered outside the kernel; here each
// thread reads rows i and i-1 straight from device memory, so the boundary
// gather disappears.
//
// What bounds it on the card: bytes. Row i is read once from device memory
// (row i-1 is the neighbouring thread's row and comes from L1/L2), and
// 16 bytes of flags and hash are written per row. The predecessor's hash
// is recomputed rather than exchanged through shared memory: the integer
// work stays well under the memory time, and no block boundary needs
// special handling.
#include "mapsdi_hash.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void hash_flags_kernel(const int32_t* __restrict__ rows,
                                  long long n, int k,
                                  int64_t* __restrict__ hash,
                                  int32_t* __restrict__ keep,
                                  int32_t* __restrict__ collide) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* row = rows + i * k;
  uint32_t h = mapsdi_row_hash(row, k);
  int kp = 1, cl = 0;
  if (i > 0) {
    const int32_t* prev = row - k;
    uint32_t hp = mapsdi_row_hash(prev, k);
    bool row_eq = true;
    for (int j = 0; j < k; ++j) row_eq &= (row[j] == prev[j]);
    bool hash_eq = (h == hp);
    kp = !(hash_eq && row_eq);
    cl = hash_eq && !row_eq;
  }
  hash[i] = (int64_t)h;
  keep[i] = kp;
  collide[i] = cl;
}

}  // namespace

extern "C" int mapsdi_hash_neighbor_flags(const void* rows, void* hash,
                                          void* keep, void* collide,
                                          long long n, int k, int device,
                                          void* stream) {
  cudaSetDevice(device);
  if (n > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    hash_flags_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
        (const int32_t*)rows, n, k, (int64_t*)hash, (int32_t*)keep,
        (int32_t*)collide);
  }
  return (int)cudaGetLastError();
}
