// Row hash: [N, K] int32 -> [N] hash (the uint32 value, zero-extended into
// an int64 so the port's single-key sorts can take it directly).
//
// Replaces the TPU kernel rowhash_pallas
// (src/repro/kernels/rowhash/rowhash.py), which hashed (block_n, K) tiles
// resident in VMEM with the K-column mix unrolled.
//
// What bounds it on the card: bytes. Each row is read once (4*K bytes) and
// one 8-byte hash is written; the ~11 integer operations per column are far
// below the card's integer rate. Design: one thread per row, a loop over
// the K columns in registers, no shared memory. Neighbouring threads read
// neighbouring rows, so a warp's loads cover one contiguous 128*K-byte
// stretch that L1 serves in full cache lines.
#include "mapsdi_hash.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void rowhash_kernel(const int32_t* __restrict__ x, long long n,
                               int k, int64_t* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = (int64_t)mapsdi_row_hash(x + i * k, k);
}

}  // namespace

extern "C" int mapsdi_rowhash(const void* x, void* out, long long n, int k,
                              int device, void* stream) {
  cudaSetDevice(device);
  if (n > 0) {
    long long blocks = (n + kThreads - 1) / kThreads;
    rowhash_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)x, n, k, (int64_t*)out);
  }
  return (int)cudaGetLastError();
}
