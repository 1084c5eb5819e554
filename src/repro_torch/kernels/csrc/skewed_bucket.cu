// Skewed-hash bucket map (paper Algorithm 1) for Hopper (sm_90a), with a plain
// C interface.
//
// Replaces repro/kernels/skewed_bucket.py::skewed_bucket (the Pallas TPU
// kernel at src/repro/kernels/skewed_bucket.py:29, body _bucket_kernel :20):
//
//   r      = hash mod total        (floor-mod: r in [0, total) for any hash)
//   bucket = #{ e : cum[e] <= r }  (cum: inclusive prefix sums of capacities)
//
// Inputs: hashes (T,) int32 and cum (E,) int32, whose last element is the
// hash-space size total = sum(capacities). Output: (T,) int32 in [0, E):
// r < total = cum[E - 1], so the last prefix sum is never counted.
// The caller guarantees total > 0 (the wrapper checks it on the host before
// it launches); the kernel reads total from device memory, so the capacities
// may change between calls without a host sync in here.
//
// The TPU kernel keeps the prefix sums resident in VMEM and streams 1024-hash
// tiles through a broadcast compare and a row sum on the VPU. Here each thread
// maps ITEMS hashes, strided by the block width so that a warp's loads and
// stores stay coalesced, and each block walks cum in tiles of CUM_TILE
// entries staged in shared memory, adding each tile's count to the hashes'
// running counts: E, the executor count, is any size (PageRank's is 2, one
// tile). The count reads one shared address per step for the whole warp (a
// broadcast, no bank conflict). It counts, and does not binary-search, so the
// result equals the reference's row sum for any cum: capacities may be zero,
// so cum is only non-decreasing. CUDA's % truncates toward zero, so a
// negative remainder is lifted by total, as jnp.mod and np.mod do.
//
// Bound on an H100: bytes. Each hash is read once and each bucket written
// once, 8 B per hash: 38.8 MB at T = 4,847,571 (PageRank's vertex count),
// ~0.0116 ms at 3.35 TB/s. The E compares per hash are far below the integer
// rate, and a launch costs a few microseconds, the same order as the bound.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;             // threads per block
constexpr int ITEMS = 4;            // hashes per thread, NT apart
constexpr int CUM_TILE = 1024;      // prefix sums per shared-memory tile (4 KB)

__global__ void __launch_bounds__(NT)
skewed_bucket_kernel(const int* __restrict__ hashes, const int* __restrict__ cum,
                     int* __restrict__ out, long long t, int e) {
  __shared__ int s_cum[CUM_TILE];
  const int total = __ldg(cum + e - 1);

  const long long base = (long long)blockIdx.x * (NT * ITEMS) + threadIdx.x;
  int r[ITEMS], b[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {   // all loads first: ITEMS in flight
    const long long i = base + (long long)k * NT;
    r[k] = i < t ? __ldg(hashes + i) : 0;
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    r[k] %= total;
    if (r[k] < 0) r[k] += total;
    b[k] = 0;
  }
  // every thread walks every tile (the barriers), whether or not its hashes
  // lie past t
  for (int t0 = 0; t0 < e; t0 += CUM_TILE) {
    const int n = min(CUM_TILE, e - t0);
    if (t0 > 0) __syncthreads();      // the previous tile is read no more
    for (int j = threadIdx.x; j < n; j += NT) s_cum[j] = cum[t0 + j];
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const int c = s_cum[j];
#pragma unroll
      for (int k = 0; k < ITEMS; ++k) b[k] += c <= r[k];
    }
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + (long long)k * NT;
    if (i < t) out[i] = b[k];
  }
}

}  // namespace

extern "C" {

// hashes, cum and out: contiguous int32 on the current device; t hashes, e
// >= 1 buckets and cum[e - 1] > 0 (checked by the caller: the value lives on
// the device). Launches on `stream` and does not
// synchronise. Returns a cudaError_t: the launch's own error, or
// cudaErrorInvalidValue for sizes the kernel does not take.
int skewed_bucket_fwd(const int* hashes, const int* cum, int* out, long long t, int e,
                      void* stream) {
  if (t < 0 || e < 1) return (int)cudaErrorInvalidValue;
  if (t == 0) return (int)cudaSuccess;
  const long long blocks = (t + NT * ITEMS - 1) / (NT * ITEMS);
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  skewed_bucket_kernel<<<(unsigned)blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      hashes, cum, out, t, e);
  return (int)cudaGetLastError();
}

const char* skewed_bucket_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
