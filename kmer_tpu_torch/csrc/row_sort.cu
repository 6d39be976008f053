// Ascending sort of every row of a uint32 tile, for Hopper (sm_90a).
//
// Replaces the Pallas probe kernel scripts/probe_pallas2.py k_sort
// (jnp.sort(x, axis=1) on a [64, 128] VMEM tile; pallas_call at :26).
//
// A bitonic network in shared memory: a block of kThreads threads holds
// kThreads / width rows, one word a thread, and runs the log2(width) *
// (log2(width) + 1) / 2 compare-exchange steps with a barrier after each.
// Row width is a power of two up to kThreads (the probe's is 128).
//
// What bounds it: the barriers and shared-memory traffic of the 28 steps
// (width 128); device memory is read and written once.  Keeping a row in
// one warp's registers with shuffles would drop the barriers; that is
// later work if a sort is built on it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
sort_rows(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
          long long n_rows, int width) {
  __shared__ uint32_t s[kThreads];
  const int t = threadIdx.x;
  const long long row = (long long)blockIdx.x * (kThreads / width) + t / width;
  const int i = t % width;  // position inside the row
  const bool live = row < n_rows;
  s[t] = live ? x[row * width + i] : 0xFFFFFFFFu;
  __syncthreads();
  for (int k = 2; k <= width; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int p = t ^ j;  // j < width: the partner is in the same row
      if (p > t) {
        const bool up = (i & k) == 0;
        const uint32_t a = s[t], b = s[p];
        if ((a > b) == up) {
          s[t] = b;
          s[p] = a;
        }
      }
      __syncthreads();
    }
  }
  if (live) out[row * width + i] = s[t];
}

}  // namespace

extern "C" {

const char* row_sort_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x, out: [n_rows, width] uint32 on the device; width a power of two
// <= kThreads.
int row_sort_launch(const void* x, void* out, long long n_rows, int width,
                    void* stream) {
  if (n_rows <= 0 || width <= 0 || width > kThreads || (width & (width - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const int per_block = kThreads / width;
  const long long blocks = (n_rows + per_block - 1) / per_block;
  sort_rows<<<(unsigned)blocks, kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), n_rows,
      width);
  return (int)cudaGetLastError();
}

}  // extern "C"
