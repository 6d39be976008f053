// Segment counts over a sorted int64 key stream, for Hopper (sm_90a).
//
// Replaces the Pallas kernel kmer_tpu/pallas/segment_counts.py (_kernel,
// called through segment_counts_sorted).  For keys sorted so that equal
// keys are adjacent, it writes each equal-key segment's size at the
// segment's TAIL slot and 0 elsewhere; slots equal to an optional
// sentinel key get 0 and are left out of n_unique, the number of live
// segments.  The output matches the Pallas kernel slot for slot.
//
// The Pallas kernel walks its grid in order and carries the running
// segment-head position from block to block in SMEM.  Blocks on a GPU
// run in no order, so the carry becomes a scan across tiles, in three
// launches:
//   1. tile_summary: per tile, the last segment-head position in the tile
//      (heads are i == 0 or key[i] != key[i-1]) and its live-head count;
//   2. tile_carry (one block): an exclusive max-scan of the tile maxima,
//      which is the head position carried into each tile, and the sum of
//      the live-head counts, which is n_unique;
//   3. tile_counts: per tile, the inclusive max-scan of head positions
//      seeded with the carry; at each live tail, count = i - head + 1.
// Head positions only grow with i, so "the last head at or before i" is
// a running max, and a segment of any length costs nothing extra (a
// backward search from each tail would be quadratic in it).
//
// What bounds it: memory.  Passes 1 and 3 each read the keys (8 bytes a
// slot) and pass 3 writes the counts (4 bytes a slot): at the main path's
// ~147M slots that is ~2.9 GB, on the order of 1 ms at the card's
// 3.35 TB/s.  Pass 2 touches 8 bytes per 4096-slot tile.  Each thread
// owns 16 consecutive slots, so the neighbour compares stay in registers;
// coalescing the loads through shared memory is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kCarryThreads = 1024;

// Exclusive max-scan of one int per thread across the block (identity
// -1).  Every thread of the block must call it; blockDim.x is a multiple
// of 32.
__device__ int block_exclusive_max(int v) {
  __shared__ int warp_inclusive[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = max(x, y);
  }
  if (lane == 31) warp_inclusive[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    int w = lane < nwarps ? warp_inclusive[lane] : -1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = max(w, y);
    }
    warp_inclusive[lane] = w;
  }
  __syncthreads();
  int before_lane = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) before_lane = -1;
  const int before_warp = warp > 0 ? warp_inclusive[warp - 1] : -1;
  __syncthreads();  // the shared array is reused by the next call
  return max(before_warp, before_lane);
}

// Max and sum of one value per thread across the block; the result is
// valid in thread 0.
__device__ void block_max_sum(int& mx, long long& sum) {
  __shared__ int warp_max[32];
  __shared__ long long warp_sum[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    mx = max(mx, __shfl_down_sync(0xffffffffu, mx, o));
    sum += __shfl_down_sync(0xffffffffu, sum, o);
  }
  if (lane == 0) {
    warp_max[warp] = mx;
    warp_sum[warp] = sum;
  }
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    mx = lane < nwarps ? warp_max[lane] : -1;
    sum = lane < nwarps ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mx = max(mx, __shfl_down_sync(0xffffffffu, mx, o));
      sum += __shfl_down_sync(0xffffffffu, sum, o);
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
tile_summary(const long long* __restrict__ keys, long long n,
             int has_sentinel, long long sentinel,
             int* __restrict__ tile_max, int* __restrict__ tile_live) {
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  int mx = -1;
  long long live = 0;
  long long prev = (base > 0 && base < n) ? keys[base - 1] : 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j;
    if (i < n) {
      const long long key = keys[i];
      if (i == 0 || key != prev) {
        mx = (int)i;
        live += !(has_sentinel && key == sentinel);
      }
      prev = key;
    }
  }
  block_max_sum(mx, live);
  if (threadIdx.x == 0) {
    tile_max[blockIdx.x] = mx;
    tile_live[blockIdx.x] = (int)live;
  }
}

// One block.  In place: tile_max[t] becomes the largest head position in
// tiles before t (-1 for t == 0).
__global__ void __launch_bounds__(kCarryThreads)
tile_carry(int* __restrict__ tile_max, const int* __restrict__ tile_live,
           int ntiles, int* __restrict__ n_unique) {
  const int per = (ntiles + blockDim.x - 1) / blockDim.x;
  const int lo = min(ntiles, (int)threadIdx.x * per);
  const int hi = min(ntiles, lo + per);
  int mx = -1;
  long long live = 0;
  for (int t = lo; t < hi; ++t) {
    mx = max(mx, tile_max[t]);
    live += tile_live[t];
  }
  int run = block_exclusive_max(mx);
  for (int t = lo; t < hi; ++t) {
    const int m = tile_max[t];
    tile_max[t] = run;
    run = max(run, m);
  }
  block_max_sum(mx, live);
  if (threadIdx.x == 0) *n_unique = (int)live;
}

__global__ void __launch_bounds__(kThreads)
tile_counts(const long long* __restrict__ keys, long long n,
            int has_sentinel, long long sentinel,
            const int* __restrict__ carry, int* __restrict__ counts) {
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  long long k[kItems];
  const long long before = (base > 0 && base < n) ? keys[base - 1] : 0;
  const long long after = (base + kItems < n) ? keys[base + kItems] : 0;
  int mx = -1;
  long long prev = before;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j;
    k[j] = i < n ? keys[i] : 0;
    if (i < n && (i == 0 || k[j] != prev)) mx = (int)i;
    prev = k[j];
  }
  int head = max(carry[blockIdx.x], block_exclusive_max(mx));
  prev = before;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j;
    if (i < n) {
      if (i == 0 || k[j] != prev) head = (int)i;
      const long long next = j + 1 < kItems ? k[j + 1] : after;
      const bool tail = i == n - 1 || k[j] != next;
      const bool live = !(has_sentinel && k[j] == sentinel);
      counts[i] = (tail && live) ? (int)(i - head + 1) : 0;
    }
    prev = k[j];
  }
}

}  // namespace

extern "C" {

int segment_counts_tile() { return kTile; }

const char* segment_counts_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// keys: n sorted int64 on the device (0 < n < 2^31); counts: n int32;
// n_unique: one int32; scratch: 2 * ceil(n / kTile) int32.  Launches on
// `stream` without synchronising; returns cudaGetLastError().
int segment_counts_launch(const void* keys, long long n, int has_sentinel,
                          long long sentinel, void* counts, void* n_unique,
                          void* scratch, void* stream) {
  const int ntiles = (int)((n + kTile - 1) / kTile);
  int* tile_max = static_cast<int*>(scratch);
  int* tile_live = tile_max + ntiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* k = static_cast<const long long*>(keys);
  tile_summary<<<ntiles, kThreads, 0, s>>>(k, n, has_sentinel, sentinel,
                                           tile_max, tile_live);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_carry<<<1, kCarryThreads, 0, s>>>(tile_max, tile_live, ntiles,
                                         static_cast<int*>(n_unique));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_counts<<<ntiles, kThreads, 0, s>>>(k, n, has_sentinel, sentinel,
                                          tile_max, static_cast<int*>(counts));
  return (int)cudaGetLastError();
}

}  // extern "C"
