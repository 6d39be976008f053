// Ascending sort of every row of a [n_rows, width] tile, for Hopper
// (sm_90a): int64 keys in signed order, or 32-bit words in unsigned order.
//
// Replaces the Pallas probe kernel scripts/probe_pallas2.py k_sort
// (jnp.sort(x, axis=1) on a [64, 128] VMEM tile; pallas_call at :26), and
// sorts the rows of the sample-partition count engine
// (kmer_tpu_torch/probes/partition.py, after scripts/probe_r3c.py): rows
// of 2,048 to 16,384 int64 keys, the port's sign-flipped k-mer keys.
//
// Design: a block of kThreads threads sorts one tile of kThreads * E keys
// (E = 16 int64 keys or 32 words a thread: 16,384 keys or 32,768 words,
// 128 KiB), which holds one row or several whole rows.  The width limit
// is that tile, the widest power of two whose keys fit the 227 KiB of
// shared memory a block may opt into.  Where the rows fit one warp's
// tile and full blocks would leave SMs idle (the [64, 128] probe), a
// block is one warp, so a small sort spreads over the card.
//   1. The tile comes in with 16-byte loads, neighbouring threads on
//      neighbouring addresses, into dynamic shared memory, and each
//      thread takes its E consecutive keys into registers.
//   2. Each thread sorts its E keys in registers with a bitonic network
//      whose every stage sorts its blocks ascending (the first step of a
//      stage compares mirrored positions), so a row narrower than E is
//      sorted by the stages up to its width and the rows never mix.
//   3. Runs of E keys merge pairwise, level by level, up to the row's
//      width.  Each thread writes its keys to shared memory, finds where
//      its E outputs start in the pair of runs by a binary search on the
//      merge path, and merges E keys serially into its registers, so
//      every thread does the same work.  Where a pair of runs lies in one
//      warp's slice (up to 32 runs) the level needs only __syncwarp;
//      above, two block barriers a level (one buffer of 128 KiB is all
//      that fits, so the writes wait for the reads).
//   4. The sorted tile goes back through shared memory and out with
//      16-byte stores.  A row is read from device memory once and written
//      once.
// Shared memory holds one key of padding after every E keys, so a
// thread's E consecutive keys fall in different banks from its
// neighbours'.
//
// What bounds it: device memory at 8 bytes a key read and written once
// (2 x 1.09 GB for the engine's 136.3M keys, 0.651 ms at 3.35 TB/s) is
// the floor; shared memory sets the time above it: each merge level
// writes, searches and reads a tile's keys there.  probes/row_sort_levels.py
// times the kernel built to stop before its merge levels, after its
// in-warp ones, and whole, so the split is measured on the card.  Bitonic
// shuffles in place of the in-warp merge levels cost two shuffles an int64
// key and a compare network a level, and were slower in a trial, so every
// level takes the merge path.

#include <cuda_runtime.h>
#include <stdint.h>

// Merge levels stop at runs of this many keys: probes/row_sort_levels.py
// builds the kernel with a cap to time its parts; by default they run up
// to the row's width.
#ifndef ROW_SORT_MERGE_UNTIL
#define ROW_SORT_MERGE_UNTIL (1 << 30)
#endif

namespace {

constexpr int kThreads = 1024;  // a full block
constexpr int kWarp = 32;  // a block of one warp, for small sorts

template <typename K>
struct Keys;
template <>
struct Keys<int64_t> {  // the port's flipped keys: signed order
  static constexpr int kPerThread = 16;
  static __device__ __forceinline__ int64_t top() { return INT64_MAX; }
};
template <>
struct Keys<uint32_t> {  // 32-bit words: unsigned order
  static constexpr int kPerThread = 32;
  static __device__ __forceinline__ uint32_t top() { return 0xFFFFFFFFu; }
};

// the shared-memory slot of tile position p: one pad after every E keys
template <int E>
__device__ __forceinline__ int slot(int p) {
  return p + (int)((unsigned)p / E);
}

template <typename K>
__device__ __forceinline__ void order(K& a, K& b) {
  const K lo = b < a ? b : a;
  const K hi = b < a ? a : b;
  a = lo;
  b = hi;
}

// Sorts every block of min(width, E) consecutive keys of v ascending.
template <typename K, int E>
__device__ __forceinline__ void sort_registers(K (&v)[E], int width) {
#pragma unroll
  for (int k = 2; k <= E; k <<= 1) {
    if (k <= width) {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int m = i ^ (k - 1);  // the mirror inside the k-block
        if (m > i) order(v[i], v[m]);
      }
#pragma unroll
      for (int j = k >> 2; j > 0; j >>= 1) {
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int m = i ^ j;
          if (m > i) order(v[i], v[m]);
        }
      }
    }
  }
}

// One merge level: the runs of `run` keys at [g, g + run) and
// [g + run, g + 2 run) of the tile in shared memory merge, and this
// thread takes outputs [first, first + E) of the pair into v.
template <typename K, int E>
__device__ __forceinline__ void merge_level(const K* s, K (&v)[E], int first,
                                            int run) {
  const int g = first & ~(2 * run - 1);
  const int diag = first - g;
  const int b0 = g + run;
  int lo = max(0, diag - run), hi = min(diag, run);
  while (lo < hi) {  // keys taken from the first run before `first`
    const int mid = (lo + hi) >> 1;
    if (s[slot<E>(g + mid)] <= s[slot<E>(b0 + diag - 1 - mid)]) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int ia = lo, ib = diag - lo;
  K ka = ia < run ? s[slot<E>(g + ia)] : Keys<K>::top();
  K kb = ib < run ? s[slot<E>(b0 + ib)] : Keys<K>::top();
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const bool take_a = ib >= run || (ia < run && ka <= kb);
    v[i] = take_a ? ka : kb;
    if (take_a) {
      if (++ia < run) ka = s[slot<E>(g + ia)];
    } else {
      if (++ib < run) kb = s[slot<E>(b0 + ib)];
    }
  }
}

template <typename K>
union Vec16 {
  uint4 u;
  K k[16 / sizeof(K)];
};

template <typename K, int E, int THREADS>
__global__ void __launch_bounds__(THREADS, 1)
sort_rows(const K* __restrict__ x, K* __restrict__ out, long long n_keys,
          int width, int vec) {
  constexpr int T = THREADS * E;  // keys a tile
  constexpr int V = 16 / sizeof(K);  // keys a 16-byte vector
  extern __shared__ __align__(16) unsigned char smem[];
  K* s = reinterpret_cast<K*>(smem);
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * T;
  // whole rows: the tile is a multiple of the width, and so is n_keys
  const int live = (int)min((long long)T, n_keys - base);

  if (vec) {  // 16-byte aligned rows of a multiple of 16 bytes
    // all of a thread's loads in flight at once, then into shared memory
    constexpr int kLoads = T / V / THREADS;
    const uint4* src = reinterpret_cast<const uint4*>(x + base);
    Vec16<K> w[kLoads];
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
      const int c = t + m * THREADS;
      if (c * V < live) {
        w[m].u = __ldcs(src + c);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) w[m].k[j] = Keys<K>::top();
      }
    }
#pragma unroll
    for (int m = 0; m < kLoads; ++m) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s[slot<E>((t + m * THREADS) * V + j)] = w[m].k[j];
      }
    }
  } else {
    for (int p = t; p < T; p += THREADS) {
      s[slot<E>(p)] = p < live ? x[base + p] : Keys<K>::top();
    }
  }
  __syncthreads();

  K v[E];
  const int first = t * E;
  K* const mine = s + slot<E>(first);  // this thread's E keys, unbroken
#pragma unroll
  for (int i = 0; i < E; ++i) v[i] = mine[i];
  sort_registers<K, E>(v, width);

  for (int run = E; run < min(width, ROW_SORT_MERGE_UNTIL); run <<= 1) {
    const bool in_warp = 2 * run <= 32 * E;  // uniform across the block
    if (in_warp) __syncwarp(); else __syncthreads();
#pragma unroll
    for (int i = 0; i < E; ++i) mine[i] = v[i];
    if (in_warp) __syncwarp(); else __syncthreads();
    merge_level<K, E>(s, v, first, run);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < E; ++i) mine[i] = v[i];
  __syncthreads();

  if (vec) {
    uint4* dst = reinterpret_cast<uint4*>(out + base);
    for (int c = t; c * V < live; c += THREADS) {
      Vec16<K> w;
#pragma unroll
      for (int j = 0; j < V; ++j) w.k[j] = s[slot<E>(c * V + j)];
      __stcs(dst + c, w.u);
    }
  } else {
    for (int p = t; p < live; p += THREADS) out[base + p] = s[slot<E>(p)];
  }
}

// Launches blocks of THREADS threads, each on a tile of THREADS * E keys.
template <typename K, int THREADS>
int launch_tiles(const K* x, K* out, long long n_keys, int width, int vec,
                 cudaStream_t stream) {
  constexpr int E = Keys<K>::kPerThread;
  constexpr int T = THREADS * E;
  constexpr size_t smem = (size_t)(T + T / E) * sizeof(K);
  // once per process, outside any graph capture (the first launch)
  static const cudaError_t attr = cudaFuncSetAttribute(
      sort_rows<K, E, THREADS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const long long tiles = (n_keys + T - 1) / T;
  sort_rows<K, E, THREADS><<<(unsigned)tiles, THREADS, smem, stream>>>(
      x, out, n_keys, width, vec);
  return (int)cudaGetLastError();
}

template <typename K>
int launch(const void* x, void* out, long long n_rows, int width,
           void* stream) {
  constexpr int E = Keys<K>::kPerThread;
  if (n_rows <= 0 || width <= 0 || width > kThreads * E ||
      (width & (width - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const long long n_keys = n_rows * width;
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   ((long long)width * sizeof(K)) % 16 == 0);
  const K* in = static_cast<const K*>(x);
  K* dst = static_cast<K*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // rows that fit one warp's tile, too few to fill the card in full
  // blocks: one warp a block, so small row sorts spread over the SMs
  if (width <= kWarp * E && n_keys < (long long)sms * kThreads * E) {
    return launch_tiles<K, kWarp>(in, dst, n_keys, width, vec, st);
  }
  return launch_tiles<K, kThreads>(in, dst, n_keys, width, vec, st);
}

}  // namespace

extern "C" {

const char* row_sort_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The widest row, in keys, for keys of `key_bytes` (8 or 4).
int row_sort_max_width(int key_bytes) {
  return key_bytes == 8 ? kThreads * Keys<int64_t>::kPerThread
                        : kThreads * Keys<uint32_t>::kPerThread;
}

// x, out: [n_rows, width] on the device, int64 keys sorted as signed
// (key_bytes 8) or 32-bit words sorted as unsigned (key_bytes 4); width a
// power of two up to row_sort_max_width(key_bytes).
int row_sort_launch(const void* x, void* out, long long n_rows, int width,
                    int key_bytes, void* stream) {
  if (key_bytes == 8) return launch<int64_t>(x, out, n_rows, width, stream);
  if (key_bytes == 4) return launch<uint32_t>(x, out, n_rows, width, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
