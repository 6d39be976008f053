// Dynamic-offset segment copies of 32-bit words, for Hopper (sm_90a).
//
//   out[out_off[g] : out_off[g] + seg] = in[in_off[g] : in_off[g] + seg]
//   for g < G, in order: where two destinations overlap, the later copy wins
//
// Replaces the Pallas probe kernels that issue dynamic-offset DMAs:
// scripts/probe_pallas2.py k_dma (pallas_call at :179),
// scripts/probe_pallas3.py k_dma (:151), scripts/probe_r3a.py make_copier
// (:160) and scripts/probe_r3b.py mk_static1d (:109), mk_dyn1d (:128),
// mk_loop1d (:153), mk_grid2d (:179) and mk_loop2d (:218).  A 2-D copy of
// row blocks is this copy with offsets and length times the row width.
//
// The TPU ran its grid in order; here every copy runs at once, across the
// card, and the caller's plan says whether two destinations overlap:
// * none overlap: the copies are independent, one block a copy, and the
//   result is the in-order one by construction.
// * some overlap: the last writer of each destination word is resolved
//   on the card, exactly, with an int32 owner map over the destination
//   (scratch from the caller).  The map is set to -1; every copy raises
//   owner[w] to its index over its words with atomicMax; then every copy
//   stores the words it owns.  A max does not depend on the order the
//   atomics land in, so the result is the same on every run.  Blocks take
//   the copies from the last one down, so most copies find a larger owner
//   already in place and skip the atomic (all copies at one offset cost
//   one read a word each, not a queue of atomics on one address).  Cost:
//   about 12 bytes a word on top of the copy.
//
// What bounds it: device memory, 8 bytes a word (read + write).  Offsets
// come from random draws, so source and destination are rarely 16-byte
// aligned together.  The independent path copies a segment as a scalar
// head up to the destination's 16-byte boundary, a body of 16-byte stores
// and a scalar tail.  Each body store takes its four words from the two
// aligned 16-byte source vectors that hold them (the second is the next
// lane's first, passed by shuffle): a select by the source's
// misalignment, uniform over the copy.  Those aligned vectors may reach up
// to three words past the segment's ends, never past the 16-byte line of
// a word inside it, so no load leaves a page the source occupies.  Where
// copies fill the card, a block of 64 threads a copy keeps four vectors a
// thread in flight at 1,024-word copies, so a copy's latency is not the
// limit; a few copies take 128 threads each.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <climits>

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;  // a block of the overlap path
constexpr int kUnroll = 4;     // loads in flight a thread
// a block of the independent path: 64 threads a copy where copies fill
// the card (more copies, so more bytes, in flight an SM), 128 where they
// are few and each copy's latency counts
constexpr int kCopyThreads = 64;
constexpr int kFewCopyThreads = 128;
constexpr long long kMaxBlocks = 1LL << 20;

__device__ __forceinline__ uint4 load4(const uint32_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ uint4 shfl_down4(uint4 v) {
  v.x = __shfl_down_sync(kFull, v.x, 1);
  v.y = __shfl_down_sync(kFull, v.y, 1);
  v.z = __shfl_down_sync(kFull, v.z, 1);
  v.w = __shfl_down_sync(kFull, v.w, 1);
  return v;
}

// The four words that start r words into the aligned pair (a, b).
__device__ __forceinline__ uint4 realign(uint4 a, uint4 b, int r) {
  switch (r) {
    case 0: return a;
    case 1: return make_uint4(a.y, a.z, a.w, b.x);
    case 2: return make_uint4(a.z, a.w, b.x, b.y);
    default: return make_uint4(a.w, b.x, b.y, b.z);
  }
}

// One copy of seg words by one block: scalar head and tail, 16-byte body.
// Body store j takes aligned source vectors A_j and A_{j+1}; lanes of a
// warp hold consecutive j, so A_{j+1} comes from the next lane by shuffle
// (the warp's last lane loads its own).
__device__ __forceinline__ void copy_segment(const uint32_t* __restrict__ s,
                                             uint32_t* __restrict__ d,
                                             long long seg) {
  // words before d's first 16-byte boundary (4-byte words throughout)
  const long long head =
      min(seg, (long long)((4 - (reinterpret_cast<uintptr_t>(d) >> 2)) & 3));
  const long long body = (seg - head) >> 2;  // 16-byte stores
  const long long tail = head + 4 * body;
  if (threadIdx.x < head) d[threadIdx.x] = __ldg(s + threadIdx.x);
  if (threadIdx.x < seg - tail) {
    d[tail + threadIdx.x] = __ldg(s + tail + threadIdx.x);
  }
  const uint32_t* sb = s + head;
  const int r = (int)((reinterpret_cast<uintptr_t>(sb) >> 2) & 3);
  const uint32_t* a0 = sb - r;  // 16-byte aligned
  uint4* db = reinterpret_cast<uint4*>(d + head);
  const int lane = threadIdx.x & 31;
  // the warp's vectors: the loop's bound is the same for its 32 lanes
  const int threads = blockDim.x;
  for (long long base = threadIdx.x - lane; base < body;
       base += kUnroll * threads) {
    uint4 a[kUnroll], b[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long j = base + k * threads + lane;
      // A_j, and A_body too where the source is misaligned
      a[k] = j < body || (j == body && r) ? load4(a0 + 4 * j)
                                          : make_uint4(0u, 0u, 0u, 0u);
      b[k] = lane == 31 && j < body && r ? load4(a0 + 4 * j + 4) : a[k];
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long j = base + k * threads + lane;
      if (r) {  // the same for the whole copy
        const uint4 next = shfl_down4(a[k]);
        if (lane != 31) b[k] = next;
      }
      if (j < body) db[j] = realign(a[k], b[k], r);
    }
  }
}

__global__ void __launch_bounds__(kFewCopyThreads)
copy_independent(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                 const long long* __restrict__ in_off,
                 const long long* __restrict__ out_off, long long seg,
                 long long n) {
  for (long long g = blockIdx.x; g < n; g += gridDim.x) {
    copy_segment(in + in_off[g], out + out_off[g], seg);
  }
}

// owner[w] = the largest g whose destination holds w (owner starts at -1)
__global__ void __launch_bounds__(kThreads)
claim_words(const long long* __restrict__ out_off, int* __restrict__ owner,
            long long seg, long long n) {
  for (long long b = blockIdx.x; b < n; b += gridDim.x) {
    const int g = (int)(n - 1 - b);  // the last copies first
    int* o = owner + out_off[g];
    for (long long i = threadIdx.x; i < seg; i += kThreads) {
      if (o[i] < g) atomicMax(o + i, g);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
copy_owned(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
           const long long* __restrict__ in_off,
           const long long* __restrict__ out_off,
           const int* __restrict__ owner, long long seg, long long n) {
  for (long long g = blockIdx.x; g < n; g += gridDim.x) {
    const uint32_t* s = in + in_off[g];
    const long long o = out_off[g];
    for (long long base = threadIdx.x; base < seg;
         base += kUnroll * kThreads) {
      bool mine[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long i = base + k * kThreads;
        mine[k] = i < seg && owner[o + i] == (int)g;
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long i = base + k * kThreads;
        if (mine[k]) out[o + i] = __ldg(s + i);
      }
    }
  }
}

}  // namespace

extern "C" {

const char* segment_copy_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// in, out: 32-bit words on the device, not sharing storage (checked by
// the caller); in_off, out_off: n int64 word offsets on the device, each
// copy inside its array (checked by the caller); seg >= 1 words a copy;
// n_out: out's words.  overlap: some destinations overlap, and owner is
// n_out int32 words of scratch on the device (else it is not read).
int segment_copy_launch(const void* in, void* out, const void* in_off,
                        const void* out_off, void* owner, long long seg,
                        long long n, long long n_out, int overlap,
                        void* stream) {
  if (seg <= 0 || n <= 0 ||
      (overlap && (owner == nullptr || n > INT_MAX || n_out <= 0))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* src = static_cast<const uint32_t*>(in);
  uint32_t* dst = static_cast<uint32_t*>(out);
  const long long* io = static_cast<const long long*>(in_off);
  const long long* oo = static_cast<const long long*>(out_off);
  const unsigned blocks = (unsigned)std::min(n, kMaxBlocks);
  if (!overlap) {
    int sms = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int threads = n >= 4LL * sms ? kCopyThreads : kFewCopyThreads;
    copy_independent<<<blocks, threads, 0, s>>>(src, dst, io, oo, seg, n);
    return (int)cudaGetLastError();
  }
  int* own = static_cast<int*>(owner);
  cudaError_t err = cudaMemsetAsync(own, 0xFF, 4 * n_out, s);  // -1 words
  if (err != cudaSuccess) return (int)err;
  claim_words<<<blocks, kThreads, 0, s>>>(oo, own, seg, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  copy_owned<<<blocks, kThreads, 0, s>>>(src, dst, io, oo, own, seg, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
