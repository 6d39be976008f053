// Dynamic-offset segment copies of 32-bit words, for Hopper (sm_90a).
//
//   out[out_off[g] : out_off[g] + seg] = in[in_off[g] : in_off[g] + seg]
//   for g < G
//
// Replaces the Pallas probe kernels that issue dynamic-offset DMAs:
// scripts/probe_pallas2.py k_dma (pallas_call at :179),
// scripts/probe_pallas3.py k_dma (:151), scripts/probe_r3a.py make_copier
// (:160) and scripts/probe_r3b.py mk_static1d (:109), mk_dyn1d (:128),
// mk_loop1d (:153), mk_grid2d (:179) and mk_loop2d (:218).  A 2-D copy of
// row blocks is this copy with offsets and length times the row width.
//
// Two modes:
// * grid: one block per copy, all in flight at once.  Blocks run in no
//   order, so the destinations must not overlap (the caller's plan checks
//   this and falls back to serial);
// * serial: one block walks the copies in order, with a barrier between
//   copies, so where destinations overlap the last copy wins, as on the
//   TPU, whose grid ran in order.  This keeps the probes' "serial issue"
//   meaning.
//
// What bounds it: device memory, 8 bytes a word (read + write), in grid
// mode; the one SM's load/store issue in serial mode.  Offsets come from
// random draws and are not 16-byte aligned, so every access is a scalar
// 4-byte one (neighbouring threads on neighbouring words, coalesced); an
// aligned vector body with scalar head and tail is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kGridThreads = 256;
constexpr int kSerialThreads = 1024;

__global__ void __launch_bounds__(kGridThreads)
copy_grid(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
          const long long* __restrict__ in_off,
          const long long* __restrict__ out_off, long long seg, long long n) {
  for (long long g = blockIdx.x; g < n; g += gridDim.x) {
    const uint32_t* s = in + in_off[g];
    uint32_t* d = out + out_off[g];
    for (long long i = threadIdx.x; i < seg; i += kGridThreads) d[i] = s[i];
  }
}

__global__ void __launch_bounds__(kSerialThreads)
copy_serial(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
            const long long* __restrict__ in_off,
            const long long* __restrict__ out_off, long long seg,
            long long n) {
  for (long long g = 0; g < n; ++g) {
    const uint32_t* s = in + in_off[g];
    uint32_t* d = out + out_off[g];
    for (long long i = threadIdx.x; i < seg; i += kSerialThreads) d[i] = s[i];
    __syncthreads();  // copy g's writes land before copy g + 1's
  }
}

}  // namespace

extern "C" {

const char* segment_copy_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// in, out: 32-bit words on the device; in_off, out_off: n int64 word
// offsets on the device, each copy inside its array (checked by the
// caller); seg >= 1 words a copy.
int segment_copy_launch(const void* in, void* out, const void* in_off,
                        const void* out_off, long long seg, long long n,
                        int serial, void* stream) {
  if (seg <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* src = static_cast<const uint32_t*>(in);
  uint32_t* dst = static_cast<uint32_t*>(out);
  const long long* io = static_cast<const long long*>(in_off);
  const long long* oo = static_cast<const long long*>(out_off);
  if (serial) {
    copy_serial<<<1, kSerialThreads, 0, s>>>(src, dst, io, oo, seg, n);
  } else {
    const long long blocks = std::min(n, 1LL << 20);
    copy_grid<<<(unsigned)blocks, kGridThreads, 0, s>>>(src, dst, io, oo, seg,
                                                        n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
