// Roll-and-combine stage loops on 32-bit tiles, for Hopper (sm_90a).
//
// Replaces the Pallas probe kernels that loop stages over a VMEM tile:
// scripts/probe_pallas.py k_dynroll (pallas_call at :34) and k_vpu (:113);
// scripts/probe_pallas2.py k_dr (:26), k_roll_lanes, k_ptpu_roll_lanes,
// k_roll_rows, k_concat_rows (:89) and k_roll_rows1 (:143);
// scripts/probe_pallas3.py k0 (:32) and k_cmpex1, k_cmpex1r, k_add (:86);
// scripts/probe_r2.py k_cmpex (:150) and k_cmpex0 (:164).
//
// x is [n_rows, lanes] (one lane h, or two lanes h and l); each tile of
// `rows` rows is worked on its own.  Stage s computes
//   partner = roll(x, shift[s], axis)      (np.roll: element i takes
//                                           element i - shift, mod len)
// and then one op:
//   take2:    (h, l) = the lexicographic min of (h, l) and its partner,
//             unsigned (the cmpex probes);
//   min:      h = min(partner, h);
//   min_add1: h = min(partner, h) + 1, mod 2^32;
//   add1:     h = h + 1, no partner;
//   copy:     h = partner (the dynamic roll).
// concat([h[d:], h[:d]]) is a shift of -d.  The shift schedule is an
// int32 array on the device: the dynamic roll reads its one shift there,
// as the TPU kernel read it from SMEM, never from the host.
//
// What bounds it: shared-memory traffic and the barriers between stages.
// A roll along lanes mixes only inside a row and one along rows only
// inside a column of the tile, so a block owns a group that closes under
// the roll (whole rows, or a strip of whole columns of one tile) and keeps
// it resident for every stage: each thread holds its words in registers,
// publishes them to shared memory, and reads its partner there.  Device
// memory is touched once in and once out per call, whatever the number of
// stages, so a rate measures the exchange, not the memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 1024;
constexpr int kGroup = 4096;  // words per lane of one block's resident group
constexpr int kPer = kGroup / kThreads;

enum Op { kTake2 = 0, kMin = 1, kMinAdd1 = 2, kAdd1 = 3, kCopy = 4 };

__global__ void __launch_bounds__(kThreads)
stage_loop(const uint32_t* __restrict__ xh, const uint32_t* __restrict__ xl,
           uint32_t* __restrict__ oh, uint32_t* __restrict__ ol,
           const int32_t* __restrict__ shifts, int n_stages, int op,
           long long n_rows, int rows, int lanes, int axis, int gr, int gc,
           int strips) {
  __shared__ uint32_t sh[kGroup];
  __shared__ uint32_t sl[kGroup];
  // the group: gr whole rows (axis 1) or gc columns of one tile (axis 0)
  long long row0;
  int col0, nr, nc;
  if (axis == 1) {
    row0 = (long long)blockIdx.x * gr;
    col0 = 0;
    nr = (int)min((long long)gr, n_rows - row0);
    nc = lanes;
  } else {
    row0 = (long long)(blockIdx.x / strips) * rows;
    col0 = (int)(blockIdx.x % strips) * gc;
    nr = rows;
    nc = min(gc, lanes - col0);
  }
  const int n = nr * nc;
  const int len = axis == 1 ? nc : nr;  // the roll's length
  const bool two = op == kTake2;
  uint32_t h[kPer], l[kPer];
  int r[kPer], c[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    r[j] = e / nc;
    c[j] = e % nc;
    h[j] = l[j] = 0u;
    if (e < n) {
      const long long at = (row0 + r[j]) * lanes + col0 + c[j];
      h[j] = xh[at];
      l[j] = two ? xl[at] : 0u;
    }
  }
  for (int s = 0; s < n_stages; ++s) {
    if (op == kAdd1) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) h[j] += 1u;
      continue;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (e < n) {
        sh[e] = h[j];
        if (two) sl[e] = l[j];
      }
    }
    __syncthreads();
    int d = __ldg(shifts + s) % len;
    if (d < 0) d += len;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (e >= n) continue;
      int p;
      if (axis == 1) {
        const int cc = c[j] >= d ? c[j] - d : c[j] - d + len;
        p = r[j] * nc + cc;
      } else {
        const int rr = r[j] >= d ? r[j] - d : r[j] - d + len;
        p = rr * nc + c[j];
      }
      const uint32_t ph = sh[p];
      if (op == kTake2) {
        const uint32_t pl = sl[p];
        if (ph < h[j] || (ph == h[j] && pl < l[j])) {
          h[j] = ph;
          l[j] = pl;
        }
      } else if (op == kMin) {
        h[j] = min(ph, h[j]);
      } else if (op == kMinAdd1) {
        h[j] = min(ph, h[j]) + 1u;
      } else {  // kCopy
        h[j] = ph;
      }
    }
    __syncthreads();  // every read of this stage before the next stage's writes
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = threadIdx.x + j * kThreads;
    if (e < n) {
      const long long at = (row0 + r[j]) * lanes + col0 + c[j];
      oh[at] = h[j];
      if (two) ol[at] = l[j];
    }
  }
}

}  // namespace

extern "C" {

const char* tile_stages_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int tile_stages_group() { return kGroup; }

// xh, oh (and xl, ol for op take2): [n_rows, lanes] uint32 on the device;
// shifts: n_stages int32 on the device.  Axis 0 rolls inside tiles of
// `rows` rows (n_rows a multiple of rows, rows <= kGroup); axis 1 rolls
// along whole rows (lanes <= kGroup).
int tile_stages_launch(const void* xh, const void* xl, void* oh, void* ol,
                       const void* shifts, int n_stages, int op,
                       long long n_rows, int rows, int lanes, int axis,
                       void* stream) {
  if (n_rows <= 0 || lanes <= 0 || n_stages < 0 || op < kTake2 ||
      op > kCopy || (op == kTake2 && (xl == nullptr || ol == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  int gr = 1, gc = lanes, strips = 1;
  long long blocks;
  if (axis == 1) {
    if (lanes > kGroup) return (int)cudaErrorInvalidValue;
    gr = kGroup / lanes;
    blocks = (n_rows + gr - 1) / gr;
  } else if (axis == 0) {
    if (rows <= 0 || rows > kGroup || n_rows % rows) {
      return (int)cudaErrorInvalidValue;
    }
    gc = std::min(lanes, kGroup / rows);
    strips = (lanes + gc - 1) / gc;
    blocks = (n_rows / rows) * strips;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  stage_loop<<<(unsigned)blocks, kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(xh), static_cast<const uint32_t*>(xl),
      static_cast<uint32_t*>(oh), static_cast<uint32_t*>(ol),
      static_cast<const int32_t*>(shifts), n_stages, op, n_rows, rows, lanes,
      axis, gr, gc, strips);
  return (int)cudaGetLastError();
}

}  // extern "C"
