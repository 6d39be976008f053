// Gathers inside 32-bit tiles, for Hopper (sm_90a).
//
// Replaces the Pallas probe kernels that gather inside a VMEM tile:
// scripts/probe_pallas.py k_gather_lanes / k_gather_rows / k_gather_table
// (pallas_call at :34), scripts/probe_pallas2.py k_gl / k_gr (:26),
// scripts/probe_pallas3.py kg (:55), kt (:70) and the amplified
// k_gather1 / k_gather0 loops (:86).  Two forms:
//
// * tile form: x and idx are [tiles * rows, lanes]; each tile of `rows`
//   rows is gathered on its own, take_along_axis(h, idx, axis), and the
//   gather repeats `steps` times as h = take(h, idx) + add (mod 2^32);
// * table form: out[i] = table[idx[i]] from a flat table of at most
//   kGroup words.
//
// The payload is 32 bits moved as bits, so int32, uint32 and float32 take
// the same path (`add` is an integer add on the word).  An index out of
// range stops the kernel with a trap, as torch.gather's device assert
// does; the kernel never reads outside its group.
//
// What bounds it: shared-memory traffic.  A gather along lanes mixes only
// inside a row and one along rows only inside a column of the tile, so a
// block owns a group that closes under the gather (whole rows, or a strip
// of whole columns of one tile), loads it and its indices into shared
// memory once, runs every step there and writes the group back once.
// Device memory is touched 12 bytes a word per call, whatever `steps`.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;
constexpr int kGroup = 4096;  // words of one block's resident group
constexpr int kPer = kGroup / kThreads;

struct Group {
  long long row0;  // first row of the group
  int col0;        // first column
  int nr, nc;      // group shape, rows x columns
};

// Axis 1: groups of gr whole rows.  Axis 0: groups of gc columns of one
// tile of `rows` rows, `strips` groups per tile.
__device__ Group group_of(long long n_rows, int rows, int lanes, int axis,
                          int gr, int gc, int strips) {
  Group g;
  if (axis == 1) {
    g.row0 = (long long)blockIdx.x * gr;
    g.col0 = 0;
    g.nr = (int)min((long long)gr, n_rows - g.row0);
    g.nc = lanes;
  } else {
    const long long tile = blockIdx.x / strips;
    g.row0 = tile * rows;
    g.col0 = (int)(blockIdx.x % strips) * gc;
    g.nr = rows;
    g.nc = min(gc, lanes - g.col0);
  }
  return g;
}

__global__ void __launch_bounds__(kThreads)
gather_tiles(const uint32_t* __restrict__ x, const int32_t* __restrict__ idx,
             uint32_t* __restrict__ out, long long n_rows, int rows,
             int lanes, int axis, int gr, int gc, int strips, int steps,
             uint32_t add) {
  __shared__ uint32_t val[kGroup];
  __shared__ int32_t src[kGroup];  // each word's source inside the group
  const Group g = group_of(n_rows, rows, lanes, axis, gr, gc, strips);
  const int n = g.nr * g.nc;
  const int bound = axis == 1 ? g.nc : g.nr;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / g.nc, c = e % g.nc;
    const long long at = (g.row0 + r) * lanes + g.col0 + c;
    const int i = idx[at];
    if ((unsigned)i >= (unsigned)bound) __trap();
    val[e] = x[at];
    src[e] = axis == 1 ? r * g.nc + i : i * g.nc + c;
  }
  __syncthreads();
  uint32_t v[kPer];
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (e < n) v[j] = val[src[e]] + add;
    }
    __syncthreads();  // every read of this step before any write
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (e < n) val[e] = v[j];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / g.nc, c = e % g.nc;
    out[(g.row0 + r) * lanes + g.col0 + c] = val[e];
  }
}

__global__ void __launch_bounds__(kThreads)
gather_table(const uint32_t* __restrict__ table, int n_table,
             const int32_t* __restrict__ idx, long long n,
             uint32_t* __restrict__ out) {
  __shared__ uint32_t t[kGroup];
  for (int e = threadIdx.x; e < n_table; e += kThreads) t[e] = table[e];
  __syncthreads();
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    const int j = idx[i];
    if ((unsigned)j >= (unsigned)n_table) __trap();
    out[i] = t[j];
  }
}

}  // namespace

extern "C" {

const char* tile_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int tile_gather_group() { return kGroup; }

// x, idx, out: [n_rows, lanes] 32-bit words on the device, n_rows a
// multiple of `rows` for axis 0; the index range is [0, lanes) for axis 1
// and [0, rows) for axis 0.  Needs lanes <= kGroup (axis 1) or
// rows <= kGroup (axis 0), and steps >= 1.
int tile_gather_launch(const void* x, const void* idx, void* out,
                       long long n_rows, int rows, int lanes, int axis,
                       int steps, unsigned int add, void* stream) {
  if (n_rows <= 0 || lanes <= 0 || steps < 1) return (int)cudaErrorInvalidValue;
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
  gather_tiles<<<(unsigned)blocks, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<uint32_t*>(out), n_rows, rows, lanes, axis, gr, gc, strips,
      steps, (uint32_t)add);
  return (int)cudaGetLastError();
}

// table: n_table <= kGroup words; idx, out: n words.
int tile_gather_table_launch(const void* table, int n_table, const void* idx,
                             long long n, void* out, void* stream) {
  if (n_table <= 0 || n_table > kGroup || n <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long per_block = (long long)kThreads * 8;
  const long long blocks = std::min((n + per_block - 1) / per_block, 4096LL);
  gather_table<<<(unsigned)blocks, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), n_table,
      static_cast<const int32_t*>(idx), n, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
