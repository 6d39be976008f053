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
// does; the kernel never reads outside a word's line (or the table).
//
// What bounds it: bytes (each word and index read once, each word written
// once), and at the probes' small shapes the latency of one launch.
// * One step, and the table form (every probe but the amplified loops):
//   a gather straight from device memory, as torch.gather does: a thread
//   takes four consecutive words (one 16-byte index load and one 16-byte
//   store where aligned) and reads each source through the read-only
//   cache; 128-thread blocks spread the probes' 8,192 words over 16 SMs
//   and larger shapes over the card.  No shared memory, no barrier.
// * More steps compose.  `add` is the same for every word, so after s
//   steps h[p] = h0[idx^s(p)] + s * add (mod 2^32), where idx^s is the
//   s-fold composition of the index map inside the word's line.  A block
//   holds a group of whole lines (rows on axis 1; a strip of columns of
//   one tile on axis 0) with each word's source in registers, and builds
//   idx^s by repeated squaring: bit_length(s) - 1 squarings and
//   popcount(s) - 1 products, each one gather of indices through a
//   shared-memory slice (two slices alternate: one barrier a gather),
//   then one gather of the words.  128 steps cost 8 gathers, not 128: a
//   step-by-step gather through shared memory is held to about a quarter
//   of the INT32 throughput by the bank conflicts of random indices
//   (about 3.5 wavefronts a 32-word load) plus the store that publishes
//   each step.  Groups are sized to fill the card, with row pieces of at
//   least 8 words (one 32-byte sector) on axis 0 where the tile allows.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kGroup = 4096;          // longest line; most words a block holds
constexpr int kMaxThreads = 256;      // threads of a composing block
constexpr int kDirectThreads = 128;   // threads of a one-step block
constexpr int kTargetGroup = 1024;    // words a composing block aims at

enum Form { kAxis0 = 0, kAxis1 = 1, kTable = 2 };

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

// a / b with 32-bit arithmetic where a fits
__device__ __forceinline__ long long div_ll(long long a, int b) {
  return a < (1LL << 32) ? (long long)((unsigned)a / (unsigned)b) : a / b;
}

// --- one step and the table: straight from device memory ----------------

// word e's source: the table at i, its row at i (axis 1), or row i of its
// tile, same column (axis 0); c is e's column and row its row
__device__ __forceinline__ long long source(int form, long long e,
                                            long long row, int c, int i,
                                            int lanes, int rows) {
  if (form == kTable) return i;
  if (form == kAxis1) return e - c + i;
  return (row - row % rows + i) * lanes + c;
}

// out[e] = x[source of e] + add; with kVec four consecutive words of one
// row a thread (n, and lanes for the tile forms, multiples of 4; idx and
// out 16-byte aligned)
template <bool kVec>
__global__ void __launch_bounds__(kDirectThreads)
gather_direct(const uint32_t* __restrict__ x, const int32_t* __restrict__ idx,
              uint32_t* __restrict__ out, long long n, int lanes, int rows,
              int form, int bound, uint32_t add) {
  constexpr int kW = kVec ? 4 : 1;
  const long long e0 =
      ((long long)blockIdx.x * kDirectThreads + threadIdx.x) * kW;
  if (e0 >= n) return;
  int iv[kW];
  if constexpr (kVec) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(idx + e0));
    iv[0] = v.x, iv[1] = v.y, iv[2] = v.z, iv[3] = v.w;
  } else {
    iv[0] = __ldg(idx + e0);
  }
  const long long row = form == kTable ? 0 : div_ll(e0, lanes);
  const int c0 = (int)(e0 - row * lanes);
  uint32_t ov[kW];
#pragma unroll
  for (int h = 0; h < kW; ++h) {
    if ((unsigned)iv[h] >= (unsigned)bound) __trap();
    ov[h] = __ldg(x + source(form, e0 + h, row, c0 + h, iv[h], lanes, rows)) +
            add;
  }
  if constexpr (kVec) {
    *reinterpret_cast<uint4*>(out + e0) = make_uint4(ov[0], ov[1], ov[2],
                                                     ov[3]);
  } else {
    out[e0] = ov[0];
  }
}

// --- more steps: composed on chip ---------------------------------------

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

// Group word e = r * nc + c sits in register e / blockDim.x of thread
// e % blockDim.x; kP registers a thread hold a group of up to
// kP * blockDim.x words.  Two shared slices of that size alternate.
template <int kP>
__global__ void __launch_bounds__(kMaxThreads)
gather_composed(const uint32_t* __restrict__ x,
                const int32_t* __restrict__ idx, uint32_t* __restrict__ out,
                long long n_rows, int rows, int lanes, int axis, int gr,
                int gc, int strips, int steps, uint32_t add) {
  extern __shared__ uint32_t slices[];
  const int nt = blockDim.x;
  const int cap = kP * nt;
  const Group g = group_of(n_rows, rows, lanes, axis, gr, gc, strips);
  const int n = g.nr * g.nc;
  const int bound = axis == 1 ? g.nc : g.nr;
  uint32_t pw[kP], res[kP], val[kP];  // idx^(2^b), idx^(steps so far), h0
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const int e = threadIdx.x + j * nt;
    pw[j] = res[j] = val[j] = 0u;  // past n: any index inside the slice
    if (e < n) {
      const int r = e / g.nc, c = e - r * g.nc;
      const long long at = (g.row0 + r) * lanes + g.col0 + c;
      const int i = __ldg(idx + at);
      if ((unsigned)i >= (unsigned)bound) __trap();
      val[j] = __ldg(x + at);
      pw[j] = axis == 1 ? r * g.nc + i : i * g.nc + c;
    }
  }
  // res = idx^steps, from the lowest bit of steps up
  int s = steps, cur = 0;
  bool have = false;
  for (;;) {
    const bool bit = s & 1;
    s >>= 1;
    const bool product = bit && have;
    if (bit && !have) {
#pragma unroll
      for (int j = 0; j < kP; ++j) res[j] = pw[j];
      have = true;
    }
    if (!product && s == 0) break;
    uint32_t* b = slices + cur * cap;
#pragma unroll
    for (int j = 0; j < kP; ++j) b[threadIdx.x + j * nt] = pw[j];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      if (product) res[j] = b[res[j]];
      if (s) pw[j] = b[pw[j]];
    }
    cur ^= 1;  // the other slice was last read before this barrier
    if (s == 0) break;
  }
  uint32_t* b = slices + cur * cap;
#pragma unroll
  for (int j = 0; j < kP; ++j) b[threadIdx.x + j * nt] = val[j];
  __syncthreads();
  const uint32_t total = add * (uint32_t)steps;
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const int e = threadIdx.x + j * nt;
    if (e < n) {
      const int r = e / g.nc, c = e - r * g.nc;
      out[(g.row0 + r) * lanes + g.col0 + c] = b[res[j]] + total;
    }
  }
}

template <int kP>
cudaError_t launch_composed(const void* x, const void* idx, void* out,
                            long long n_rows, int rows, int lanes, int axis,
                            int gr, int gc, int strips, long long blocks,
                            int threads, int steps, uint32_t add,
                            cudaStream_t stream) {
  gather_composed<kP><<<(unsigned)blocks, threads,
                        2 * kP * threads * sizeof(uint32_t), stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const int32_t*>(idx),
      static_cast<uint32_t*>(out), n_rows, rows, lanes, axis, gr, gc, strips,
      steps, add);
  return cudaGetLastError();
}

cudaError_t launch_direct(const void* x, const void* idx, void* out,
                          long long n, int lanes, int rows, int form,
                          int bound, uint32_t add, cudaStream_t stream) {
  const bool vec = n % 4 == 0 && (form == kTable || lanes % 4 == 0) &&
                   aligned16(idx) && aligned16(out);
  const long long threads = vec ? n / 4 : n;
  const unsigned blocks =
      (unsigned)((threads + kDirectThreads - 1) / kDirectThreads);
  const auto* xs = static_cast<const uint32_t*>(x);
  const auto* is = static_cast<const int32_t*>(idx);
  auto* os = static_cast<uint32_t*>(out);
  if (vec) {
    gather_direct<true><<<blocks, kDirectThreads, 0, stream>>>(
        xs, is, os, n, lanes, rows, form, bound, add);
  } else {
    gather_direct<false><<<blocks, kDirectThreads, 0, stream>>>(
        xs, is, os, n, lanes, rows, form, bound, add);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tile_gather_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// x, idx, out: [n_rows, lanes] 32-bit words on the device, n_rows a
// multiple of `rows` for axis 0; the index range is [0, lanes) for axis 1
// and [0, rows) for axis 0.  Needs lanes <= kGroup (axis 1) or
// rows <= kGroup (axis 0), and steps >= 1.
int tile_gather_launch(const void* x, const void* idx, void* out,
                       long long n_rows, int rows, int lanes, int axis,
                       int steps, unsigned int add, void* stream) {
  if (n_rows <= 0 || lanes <= 0 || steps < 1 ||
      (axis == 1 && lanes > kGroup) ||
      (axis == 0 && (rows <= 0 || rows > kGroup || n_rows % rows)) ||
      (axis != 0 && axis != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  if (steps == 1) {
    return (int)launch_direct(x, idx, out, n_rows * lanes, lanes, rows,
                              axis == 1 ? kAxis1 : kAxis0,
                              axis == 1 ? lanes : rows, add, st);
  }
  // groups: about kTargetGroup words (axis 0: row pieces of 8 or more
  // words where the tile allows), halved while the card gets fewer than
  // two blocks an SM
  int gr = 1, gc = lanes, strips = 1;
  long long blocks;
  const long long want = 2LL * sm_count();
  if (axis == 1) {
    gr = std::max(1, kTargetGroup / lanes);
    while (gr > 1 && (n_rows + gr - 1) / gr < want) gr /= 2;
    blocks = (n_rows + gr - 1) / gr;
  } else {
    gc = std::min(lanes, std::max(1, std::min(kGroup / rows,
                                              std::max(8, kTargetGroup / rows))));
    while (gc > 1 && (n_rows / rows) * ((lanes + gc - 1) / gc) < want) gc /= 2;
    strips = (lanes + gc - 1) / gc;
    blocks = (n_rows / rows) * strips;
  }
  const int words = axis == 1 ? gr * lanes : rows * gc;
  const int threads = std::min(kMaxThreads, (words + 31) / 32 * 32);
  const int per = (words + threads - 1) / threads;
  const uint32_t a = (uint32_t)add;
  cudaError_t err;
  if (per <= 1) {
    err = launch_composed<1>(x, idx, out, n_rows, rows, lanes, axis, gr, gc,
                             strips, blocks, threads, steps, a, st);
  } else if (per <= 2) {
    err = launch_composed<2>(x, idx, out, n_rows, rows, lanes, axis, gr, gc,
                             strips, blocks, threads, steps, a, st);
  } else if (per <= 4) {
    err = launch_composed<4>(x, idx, out, n_rows, rows, lanes, axis, gr, gc,
                             strips, blocks, threads, steps, a, st);
  } else if (per <= 8) {
    err = launch_composed<8>(x, idx, out, n_rows, rows, lanes, axis, gr, gc,
                             strips, blocks, threads, steps, a, st);
  } else {
    err = launch_composed<16>(x, idx, out, n_rows, rows, lanes, axis, gr, gc,
                              strips, blocks, threads, steps, a, st);
  }
  return (int)err;
}

// table: n_table <= kGroup words; idx, out: n words.
int tile_gather_table_launch(const void* table, int n_table, const void* idx,
                             long long n, void* out, void* stream) {
  if (n_table <= 0 || n_table > kGroup || n <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch_direct(table, idx, out, n, 1, 1, kTable, n_table, 0u,
                            static_cast<cudaStream_t>(stream));
}

}  // extern "C"
