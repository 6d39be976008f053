// Wire -> k-mer keys in one pass, for Hopper (sm_90a).
//
// Replaces the device work that XLA fused on the TPU and that the JAX
// package wrote with no Pallas kernel: kmer_tpu/native.py
// device_unpack_rows (:188), kmer_tpu/ops/extract.py extract_windows_batch
// (:63) and canonicalize (:133), as kmer_tpu/pipeline.py:79-85 composes
// them for every batch.
//
// In: the uploaded wire, [n_rows, ncols] uint32 words; a row's first
// nw = ceil(width / 16) words hold its bases, base j at bits
// 30 - 2 * (j % 16) of word j / 16, and with `with_len` the last column
// holds the row's length.  Out: for window i < m = width - k + 1 of row b,
// keys[b * m + i] is the left-aligned key of bases i .. i + k - 1
// (canonicalized, the unsigned minimum of the key and its reverse
// complement, when asked), and with `with_len`, valid[b * m + i] says
// i <= length - k.  Every slot, valid or not, holds what the plain version
// (unpack, extract, canonicalize) computes from the same words.
//
// What bounds it: bytes.  A window costs 8 bytes of key written (9 with
// the valid byte) and about 0.3 bytes of wire read; its arithmetic is a
// few dozen integer operations.  So the design spends nothing but the
// stores:
// * A block stages the wire rows of a run of whole rows (contiguous in
//   memory) into shared memory with coalesced loads, and writes their
//   windows, which are contiguous in the output too.
// * Window i of a row is the 64 bits that start 2i bits into the row's
//   word stream: w = i / 16, r = i % 16,
//   ((w_w << 32 | w_{w+1}) << 2r | w_{w+2} >> (32 - 2r)) & top_mask(k).
//   Words past the row's nw read as zero, so the length column is never
//   read as bases (and nothing past the last row is read).
// * The reverse complement is ~key, __brevll, a swap of the two bits of
//   each pair, << (64 - 2k) (no shift at k = 32); the canonical key is
//   the unsigned minimum, compared as unsigned long long.
// * Threads take pairs of consecutive slots aligned to 16 bytes of the
//   output, so a warp stores 512 contiguous bytes, 16 a thread; a pair cut
//   by the block's (or the array's) edge stores its one slot alone.  The
//   output may be any 8-byte-aligned view (a slice of a caller's flat
//   buffer).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerBlock = 4096;  // windows a block writes, at least one row
constexpr int kMaxStaged = 8192;      // wire words a block stages (32 KB)
constexpr unsigned long long kLowBits = 0x5555555555555555ULL;

// the key of window i of a staged row of nw base words
__device__ __forceinline__ unsigned long long window_key(
    const uint32_t* row, int nw, int i, int k, unsigned long long mask,
    bool canonical) {
  const int w = i >> 4;
  const int sh = 2 * (i & 15);
  const unsigned long long w0 = row[w];
  const unsigned long long w1 = w + 1 < nw ? row[w + 1] : 0u;
  const unsigned long long w2 = w + 2 < nw ? row[w + 2] : 0u;
  const unsigned long long key =
      ((((w0 << 32) | w1) << sh) | ((w2 << sh) >> 32)) & mask;
  if (!canonical) return key;
  unsigned long long rc = __brevll(~key);          // bits reversed
  rc = ((rc >> 1) & kLowBits) | ((rc & kLowBits) << 1);  // pairs restored
  if (k < 32) rc <<= 64 - 2 * k;
  return rc < key ? rc : key;
}

// one block: `rows_per_block` rows from row0, their windows
__global__ void __launch_bounds__(kThreads)
wire_keys_kernel(const uint32_t* __restrict__ wire, long long n_rows,
                 int ncols, int nw, int m, int k, int canonical,
                 int rows_per_block, unsigned long long* __restrict__ keys,
                 uint8_t* __restrict__ valid) {
  extern __shared__ uint32_t staged[];
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int rows = n_rows - row0 < rows_per_block ? (int)(n_rows - row0)
                                                  : rows_per_block;
  const uint32_t* src = wire + row0 * ncols;
  for (int t = threadIdx.x; t < rows * ncols; t += kThreads) {
    staged[t] = __ldg(src + t);
  }
  __syncthreads();

  const unsigned long long mask = ~0ULL << (64 - 2 * k);
  const long long e0 = row0 * m;  // the block's first slot
  const int n = rows * m;         // its slots
  // pair q holds slots 2q - lead and 2q - lead + 1, 16-byte aligned
  const int lead = (int)((reinterpret_cast<uintptr_t>(keys) >> 3) & 1);
  const long long q0 = (e0 + lead) >> 1;
  const int pairs = (int)(((e0 + n - 1 + lead) >> 1) - q0 + 1);
  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    const long long g = 2 * (q0 + p) - lead;  // the pair's first slot
    const int l = (int)(g - e0);              // its place in the block, >= -1
    int r = l < 0 ? 0 : l / m;
    int i = l < 0 ? 0 : l - r * m;
    unsigned long long kv[2] = {0ull, 0ull};
    bool ok[2] = {false, false};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && l >= 0 && ++i == m) {  // the second slot, next row?
        i = 0;
        ++r;
      }
      if (l + h < 0 || l + h >= n) continue;
      const uint32_t* row = staged + r * ncols;
      kv[h] = window_key(row, nw, i, k, mask, canonical != 0);
      if (valid != nullptr) ok[h] = (long long)i <= (long long)row[nw] - k;
    }
    const bool first = l >= 0, second = l + 1 < n;
    if (first && second) {
      *reinterpret_cast<ulonglong2*>(keys + g) = make_ulonglong2(kv[0], kv[1]);
    } else if (first) {
      keys[g] = kv[0];
    } else {
      keys[g + 1] = kv[1];
    }
    if (valid != nullptr) {
      if (first) valid[g] = ok[0];
      if (second) valid[g + 1] = ok[1];
    }
  }
}

}  // namespace

extern "C" {

const char* wire_keys_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// wire: [n_rows, ncols] 32-bit words on the device, ncols = ceil(width /
// 16) + with_len; keys: n_rows * (width - k + 1) int64, 8-byte aligned;
// valid: as many bytes when with_len, else null.  Needs 1 <= k <= 32,
// k <= width and ncols <= kMaxStaged.
int wire_keys_launch(const void* wire, long long n_rows, int ncols,
                     int width, int k, int canonical, int with_len,
                     void* keys, void* valid, void* stream) {
  const int nw = (width + 15) / 16;
  if (n_rows <= 0 || k < 1 || k > 32 || width < k ||
      ncols != nw + (with_len ? 1 : 0) || ncols > kMaxStaged ||
      (with_len != 0) != (valid != nullptr) ||
      (reinterpret_cast<uintptr_t>(keys) & 7)) {
    return (int)cudaErrorInvalidValue;
  }
  const int m = width - k + 1;
  const long long rows = std::max(
      1, std::min(kSlotsPerBlock / m, kMaxStaged / ncols));
  const long long blocks = (n_rows + rows - 1) / rows;
  wire_keys_kernel<<<(unsigned)blocks, kThreads,
                     (size_t)(rows * ncols) * sizeof(uint32_t),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(wire), n_rows, ncols, nw, m, k, canonical,
      (int)rows, static_cast<unsigned long long*>(keys),
      static_cast<uint8_t*>(valid));
  return (int)cudaGetLastError();
}

}  // extern "C"
