// Packed 2-bit words -> k-mer keys in one pass, for Hopper (sm_90a): the
// wire of rows (wire_keys) and the phase-major word stream (stream_keys).
//
// wire_keys replaces the device work that XLA fused on the TPU and that
// the JAX package wrote with no Pallas kernel: kmer_tpu/native.py
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
// stream_keys replaces the XLA fusion of kmer_tpu/ops/extract.py
// extract_from_words (:155), canonicalize (:133) and phase_major_valid
// (:181), as kmer_tpu/bench.py:262 and :319 compose them.  In: a flat
// stream of nw uint32 words (reads of read_len bases laid back to back).
// Out: keys [16, nw], keys[r * nw + w] the window at base p = 16w + r
// (windows past the stream's end read zero words), and valid[r * nw + w]
// says p % read_len <= read_len - k and p <= n_reads * read_len - k.
//
// What bounds both: bytes.  A window costs 8 bytes of key written (9 with
// the valid byte) and 0.25-0.3 bytes of words read; its arithmetic is a
// few dozen integer operations.  So the design spends nothing but the
// stores:
// * A block stages its words into shared memory with coalesced loads:
//   wire_keys a run of whole rows (contiguous in memory), whose windows
//   are contiguous in the output too; stream_keys a run of kStreamWords
//   words and the two after it, whose windows are a run of each of the 16
//   output rows.
// * window_key (window_key.cuh) computes a window from three words; words
//   past a row's nw read as zero, so the length column is never read as
//   bases (and nothing past the last row is read).
// * Threads take pairs of consecutive slots aligned to 16 bytes of the
//   output, so a warp stores 512 contiguous bytes, 16 a thread; a pair cut
//   by the block's (or the array's, or an output row's) edge stores its
//   one slot alone.  wire_keys' output may be any 8-byte-aligned view (a
//   slice of a caller's flat buffer).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "window_key.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerBlock = 4096;  // windows a block writes, at least one row
constexpr int kMaxStaged = 8192;      // wire words a block stages (32 KB)
constexpr int kStreamWords = 512;     // stream words a block (8,192 slots)
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
      kv[h] = kmer::window_key(row, nw, i, k, mask, canonical != 0);
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

// one block: stream words w0 .. w0 + kStreamWords - 1, the windows that
// start in them, in each of the 16 phase rows
__global__ void __launch_bounds__(kThreads)
stream_keys_kernel(const uint32_t* __restrict__ words, long long nw, int k,
                   int canonical, long long read_len, long long last,
                   unsigned long long* __restrict__ keys,
                   uint8_t* __restrict__ valid) {
  __shared__ uint32_t staged[kStreamWords + 2];
  const long long w0 = (long long)blockIdx.x * kStreamWords;
  const int n = nw - w0 < kStreamWords ? (int)(nw - w0) : kStreamWords;
  const int nws = nw - w0 < kStreamWords + 2 ? (int)(nw - w0)
                                             : kStreamWords + 2;
  for (int t = threadIdx.x; t < nws; t += kThreads) {
    staged[t] = __ldg(words + w0 + t);
  }
  __syncthreads();

  const unsigned long long mask = ~0ULL << (64 - 2 * k);
  const int lead = (int)((reinterpret_cast<uintptr_t>(keys) >> 3) & 1);
  // p % read_len in 32 bits where the stream's positions allow it
  const bool narrow = 16 * (nw + 1) < (1LL << 32) && read_len < (1LL << 32);
  for (int r = 0; r < 16; ++r) {
    const long long e0 = r * nw + w0;  // the row's first slot in the block
    const long long q0 = (e0 + lead) >> 1;
    const int pairs = (int)(((e0 + n - 1 + lead) >> 1) - q0 + 1);
    for (int p = threadIdx.x; p < pairs; p += kThreads) {
      const long long g = 2 * (q0 + p) - lead;  // the pair's first slot
      const int l = (int)(g - e0);              // its word in the block
      unsigned long long kv[2] = {0ull, 0ull};
      bool ok[2] = {false, false};
      // slot l's base (slot l + 1's is 16 on), and the first written
      // slot's offset in its read
      const long long pos = 16 * (w0 + l) + r;
      const long long at = l >= 0 ? pos : pos + 16;
      long long rem = narrow ? (long long)((unsigned)at % (unsigned)read_len)
                             : at % read_len;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (l + h < 0 || l + h >= n) continue;
        if (h == 1 && l >= 0) {
          rem += 16;
          if (rem >= read_len) rem %= read_len;
        }
        kv[h] = kmer::window_key(staged, nws, 16 * (l + h) + r, k, mask,
                                 canonical != 0);
        ok[h] = rem <= read_len - k && pos + 16 * h <= last;
      }
      const bool first = l >= 0, second = l + 1 < n;
      if (first && second) {
        *reinterpret_cast<ulonglong2*>(keys + g) =
            make_ulonglong2(kv[0], kv[1]);
      } else if (first) {
        keys[g] = kv[0];
      } else {
        keys[g + 1] = kv[1];
      }
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

// words: nw 32-bit words on the device; keys: 16 * nw int64, 8-byte
// aligned; valid: 16 * nw bytes.  Needs 1 <= k <= 32, read_len >= 1 and
// n_reads >= 0.
int stream_keys_launch(const void* words, long long nw, int k, int canonical,
                       long long read_len, long long n_reads, void* keys,
                       void* valid, void* stream) {
  if (nw <= 0 || k < 1 || k > 32 || read_len < 1 || n_reads < 0 ||
      valid == nullptr || (reinterpret_cast<uintptr_t>(keys) & 7)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = (nw + kStreamWords - 1) / kStreamWords;
  stream_keys_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nw, k, canonical, read_len,
      n_reads * read_len - k, static_cast<unsigned long long*>(keys),
      static_cast<uint8_t*>(valid));
  return (int)cudaGetLastError();
}

}  // extern "C"
