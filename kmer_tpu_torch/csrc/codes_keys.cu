// 2-bit codes -> k-mer keys in one pass, for Hopper (sm_90a).
//
// Replaces the device work that XLA fused on the TPU and that the JAX
// package wrote with no Pallas kernel: kmer_tpu/ops/extract.py
// extract_windows_batch (:63) and canonicalize (:133), as
// kmer_tpu/ops/count.py, kmer_tpu/ops/dense_count.py and
// kmer_tpu/parallel/dist.py (:57-89, the halo'd block) compose them.
//
// In: codes [n_rows, L] uint8, contiguous (any byte offset), and lengths
// [n_rows] (int32 or int64).  Out: for window i < m = L - k + 1 of row b,
// keys[b * m + i] = OR over j < k of codes[b][i + j] << (62 - 2j), mod
// 2^64 (canonicalized, the unsigned minimum of the key and its reverse
// complement, when asked), and valid[b * m + i] says i <= lengths[b] - k.
// Every slot, valid or not, holds what the plain version computes from
// the same bytes, codes above 3 included.
//
// What bounds it: bytes.  A window costs 8 bytes of key and 1 of valid
// written and about L / m bytes of codes read; its arithmetic is a few
// dozen integer operations.  So the design spends nothing but the stores:
// * A block takes kSlotsPerBlock consecutive output slots, which may span
//   many short rows or be a piece of one long row.  The codes they read
//   are one contiguous byte range of the input (row b's windows read only
//   row b), so the block stages that range, from the 16-byte boundary at
//   or before its first byte, into shared memory as 2-bit words, 16 codes
//   a word: a thread loads 16 bytes (one load where all 16 lie in the
//   range, byte loads at its two ends) and packs them.  Its shared memory
//   is at most (rows spanned) * (k - 1) + kSlotsPerBlock codes / 16
//   words: 32 KB at m = 1, k = 32; 1.2 KB at L = 150, k = 21.
// * Window (b, i) is then the window that starts at byte b * L + i of
//   the staged stream, and window_key (window_key.cuh) computes it from
//   three staged words.
// * A code above 3 does not fit two bits.  The staging ORs every byte of
//   the range; if any has a bit above the low two, the whole block takes
//   the plain formula, k bytes a window from device memory (no producer
//   on the count paths makes such codes; it keeps every slot exact).
// * Threads take pairs of consecutive slots aligned to 16 bytes of the
//   output, so a warp stores 512 contiguous bytes, 16 a thread, as
//   wire_keys does; the output may be any 8-byte-aligned view.

#include <cuda_runtime.h>
#include <stdint.h>

#include "window_key.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlotsPerBlock = 4096;

// the 2-bit codes of 4 bytes (byte 0 lowest) as 8 bits, byte 0 highest
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  const uint32_t t = x & 0x03030303u;
  return ((t << 6) | (t >> 4) | (t >> 14) | (t >> 24)) & 0xFFu;
}

__global__ void __launch_bounds__(kThreads)
codes_keys_kernel(const uint8_t* __restrict__ codes, long long n_slots,
                  int L, int m, int k, int canonical,
                  const void* __restrict__ lengths, int lengths64,
                  unsigned long long* __restrict__ keys,
                  uint8_t* __restrict__ valid) {
  extern __shared__ uint32_t staged[];
  const long long e0 = (long long)blockIdx.x * kSlotsPerBlock;
  const int n = n_slots - e0 < kSlotsPerBlock ? (int)(n_slots - e0)
                                              : kSlotsPerBlock;
  const long long r0 = e0 / m;  // the block's first row and window
  const int i0 = (int)(e0 - r0 * m);
  const long long e1 = e0 + n - 1;  // its last
  const long long r1 = e1 / m;
  const int i1 = (int)(e1 - r1 * m);
  // the codes it reads: [lo, hi) as addresses; staged word 0 starts at a0
  const uintptr_t lo = reinterpret_cast<uintptr_t>(codes) + r0 * L + i0;
  const uintptr_t hi = reinterpret_cast<uintptr_t>(codes) + r1 * L + i1 + k;
  const uintptr_t a0 = lo & ~(uintptr_t)15;
  const int nws = (int)((hi - a0 + 15) >> 4);
  uint32_t seen = 0;  // every byte of the range, ORed
  for (int w = threadIdx.x; w < nws; w += kThreads) {
    const uintptr_t a = a0 + 16 * (uintptr_t)w;
    uint32_t word = 0;
    if (a >= lo && a + 16 <= hi) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(a));
      seen |= v.x | v.y | v.z | v.w;
      word = pack4(v.x) << 24 | pack4(v.y) << 16 | pack4(v.z) << 8 |
             pack4(v.w);
    } else {
      for (int j = 0; j < 16; ++j) {
        if (a + j >= lo && a + j < hi) {
          const uint32_t c = __ldg(reinterpret_cast<const uint8_t*>(a + j));
          seen |= c;
          word |= (c & 3u) << (30 - 2 * j);
        }
      }
    }
    staged[w] = word;
  }
  const bool wide = __syncthreads_or((seen & 0xFCFCFCFCu) != 0);

  const unsigned long long mask = ~0ULL << (64 - 2 * k);
  const int skew = (int)(lo - a0);  // staged position of (r0, i0)
  // pair q holds slots 2q - lead and 2q - lead + 1, 16-byte aligned
  const int lead = (int)((reinterpret_cast<uintptr_t>(keys) >> 3) & 1);
  const long long q0 = (e0 + lead) >> 1;
  const int pairs = (int)(((e0 + n - 1 + lead) >> 1) - q0 + 1);
  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    const long long g = 2 * (q0 + p) - lead;  // the pair's first slot
    const int l = (int)(g - e0);              // its place in the block, >= -1
    // (row - r0, window) of slot l, from one division and a step; slot -1
    // reads as window i0 - 1 of row r0, so that the step gives slot 0
    int dr = l < 0 ? 0 : (i0 + l) / m;
    int i = l < 0 ? i0 - 1 : i0 + l - dr * m;
    unsigned long long kv[2] = {0ull, 0ull};
    bool ok[2] = {false, false};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && ++i == m) {  // the second slot, next row?
        i = 0;
        ++dr;
      }
      if (l + h < 0 || l + h >= n) continue;
      const long long b = r0 + dr;
      if (!wide) {
        kv[h] = kmer::window_key(staged, nws, dr * L + i - i0 + skew, k,
                                 mask, canonical != 0);
      } else {  // the plain formula, codes above 3 and all
        const uint8_t* c = codes + b * L + i;
        unsigned long long key = 0;
        for (int j = 0; j < k; ++j) {
          key |= (unsigned long long)__ldg(c + j) << (62 - 2 * j);
        }
        kv[h] = canonical ? kmer::canonical_key(key, k) : key;
      }
      const long long len =
          lengths64 ? __ldg(static_cast<const long long*>(lengths) + b)
                    : (long long)__ldg(static_cast<const int*>(lengths) + b);
      ok[h] = (long long)i <= len - k;
    }
    const bool first = l >= 0, second = l + 1 < n;
    if (first && second) {
      *reinterpret_cast<ulonglong2*>(keys + g) = make_ulonglong2(kv[0], kv[1]);
    } else if (first) {
      keys[g] = kv[0];
    } else {
      keys[g + 1] = kv[1];
    }
    if (first) valid[g] = ok[0];
    if (second) valid[g + 1] = ok[1];
  }
}

}  // namespace

extern "C" {

const char* codes_keys_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// codes: [n_rows, L] bytes on the device; lengths: n_rows int32
// (lengths64 = 0) or int64 (1); keys: n_rows * (L - k + 1) int64, 8-byte
// aligned; valid: as many bytes.  Needs 1 <= k <= 32 and k <= L.
int codes_keys_launch(const void* codes, long long n_rows, int L, int k,
                      int canonical, const void* lengths, int lengths64,
                      void* keys, void* valid, void* stream) {
  if (n_rows <= 0 || k < 1 || k > 32 || L < k || lengths == nullptr ||
      valid == nullptr || (reinterpret_cast<uintptr_t>(keys) & 7)) {
    return (int)cudaErrorInvalidValue;
  }
  const int m = L - k + 1;
  const long long n_slots = n_rows * m;
  // the most staged words a block needs: rows spanned R <= (m - 1 +
  // kSlotsPerBlock - 1) / m past the first, (R + 1) * (k - 1) +
  // kSlotsPerBlock codes, and up to 15 bytes before the range
  const long long spanned = (m - 1 + kSlotsPerBlock - 1) / m;
  const long long bytes = (spanned + 1) * (k - 1) + kSlotsPerBlock;
  const size_t smem = (size_t)((bytes + 15 + 15) / 16) * sizeof(uint32_t);
  const long long blocks = (n_slots + kSlotsPerBlock - 1) / kSlotsPerBlock;
  codes_keys_kernel<<<(unsigned)blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n_slots, L, m, k, canonical,
      lengths, lengths64, static_cast<unsigned long long*>(keys),
      static_cast<uint8_t*>(valid));
  return (int)cudaGetLastError();
}

}  // extern "C"
