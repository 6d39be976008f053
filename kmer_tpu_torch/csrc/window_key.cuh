// One k-mer window from 2-bit words, shared by wire_keys.cu (the packed
// wire and the phase-major word stream) and codes_keys.cu (codes packed
// into words in shared memory).
//
// Words hold 16 bases each, base j at bits 30 - 2 * (j % 16) of word
// j / 16.  Window i is the 64 bits that start 2i bits into the words:
// w = i / 16, r = i % 16,
// ((w_w << 32 | w_{w+1}) << 2r | w_{w+2} >> (32 - 2r)) & top_mask(k),
// where words at or past nw read as zero.  Its reverse complement is
// ~key, __brevll, a swap of the two bits of each pair, << (64 - 2k) (no
// shift at k = 32, where a shift by 64 is undefined); the canonical key
// is the unsigned minimum, compared as unsigned long long so that keys
// with bit 63 set (a leading t) order last.

#pragma once

#include <stdint.h>

namespace kmer {

constexpr unsigned long long kLowBits = 0x5555555555555555ULL;

// the reverse complement of a left-aligned key of length k
__device__ __forceinline__ unsigned long long revcomp_key(
    unsigned long long key, int k) {
  unsigned long long rc = __brevll(~key);                // bits reversed
  rc = ((rc >> 1) & kLowBits) | ((rc & kLowBits) << 1);  // pairs restored
  if (k < 32) rc <<= 64 - 2 * k;
  return rc;
}

__device__ __forceinline__ unsigned long long canonical_key(
    unsigned long long key, int k) {
  const unsigned long long rc = revcomp_key(key, k);
  return rc < key ? rc : key;
}

// the key of window i of nw words; mask = the top 2k bits
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
  return canonical ? canonical_key(key, k) : key;
}

}  // namespace kmer
