// Segment counts over a sorted int64 key stream, for Hopper (sm_90a).
//
// Replaces the Pallas kernel kmer_tpu/pallas/segment_counts.py (_kernel,
// called through segment_counts_sorted).  For keys sorted so that equal
// keys are adjacent, it writes each equal-key segment's size at the
// segment's TAIL slot and 0 elsewhere; slots equal to an optional
// sentinel key get 0 and are left out of n_unique, the number of live
// segments.  The output matches the Pallas kernel slot for slot.
//
// What bounds it: memory.  The least traffic is each key read once and
// each count written once, 12 bytes a slot: at the main path's 146.8M
// slots 1.76 GB, 0.526 ms at the card's 3.35 TB/s.  The work per slot is
// a neighbour compare and a subtraction, far below the issue rate.
//
// The design, one launch:
// - A persistent grid, two 512-thread blocks per SM, walks tiles of
//   kTile keys.  Thread 0 of a block stages each tile in shared memory
//   with one 1-D TMA bulk copy (cp.async.bulk, completion on an mbarrier)
//   into a ring of two buffers, so the block's next tile is in flight
//   while it counts one, and one block counts while the other waits at a
//   barrier.  The copy also brings the kHalo keys before the tile and the
//   key after it.  Bulk copies need 16-byte addresses and sizes: tiles
//   are laid on the 16-byte grid of the key pointer (`lead` is 1 when the
//   pointer is only 8-byte aligned), and a key left over at either end of
//   the array is loaded with a scalar load.
// - Warp w counts 8 rows of 32 consecutive slots; lane l reads slot
//   row * 32 + l, so a warp's shared-memory reads are consecutive words.
//   Heads and live tails come from neighbour compares as ballots; the
//   last head at or before a slot is the highest set bit of the row's head
//   ballot below the lane, else the last head of the rows before, else of
//   the warps before (one block-wide exchange), else of the tiles before.
// - Tiles are independent: no carry passes between them.  Equal keys are
//   adjacent, so only the tile that holds a segment's tail and not its
//   head needs the head, and only when the segment is live (the sentinel
//   run never is).  Its warp finds it by a backward search: the staged
//   halo first, then galloping probes 2^l slots back in device memory and
//   a 32-way search of the last interval, O(log L) reads.  One tile per
//   segment searches, so one segment spanning every tile costs one search.
// - Counts are staged in shared memory and written with 16-byte stores.
//   n_unique is the number of live tails: one atomicAdd per warp at the
//   end, into an int32 the caller zeroes (an integer sum, so the result
//   does not depend on order).
// Slot and byte offsets are 64-bit: tile * kTile * 8 overflows int32
// above 2^28 keys.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;  // rows of 32 slots per warp
constexpr int kTile = kWarps * kRows * 32;  // 4096 keys
constexpr int kHalo = 32;  // keys staged before the tile
constexpr int kStageKeys = kHalo + kTile + 2;  // + the key after, 16-B pad
constexpr int kStages = 2;
constexpr int kBlocksPerSM = 2;
constexpr size_t kStageBytes = (size_t)kStageKeys * 8;
constexpr size_t kSmemBytes =
    kStages * kStageBytes + (size_t)kTile * 4 + kStages * 8;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kStageBytes % 16 == 0, "stage buffers stay 16-byte aligned");
static_assert(kHalo % 2 == 0 && kTile % 4 == 0, "16-byte tile grid");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

struct Args {
  const long long* keys;  // slot 0
  long long n;
  int lead;  // 1 when keys is 8 bytes past a 16-byte boundary
  int has_sentinel;
  long long sentinel;
  int* counts;
  int* n_unique;
  long long ntiles;
};

// Tile t covers virtual positions v in [t * kTile, (t + 1) * kTile), where
// slot i sits at v = i + lead; its buffer holds v from t * kTile - kHalo.
__device__ void issue_tile(const Args& a, long long t, long long* buf,
                           uint64_t* bar) {
  const long long base = t * kTile - kHalo;
  const long long va = max((long long)a.lead, base);
  const long long vb = min(a.n + a.lead, t * kTile + kTile + 2);
  const long long ca = (va + 1) & ~1LL, cb = vb & ~1LL;
  if (va & 1) buf[va - base] = a.keys[va - a.lead];
  if ((vb & 1) && vb - 1 >= va) buf[vb - 1 - base] = a.keys[vb - 1 - a.lead];
  const uint32_t bytes = cb > ca ? (uint32_t)((cb - ca) * 8) : 0u;
  arrive_expect(bar, bytes);  // releases the scalar stores above
  if (bytes) bulk_load(buf + (ca - base), a.keys + (ca - a.lead), bytes, bar);
}

// The head slot of the segment that holds slot s, where s > 0 and
// keys[s - 1] == keys[s] == key.  halo[kHalo - 1 - l] holds slot s - 1 - l.
// Called by a whole warp; every lane returns the result.
__device__ long long search_head(const Args& a, const long long* halo,
                                 long long s, long long key) {
  const int lane = threadIdx.x & 31;
  const bool differs = s - 1 - lane < 0 || halo[kHalo - 1 - lane] != key;
  const unsigned m = __ballot_sync(kFull, differs);
  if (m) return s - (__ffs(m) - 1);
  // slots [s - 32, s) hold key: gallop back from s - 32 in device memory
  long long hi = s - 32;  // keys[hi] == key
  long long q = lane < 31 ? hi - (1LL << lane) : -1;
  const unsigned g = __ballot_sync(kFull, q < 0 || __ldg(a.keys + q) != key);
  const int l = __ffs(g) - 1;  // g has lane 31
  long long lo = __shfl_sync(kFull, q, l);  // keys[lo] != key, or lo == -1
  if (lo < 0) lo = -1;
  if (l > 0) hi -= 1LL << (l - 1);
  // 32-way search of (lo, hi]: matches form a suffix
  while (hi - lo > 1) {
    const long long step = (hi - lo + 31) / 32;
    q = lo + (long long)(lane + 1) * step;
    const unsigned b = __ballot_sync(kFull, q >= hi || __ldg(a.keys + q) == key);
    const int f = __ffs(b) - 1;  // lane 31 probes at or past hi
    const long long nhi = min(hi, lo + (long long)(f + 1) * step);
    lo += (long long)f * step;
    hi = nhi;
  }
  return hi;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
segment_counts_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  long long* stage = reinterpret_cast<long long*>(smem);
  int* cbuf = reinterpret_cast<int*>(smem + kStages * kStageBytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes + kTile * 4);
  __shared__ int warp_last[kWarps];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lane_le = (2u << lane) - 1u;  // lanes <= this one

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   ::"r"(smem_addr(full + s)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      const long long t = blockIdx.x + (long long)s * gridDim.x;
      if (t < a.ntiles) issue_tile(a, t, stage + s * kStageKeys, full + s);
    }
  }

  int unique = 0;
  for (long long k = 0;; ++k) {
    const long long t = blockIdx.x + k * gridDim.x;
    if (t >= a.ntiles) break;
    const int s = (int)(k % kStages);
    const long long* buf = stage + s * kStageKeys;
    const long long* tile = buf + kHalo;  // tile[p]: position p of the tile
    wait_parity(full + s, (uint32_t)((k / kStages) & 1));

    const long long i0 = t * kTile - a.lead;  // the slot at position 0
    const long long lo = max(0LL, i0), hi = min(a.n, i0 + kTile);

    // pass 1: head and live-tail ballots of the warp's rows
    unsigned hb[kRows], tb[kRows];
    const int first = warp * kRows * 32;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int p = first + r * 32 + lane;
      const long long i = i0 + p;
      const bool valid = i >= lo && i < hi;
      const long long key = tile[p];
      const bool head = valid && (i == 0 || key != tile[p - 1]);
      const bool tail = valid && (i == a.n - 1 || key != tile[p + 1]);
      const bool live = !(a.has_sentinel && key == a.sentinel);
      hb[r] = __ballot_sync(kFull, head);
      tb[r] = __ballot_sync(kFull, tail && live);
      unique += __popc(tb[r]);
    }
    int last = -1;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (hb[r]) last = first + r * 32 + 31 - __clz(hb[r]);
    if (lane == 0) warp_last[warp] = last;
    __syncthreads();

    // pass 2: counts at live tails into the staging buffer
    int run = lane < warp ? warp_last[lane] : -1;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) run = max(run, __shfl_xor_sync(kFull, run, o));
    long long searched = -1;  // head slot found by search_head
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int p = first + r * 32 + lane;
      const unsigned below = hb[r] & lane_le;
      const int hp = below ? first + r * 32 + 31 - __clz(below) : run;
      if (hb[r]) run = first + r * 32 + 31 - __clz(hb[r]);
      const bool tail = (tb[r] >> lane) & 1u;
      if (__any_sync(kFull, tail && hp < 0))  // the tile's first segment
        searched = search_head(a, buf, lo, tile[lo - i0]);
      const long long i = i0 + p;
      cbuf[p] = !tail ? 0 : hp >= 0 ? p - hp + 1 : (int)(i - searched + 1);
    }
    __syncthreads();  // the stage is read and the counts are staged

    if (threadIdx.x == 0 && t + (long long)kStages * gridDim.x < a.ntiles)
      issue_tile(a, t + (long long)kStages * gridDim.x,
                 stage + s * kStageKeys, full + s);

    // counts of slots [lo, hi): 16-byte stores, scalars at the ends
    const long long g0 = min((lo + 3) & ~3LL, hi), g1 = max(hi & ~3LL, g0);
    for (long long i = lo + threadIdx.x; i < g0; i += kThreads)
      a.counts[i] = cbuf[i - i0];
    for (long long i = g1 + threadIdx.x; i < hi; i += kThreads)
      a.counts[i] = cbuf[i - i0];
    for (long long g = g0 + 4LL * threadIdx.x; g < g1; g += 4LL * kThreads) {
      const int* c = cbuf + (g - i0);
      int4 v;
      if (a.lead == 0) {
        v = *reinterpret_cast<const int4*>(c);
      } else {
        v = make_int4(c[0], c[1], c[2], c[3]);
      }
      *reinterpret_cast<int4*>(a.counts + g) = v;
    }
  }
  if (lane == 0 && unique) atomicAdd(a.n_unique, unique);
}

}  // namespace

extern "C" {

int segment_counts_tile() { return kTile; }

const char* segment_counts_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// keys: n int64 on the device, equal keys adjacent (0 < n < 2^31), 8-byte
// aligned; counts: n int32, 16-byte aligned; n_unique: one int32 holding
// 0.  Launches on `stream` without synchronising; returns
// cudaGetLastError().
int segment_counts_launch(const void* keys, long long n, int has_sentinel,
                          long long sentinel, void* counts, void* n_unique,
                          void* stream) {
  static int prepared_device = -1, sms = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != prepared_device) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(segment_counts_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(segment_counts_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    prepared_device = device;
  }
  Args a;
  a.keys = static_cast<const long long*>(keys);
  a.n = n;
  a.lead = (int)((reinterpret_cast<uintptr_t>(keys) >> 3) & 1);
  a.has_sentinel = has_sentinel;
  a.sentinel = sentinel;
  a.counts = static_cast<int*>(counts);
  a.n_unique = static_cast<int*>(n_unique);
  a.ntiles = (n + a.lead + kTile - 1) / kTile;
  const long long slots = (long long)sms * kBlocksPerSM;
  const int grid = (int)(a.ntiles < slots ? a.ntiles : slots);
  segment_counts_kernel<<<grid, kThreads, kSmemBytes,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
