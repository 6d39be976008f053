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
// int32 array on the device, never read by the host, as the TPU kernel
// read its shifts from SMEM.  Each op compiles its own loop.
//
// add1 and copy compose: n stages of +1 are one add of n, mod 2^32, and
// k rolls are one roll by sum_s (shift_s mod len) mod len (each term
// reduced first, so no int32 sum overflows).  Each is one pass over
// memory with 16-byte accesses on enough blocks to fill the card; every
// warp of the roll sums the schedule itself (on rows of 128 lanes with
// the shuffle stage below, its data load in flight beside the sum).
// Bytes bound them.
//
// take2, min and min_add1 depend on the stage before, so a group of words
// that closes under the roll stays on chip for every stage: a row (axis
// 1) or one column of a tile (axis 0), a "line" of len words, and one
// independent warp a line, so [1024,128] tiles fill the card either way.
// * A row of 128 lanes (every probe shape on axis 1): four consecutive
//   words a lane, loaded and stored as 16 bytes.  A stage reads each
//   partner word from the lane that holds it with one __shfl_sync, no
//   shared memory and no barrier.  The source lane is the runtime part;
//   which register it sends depends on the shift mod 4, so a warp-uniform
//   switch picks one of four bodies with compile-time register indices
//   (a runtime register index would put the words in local memory).
// * Any other line of up to 1,024 words: word p in register p / 32 of
//   lane p % 32.  A stage publishes the line to the warp's own slice of
//   shared memory and reads each partner there (consecutive lanes on
//   consecutive words, so no bank conflicts); two slices alternate, so one
//   __syncwarp a stage orders it.  A rotation by a runtime row shift
//   would need runtime register indices, so shared memory beats shuffles
//   here.
// * Lines of 1,025 to 4,096 words, and lines of 257 to 1,024 words when
//   there are too few to give each SM four warps (one [1024,128] tile on
//   axis 0 is 128 lines): the same with a block of 1,024 (or 256)
//   threads a line and one __syncthreads a stage.
// What bounds these: the exchange (one shuffle, or one shared store and
// load, a word a stage) and the combine's integer issue.  Device memory
// is touched once in and once out per call, whatever the stage count.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

enum Op { kTake2 = 0, kMin = 1, kMinAdd1 = 2, kAdd1 = 3, kCopy = 4 };

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kPassThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;
constexpr int kMaxLine = 4096;        // longest line a block holds
constexpr int kWarpLine = 1024;       // longest line a warp holds
constexpr int kMaxWarpsPerBlock = 8;  // lines of one warp a block, at most
constexpr int kStaticSmem = 48 * 1024;

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

// `per` units a block (a power of two), halved while the card would get
// fewer than two blocks an SM
int units_per_block(long long units, int per) {
  while (per > 1 && (units + per - 1) / per < 2LL * sm_count()) per /= 2;
  return per;
}

__device__ __forceinline__ int mod_len(int s, int len) {
  const int d = s % len;
  return d < 0 ? d + len : d;
}

// sum_s (shifts[s] mod len) mod len, by one whole warp
__device__ int total_shift(const int32_t* __restrict__ shifts, int n,
                           int len) {
  long long acc = 0;
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    acc += mod_len(__ldg(shifts + i), len);
  }
  acc %= len;
#pragma unroll
  for (int off = 16; off; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  return (int)(acc % len);
}

// The schedule for a stage loop, 32 stages at a time: lane i of the warp
// holds stage (32c + i)'s shift mod len for the current chunk c and loads
// the next chunk's 32 stages ahead, so a stage takes its shift with one
// shuffle, off the critical path of a stage shorter than an L2 round trip.
// Stages are taken in order from 0; the whole warp calls every method.
struct Schedule {
  const int32_t* __restrict__ shifts;
  int n, len, cur, next;

  __device__ int load(int first) const {
    const int i = first + (threadIdx.x & 31);
    return i < n ? mod_len(__ldg(shifts + i), len) : 0;
  }

  __device__ Schedule(const int32_t* s, int n_stages, int length)
      : shifts(s), n(n_stages), len(length) {
    cur = load(0);
    next = load(32);
  }

  __device__ int shift(int s) {
    if (s && (s & 31) == 0) {  // the same for the whole warp
      cur = next;
      next = load(s + 32);
    }
    return __shfl_sync(kFull, cur, s & 31);
  }
};

// --- the composed families: one pass ------------------------------------

// o = x + add, mod 2^32; the first n4 * 4 words as 16-byte vectors
__global__ void __launch_bounds__(kPassThreads)
add_pass(const uint32_t* __restrict__ x, uint32_t* __restrict__ o,
         long long n, long long n4, uint32_t add) {
  const long long stride = (long long)gridDim.x * kPassThreads;
  const long long t = (long long)blockIdx.x * kPassThreads + threadIdx.x;
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  uint4* o4 = reinterpret_cast<uint4*>(o);
  for (long long i = t; i < n4; i += stride) {
    uint4 v = __ldg(x4 + i);
    v.x += add;
    v.y += add;
    v.z += add;
    v.w += add;
    o4[i] = v;
  }
  for (long long i = 4 * n4 + t; i < n; i += stride) o[i] = __ldg(x + i) + add;
}

// o = roll(x, the schedule's composed shift, axis); with vec (lanes a
// multiple of 4, x and o 16-byte aligned) each thread stores 4 words
__global__ void __launch_bounds__(kPassThreads)
roll_pass(const uint32_t* __restrict__ x, uint32_t* __restrict__ o,
          const int32_t* __restrict__ shifts, int n_stages, long long n_rows,
          int rows, int lanes, int axis, int vec) {
  const int d = total_shift(shifts, n_stages, axis == 1 ? lanes : rows);
  const int w = vec ? 4 : 1;  // words a thread moves
  const int per_row = lanes / w;
  const long long n = n_rows * per_row;
  const long long stride = (long long)gridDim.x * kPassThreads;
  for (long long i = (long long)blockIdx.x * kPassThreads + threadIdx.x;
       i < n; i += stride) {
    const long long row = i / per_row;
    const int c = (int)(i - row * per_row) * w;
    long long from_row = row;
    int from = c;
    if (axis == 0) {
      const int r = (int)(row % rows);
      from_row = row - r + (r >= d ? r - d : r - d + rows);
    } else {
      from = c >= d ? c - d : c - d + lanes;
    }
    const uint32_t* s = x + from_row * lanes;
    uint32_t* dst = o + row * lanes + c;
    if (!vec) {
      *dst = __ldg(s + from);
    } else if (axis == 0 || (d & 3) == 0) {  // an aligned source vector
      *reinterpret_cast<uint4*>(dst) =
          __ldg(reinterpret_cast<const uint4*>(s + from));
    } else {
      uint32_t v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int f = from + k;
        v[k] = __ldg(s + (f < lanes ? f : f - lanes));
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// --- the dependent families: a line on chip for every stage ------------

template <Op op>
__device__ __forceinline__ void combine(uint32_t& h, uint32_t& l,
                                        uint32_t ph, uint32_t pl) {
  if constexpr (op == kTake2) {
    if (ph < h || (ph == h && pl < l)) {
      h = ph;
      l = pl;
    }
  } else if constexpr (op == kMin) {
    h = min(ph, h);
  } else if constexpr (op == kMinAdd1) {
    h = min(ph, h) + 1u;
  } else {  // kCopy
    h = ph;
  }
}

// One stage on a 128-word row, word k of lane t at row position 4t + k.
// Its partner sits at 4t + k + e (mod 128), e = 128 - shift = 4q + R:
// register (k + R) mod 4 of lane t + q, or of lane t + q + 1 once k + R
// passes 3.
template <Op op, int R>
__device__ __forceinline__ void row_stage(uint32_t (&h)[4], uint32_t (&l)[4],
                                          int q, int lane) {
  const int a = (lane + q) & 31;
  const int b = (lane + q + 1) & 31;
  uint32_t ph[4], pl[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int from = k + R < 4 ? a : b;
    ph[k] = __shfl_sync(kFull, h[(k + R) & 3], from);
    if constexpr (op == kTake2) {
      pl[k] = __shfl_sync(kFull, l[(k + R) & 3], from);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) combine<op>(h[k], l[k], ph[k], pl[k]);
}

// a stage of shift d (0 <= d < 128): e = 128 - d picks the body
template <Op op>
__device__ __forceinline__ void row_roll(uint32_t (&h)[4], uint32_t (&l)[4],
                                        int d, int lane) {
  const int e = (128 - d) & 127;
  switch (e & 3) {  // the same for the whole warp
    case 0: row_stage<op, 0>(h, l, e >> 2, lane); break;
    case 1: row_stage<op, 1>(h, l, e >> 2, lane); break;
    case 2: row_stage<op, 2>(h, l, e >> 2, lane); break;
    default: row_stage<op, 3>(h, l, e >> 2, lane); break;
  }
}

// one warp a row of 128 lanes; x, o 16-byte aligned.  copy takes one
// stage of the composed shift, its data load in flight beside the sum: on
// [64,128] tiles that beats roll_pass's four scalar loads a 16-byte store
// by about 1 us (PERF.md, row 2).
template <Op op>
__global__ void __launch_bounds__(32 * kMaxWarpsPerBlock)
rows128(const uint4* __restrict__ xh, const uint4* __restrict__ xl,
        uint4* __restrict__ oh, uint4* __restrict__ ol,
        const int32_t* __restrict__ shifts, int n_stages, long long n_rows) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // the whole warp
  const long long at = row * 32 + lane;
  uint32_t h[4], l[4] = {0u, 0u, 0u, 0u};
  const uint4 v = __ldg(xh + at);
  h[0] = v.x, h[1] = v.y, h[2] = v.z, h[3] = v.w;
  if constexpr (op == kTake2) {
    const uint4 u = __ldg(xl + at);
    l[0] = u.x, l[1] = u.y, l[2] = u.z, l[3] = u.w;
  }
  if constexpr (op == kCopy) {
    row_roll<op>(h, l, total_shift(shifts, n_stages, 128), lane);
  } else {
    Schedule sched(shifts, n_stages, 128);
    for (int s = 0; s < n_stages; ++s) {
      row_roll<op>(h, l, sched.shift(s), lane);
    }
  }
  oh[at] = make_uint4(h[0], h[1], h[2], h[3]);
  if constexpr (op == kTake2) ol[at] = make_uint4(l[0], l[1], l[2], l[3]);
}

// kW warps a line of len <= 32 * kW * kP words, word p in register
// p / (32 kW) of thread p % (32 kW); two shared slices of the line a
// stage-pair, one barrier (a __syncwarp for one warp) a stage.  The stage
// loop has no predicate, so a thread's shared loads all go in flight at
// once: every register is published and combined, and those past len
// (written, never read as a partner of a word of the line) are dropped at
// the store.
template <Op op, int kP, int kW>
__global__ void __launch_bounds__(kW == 1 ? 32 * kMaxWarpsPerBlock : 32 * kW)
line_stages(const uint32_t* __restrict__ xh, const uint32_t* __restrict__ xl,
            uint32_t* __restrict__ oh, uint32_t* __restrict__ ol,
            const int32_t* __restrict__ shifts, int n_stages,
            long long n_lines, int rows, int lanes, int axis) {
  extern __shared__ uint32_t slices[];
  constexpr int kT = 32 * kW;    // threads a line
  constexpr int kCap = kT * kP;  // words a slice holds
  constexpr bool two = op == kTake2;
  const int slot = threadIdx.x / kT;
  const int tid = threadIdx.x % kT;
  const long long line = (long long)blockIdx.x * (blockDim.x / kT) + slot;
  if (line >= n_lines) return;  // a whole line's threads
  int len;
  long long base, step;  // word p of the line is x[base + p * step]
  if (axis == 1) {
    len = lanes;
    base = line * lanes;
    step = 1;
  } else {
    len = rows;
    const long long tile = line / lanes;
    base = tile * rows * lanes + (line - tile * lanes);
    step = lanes;
  }
  uint32_t* buf = slices + (long long)slot * 2 * (two ? 2 : 1) * kCap;
  uint32_t h[kP], l[kP];
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const int p = j * kT + tid;
    h[j] = l[j] = 0u;
    if (p < len) {
      h[j] = __ldg(xh + base + p * step);
      if constexpr (two) l[j] = __ldg(xl + base + p * step);
    }
  }
  Schedule sched(shifts, n_stages, len);
  for (int s = 0; s < n_stages; ++s) {
    const int d = sched.shift(s);
    uint32_t* b = buf + (s & 1) * (two ? 2 : 1) * kCap;
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const int p = j * kT + tid;
      b[p] = h[j];
      if constexpr (two) b[kCap + p] = l[j];
    }
    if constexpr (kW == 1) {
      __syncwarp();
    } else {
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kP; ++j) {
      const int p = j * kT + tid;
      const int q = p >= d ? p - d : p - d + len;  // < kCap for every p
      combine<op>(h[j], l[j], b[q], two ? b[kCap + q] : 0u);
    }
  }
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const int p = j * kT + tid;
    if (p < len) {
      oh[base + p * step] = h[j];
      if constexpr (two) ol[base + p * step] = l[j];
    }
  }
}

struct Args {
  const uint32_t* xh;
  const uint32_t* xl;
  uint32_t* oh;
  uint32_t* ol;
  const int32_t* shifts;
  int n_stages;
  long long n_rows;
  int rows, lanes, axis;
  cudaStream_t stream;
};

template <Op op, int kP, int kW>
cudaError_t launch_lines(const Args& a) {
  constexpr int kT = 32 * kW;
  constexpr int kLineBytes = 2 * (op == kTake2 ? 2 : 1) * kT * kP * 4;
  const long long n_lines =
      a.axis == 1 ? a.n_rows : (a.n_rows / a.rows) * a.lanes;
  int per = kW == 1 ? std::min(kMaxWarpsPerBlock, kStaticSmem / kLineBytes)
                    : 1;
  per = units_per_block(n_lines, per);
  const int smem = per * kLineBytes;
  auto kernel = line_stages<op, kP, kW>;
  if (smem > kStaticSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)((n_lines + per - 1) / per), per * kT, smem,
           a.stream>>>(a.xh, a.xl, a.oh, a.ol, a.shifts, a.n_stages, n_lines,
                       a.rows, a.lanes, a.axis);
  return cudaGetLastError();
}

// rows128 takes rows of 128 lanes on 16-byte-aligned tensors
template <Op op>
bool rows128_fits(const Args& a) {
  return a.axis == 1 && a.lanes == 128 && aligned16(a.xh) &&
         aligned16(a.oh) &&
         (op != kTake2 || (aligned16(a.xl) && aligned16(a.ol)));
}

template <Op op>
cudaError_t launch_rows128(const Args& a) {
  const int per = units_per_block(a.n_rows, kMaxWarpsPerBlock);
  rows128<op><<<(unsigned)((a.n_rows + per - 1) / per), 32 * per, 0,
                a.stream>>>(
      reinterpret_cast<const uint4*>(a.xh),
      reinterpret_cast<const uint4*>(a.xl), reinterpret_cast<uint4*>(a.oh),
      reinterpret_cast<uint4*>(a.ol), a.shifts, a.n_stages, a.n_rows);
  return cudaGetLastError();
}

template <Op op>
cudaError_t launch_dependent(const Args& a) {
  const int len = a.axis == 1 ? a.lanes : a.rows;
  if (rows128_fits<op>(a)) return launch_rows128<op>(a);
  const long long n_lines =
      a.axis == 1 ? a.n_rows : (a.n_rows / a.rows) * a.lanes;
  if (len > kWarpLine) return launch_lines<op, kMaxLine / 1024, 32>(a);
  if (len > 256 && n_lines < 4LL * sm_count()) {
    // too few lines to give each SM four warps: eight warps a line
    return len <= 512 ? launch_lines<op, 2, 8>(a) : launch_lines<op, 4, 8>(a);
  }
  if (len <= 32) return launch_lines<op, 1, 1>(a);
  if (len <= 64) return launch_lines<op, 2, 1>(a);
  if (len <= 128) return launch_lines<op, 4, 1>(a);
  if (len <= 256) return launch_lines<op, 8, 1>(a);
  if (len <= 512) return launch_lines<op, 16, 1>(a);
  return launch_lines<op, 32, 1>(a);
}

}  // namespace

extern "C" {

const char* tile_stages_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// xh, oh (and xl, ol for op take2): [n_rows, lanes] uint32 on the device;
// shifts: n_stages int32 on the device.  Axis 0 rolls inside tiles of
// `rows` rows (n_rows a multiple of rows, rows <= kMaxLine); axis 1 rolls
// along whole rows (lanes <= kMaxLine).
int tile_stages_launch(const void* xh, const void* xl, void* oh, void* ol,
                       const void* shifts, int n_stages, int op,
                       long long n_rows, int rows, int lanes, int axis,
                       void* stream) {
  if (n_rows <= 0 || lanes <= 0 || n_stages < 0 || op < kTake2 ||
      op > kCopy || (op == kTake2 && (xl == nullptr || ol == nullptr)) ||
      (axis == 1 && lanes > kMaxLine) ||
      (axis == 0 && (rows <= 0 || rows > kMaxLine || n_rows % rows)) ||
      (axis != 0 && axis != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{static_cast<const uint32_t*>(xh),
               static_cast<const uint32_t*>(xl),
               static_cast<uint32_t*>(oh),
               static_cast<uint32_t*>(ol),
               static_cast<const int32_t*>(shifts),
               n_stages,
               n_rows,
               rows,
               lanes,
               axis,
               static_cast<cudaStream_t>(stream)};
  const long long n = n_rows * lanes;
  switch (op) {
    case kAdd1: {
      const long long n4 = aligned16(xh) && aligned16(oh) ? n / 4 : 0;
      const long long blocks = std::min(
          kMaxBlocks, (std::max(n4, n - 4 * n4) + kPassThreads - 1) /
                          kPassThreads);
      add_pass<<<(unsigned)blocks, kPassThreads, 0, a.stream>>>(
          a.xh, a.oh, n, n4, (uint32_t)n_stages);
      return (int)cudaGetLastError();
    }
    case kCopy: {
      if (rows128_fits<kCopy>(a)) return (int)launch_rows128<kCopy>(a);
      const int vec = lanes % 4 == 0 && aligned16(xh) && aligned16(oh);
      const long long blocks = std::min(
          kMaxBlocks, (n / (vec ? 4 : 1) + kPassThreads - 1) / kPassThreads);
      roll_pass<<<(unsigned)blocks, kPassThreads, 0, a.stream>>>(
          a.xh, a.oh, a.shifts, n_stages, n_rows, rows, lanes, axis, vec);
      return (int)cudaGetLastError();
    }
    case kTake2: return (int)launch_dependent<kTake2>(a);
    case kMin: return (int)launch_dependent<kMin>(a);
    default: return (int)launch_dependent<kMinAdd1>(a);
  }
}

}  // extern "C"
