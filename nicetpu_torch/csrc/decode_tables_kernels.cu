// CUDA kernels of the decode tables (nicetpu_torch), for sm_90a: code
// lengths -> the canonical decode tables, and those -> the walk's
// threshold tables.
//
// decode_tables_kernel replaces nicetpu/kernels/decode3.py:1143
// `prepare_tables_v3_jnp`, and walk_tables_kernel replaces :180
// `derive_walk_tables`: jnp code that XLA runs inside the jitted round trip
// (:1619, jitted at :1646) and the jitted decode core (:943, jitted at
// :1044) as part of one device program (no Pallas kernel).  Their plain
// PyTorch versions are nicetpu_torch/kernels/decode3.py
// `prepare_tables_v3_plain` (per stream a clamp, an argsort, a cumsum and
// two (B, 32, size) compare-and-sum reductions: some 200 small torch
// operations) and `derive_walk_tables_plain`; the wrappers are
// nicetpu_torch/kernels/cuda_ops.py `decode_tables` and `walk_tables`.
// Built by nicetpu_torch/kernels/build.py like the other sources: a plain C
// interface, launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().  Both equal their plain versions bit for bit.
//
// What bounds them.  A call moves some 90 KB at B = 8 and does a few
// thousand integer operations an image, so neither bytes nor operations
// do: a call is one launch's latency.  The design keeps it one launch with
// nothing read back, and every step inside a warp:
//   * One block an image, one warp a stream (320 threads), lane l owning
//     code length l.  The block writes the image's tables_ok itself, so no
//     torch reduction follows.
//   * decode_tables: the canonical order (length ascending, then symbol) is
//     a stable counting sort.  The warp walks its stream in 32-symbol
//     chunks; a symbol's rank among its length is the length's running
//     count plus the lower lanes of its chunk with the same length
//     (__match_any_sync), and the lowest such lane adds the group to the
//     running count.  The running counts are then each length's count;
//     one warp scan gives the symbols shorter than each length (ib) and,
//     in 64 bits, the left-aligned first codes sum_{l' < l} count[l'] *
//     2^(32 - l'), whose low word is af and whose total is the Kraft sum,
//     held to exactly 2^32.  A symbol's slot is ib[length] + rank.
//   * walk_tables: the suffix minimum of aff and the forward fill of D are
//     warp shuffles and one ballot.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kStreams = 10;
constexpr int kLanes = 32;  // code lengths 0..31, one a lane
constexpr int kMaxCodeLen = 31;
constexpr int kTablesThreads = kStreams * kLanes;  // one warp a stream
constexpr int kPrefixStream = 1;                   // format/constants.py SC_PREFIXES
constexpr int kPfxCols = 16;                       // pfx16's columns; the stream has 13 symbols
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kKraft = 1ULL << 32;  // a complete code's sum of 2^(32 - length)

__constant__ int kSizes[kStreams] = {256, 13, 64, 32, 11, 343, 64, 32, 32, 11};
__constant__ int kBase[kStreams] = {0, 256, 269, 333, 365, 376, 719, 783, 815, 847};

// lens (B, 858) int32 or int64 -> af, present, ib (B, 10, 32), pfx16 (B, 16),
// sym_tbl (B, 858), stream_max (B, 10) int32 and tables_ok (B,) bytes.
template <typename T>
__global__ void __launch_bounds__(kTablesThreads)
decode_tables_kernel(const T* __restrict__ lens, int* __restrict__ af, int* __restrict__ present,
                     int* __restrict__ ib, int* __restrict__ pfx16, int* __restrict__ sym_tbl,
                     int* __restrict__ stream_max, uint8_t* __restrict__ tables_ok) {
  __shared__ int s_lr[nt::kSymbols];   // a symbol's clamped length | its rank among that length << 5
  __shared__ int s_run[kStreams][kLanes];  // running count of each length, one row a warp
  __shared__ int s_bad;                    // some stream of the image failed
  const int s = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const long long img = blockIdx.x;
  const int n = kSizes[s], base = kBase[s];
  const T* row = lens + img * nt::kSymbols + base;
  if (threadIdx.x == 0) s_bad = 0;
  s_run[s][lane] = 0;
  __syncthreads();

  // pass 1: clamp, range check, rank among equal lengths, count
  const unsigned below = (1u << lane) - 1;
  bool in_range = true;
  for (int p0 = 0; p0 < n; p0 += kLanes) {
    const int p = p0 + lane;
    int lc = 0;  // 0: a lane past the stream's end (a real length clamps to 1..31)
    if (p < n) {
      const long long raw = (long long)row[p];  // int64 read whole: 2^32 + 3 is out of range
      in_range &= raw >= 1 && raw <= kMaxCodeLen;
      lc = raw < 1 ? 1 : (raw > kMaxCodeLen ? kMaxCodeLen : (int)raw);
    }
    const unsigned same = __match_any_sync(kFull, lc);
    if (lc) s_lr[base + p] = lc | (s_run[s][lc] + __popc(same & below)) << 5;
    __syncwarp();
    if (lc && (same & below) == 0) s_run[s][lc] += __popc(same);
    __syncwarp();
  }

  // the 32 lengths, one a lane: exclusive scans of the counts and of the
  // left-aligned code space they take, 64 bits wide
  const int count = s_run[s][lane];  // length 0 never occurs
  const unsigned long long space = (unsigned long long)count << (32 - lane);
  int incl = count;
  unsigned long long space_incl = space;
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const int c = __shfl_up_sync(kFull, incl, off);
    const unsigned long long d = __shfl_up_sync(kFull, space_incl, off);
    if (lane >= off) {
      incl += c;
      space_incl += d;
    }
  }
  const int shorter = incl - count;
  const unsigned long long kraft = __shfl_sync(kFull, space_incl, kLanes - 1);
  const bool pres = count > 0;
  const long long o = (img * kStreams + s) * kLanes + lane;
  af[o] = pres ? (int)(unsigned)(space_incl - space) : -1;
  present[o] = pres ? 1 : 0;
  ib[o] = pres ? shorter : 0;
  const unsigned lengths_present = __ballot_sync(kFull, pres);
  const bool ok = __all_sync(kFull, in_range) && kraft == kKraft;
  if (lane == 0) {
    stream_max[img * kStreams + s] = 31 - __clz(lengths_present);  // every stream has symbols
    if (!ok) s_bad = 1;
  }

  // pass 2: each symbol to its slot, ib[length] + rank
  for (int p0 = 0; p0 < n; p0 += kLanes) {
    const int p = p0 + lane;
    const int lr = p < n ? s_lr[base + p] : 0;
    const int slot = __shfl_sync(kFull, shorter, lr & 31) + (lr >> 5);
    if (p < n) {
      sym_tbl[img * nt::kSymbols + base + slot] = p;
      if (s == kPrefixStream) pfx16[img * kPfxCols + slot] = p;
    }
  }
  if (s == kPrefixStream && lane >= n && lane < kPfxCols) pfx16[img * kPfxCols + lane] = 0;
  __syncthreads();
  if (threadIdx.x == 0) tables_ok[img] = s_bad ? 0 : 1;
}

// af, present, ib (B, 10, 32) int32, any values (present nonzero: present)
// -> aff, dD, inc (B, 10, 32) int32.  One warp a (image, stream).
__global__ void __launch_bounds__(kTablesThreads)
walk_tables_kernel(const int* __restrict__ af, const int* __restrict__ present, const int* __restrict__ ib,
                   int* __restrict__ aff, int* __restrict__ dD, int* __restrict__ inc) {
  const int lane = threadIdx.x % kLanes;
  const long long o = ((long long)blockIdx.x * kStreams + threadIdx.x / kLanes) * kLanes + lane;
  const unsigned a = (unsigned)af[o];
  const bool pres = present[o] != 0;
  // aff: suffix minimum of the biased first codes of present lengths
  int m = pres ? (int)(a ^ 0x80000000u) : INT_MAX;
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const int x = __shfl_down_sync(kFull, m, off);
    if (lane + off < kLanes) m = min(m, x);
  }
  // D at present lengths, wrapping: ib - (af >>> (32 - l)), then carried
  // forward from the last present length at or below each lane
  const unsigned d_at = pres ? (unsigned)ib[o] - (a >> ((32 - lane) & 31)) : 0u;
  const unsigned mask = __ballot_sync(kFull, pres);
  const unsigned upto = mask & ((2u << lane) - 1);  // lanes 0..lane (all 32 at lane 31)
  const int last = upto ? 31 - __clz(upto) : -1;
  const unsigned from_last = __shfl_sync(kFull, d_at, last < 0 ? 0 : last);
  const unsigned d_ff = last >= 0 ? from_last : 0u;
  const unsigned prev = __shfl_up_sync(kFull, d_ff, 1);
  const int longest = mask ? 31 - __clz(mask) : 0;  // no length present: inc[0] alone
  aff[o] = m;
  dD[o] = (int)(d_ff - (lane ? prev : 0u));
  inc[o] = lane <= longest ? 1 : 0;
}

}  // namespace

extern "C" {

// lens (B, 858) int32, or int64 where lens_are_64 is nonzero; af, present,
// ib (B, 10, 32), pfx16 (B, 1, 16), sym_tbl (B, 858), stream_max (B, 10)
// int32; tables_ok (B,) bytes.
int nt_decode_tables(const void* lens, int lens_are_64, void* af, void* present, void* ib, void* pfx16,
                     void* sym_tbl, void* stream_max, void* tables_ok, int B, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  auto* a = static_cast<int*>(af);
  auto* pr = static_cast<int*>(present);
  auto* i = static_cast<int*>(ib);
  auto* pf = static_cast<int*>(pfx16);
  auto* st = static_cast<int*>(sym_tbl);
  auto* sm = static_cast<int*>(stream_max);
  auto* ok = static_cast<uint8_t*>(tables_ok);
  if (lens_are_64) {
    decode_tables_kernel<long long><<<B, kTablesThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const long long*>(lens), a, pr, i, pf, st, sm, ok);
  } else {
    decode_tables_kernel<int><<<B, kTablesThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const int*>(lens), a, pr, i, pf, st, sm, ok);
  }
  return (int)cudaGetLastError();
}

// af, present, ib, aff, dD, inc (B, 10, 32) int32.
int nt_walk_tables(const void* af, const void* present, const void* ib, void* aff, void* dD, void* inc, int B,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  walk_tables_kernel<<<B, kTablesThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(af), static_cast<const int*>(present), static_cast<const int*>(ib),
      static_cast<int*>(aff), static_cast<int*>(dD), static_cast<int*>(inc));
  return (int)cudaGetLastError();
}

}  // extern "C"
