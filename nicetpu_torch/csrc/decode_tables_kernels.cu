// CUDA kernels of the decode tables (nicetpu_torch), for sm_90a: code
// lengths -> the canonical decode tables and the walk's threshold tables,
// all in one launch; and arbitrary tables -> the walk's threshold tables.
//
// decode_tables_kernel replaces nicetpu/kernels/decode3.py:1143
// `prepare_tables_v3_jnp` together with :180 `derive_walk_tables` of its
// tables, and walk_tables_kernel replaces `derive_walk_tables` on any
// tables: jnp code that XLA runs inside the jitted round trip (:1619,
// jitted at :1646) and the jitted decode core (:943, jitted at :1044) as
// part of one device program (no Pallas kernel).  Their plain PyTorch
// versions are nicetpu_torch/kernels/decode3.py `prepare_tables_v3_plain`
// (per stream a clamp, an argsort, a cumsum and two (B, 32, size)
// compare-and-sum reductions: some 500 small torch operations) and
// `derive_walk_tables_plain`; the wrappers are
// nicetpu_torch/kernels/cuda_ops.py `decode_tables` and `walk_tables`.
// Built by nicetpu_torch/kernels/build.py like the other sources: a plain C
// interface, launches on the caller's stream, allocates nothing, returns
// cudaGetLastError().  Both equal their plain versions bit for bit.
//
// What bounds them.  A call moves some 120 KB at B = 8 and does some
// 74,000 integer operations an image (counted in chip_smoke.py), 0.000035
// and 0.000009 ms of the card's rates, so neither bounds it: a call is one
// launch's latency plus the block's longest chain of dependent steps.  The design keeps it one launch a batch with nothing
// read back, and that chain short:
//   * One block an image, one warp a 32-symbol chunk of a stream (29
//     chunks: 8, 1, 2, 1, 1, 11, 2, 1, 1, 1 by stream), so the widest
//     stream (343 symbols) takes 11 warps side by side, not one warp 11
//     chunks in a row.  Each lane reads its one length (int64 read whole:
//     2^32 + 3 is out of range) at the start: the block's 858 loads are one
//     coalesced pass, and no later step waits on device memory.  A length
//     is read by one lane only, so it stays in that lane's register.
//   * The canonical order (length ascending, then symbol) is a stable
//     counting sort.  A symbol's rank within its chunk is the lower lanes
//     with the same length (__match_any_sync); the group's lowest lane
//     writes the chunk's count of that length to shared memory.  After one
//     barrier, one warp a stream, lane l owning length l, turns its chunks'
//     counts into offsets (an exclusive scan over the stream's chunks, at
//     most 11 shared-memory steps): a chunk's offset for a length is that
//     length's count in the stream's earlier chunks.  The totals are each
//     length's count; one warp scan gives the symbols shorter than each
//     length (ib) and, in 64 bits, the left-aligned first codes
//     sum_{l' < l} count[l'] * 2^(32 - l'), whose low word is af and whose
//     total is the Kraft sum, held to exactly 2^32.  The same warp derives
//     the walk's tables from the af, present and ib in its registers.
//     After a second barrier every chunk warp stores its symbols at their
//     slots, ib[length] + offset + rank, and the block writes tables_ok.
//   * walk_tables: the suffix minimum of aff and the forward fill of D are
//     warp shuffles and one ballot, one warp a (image, stream).

#include <climits>

#include "common.cuh"

namespace {

constexpr int kStreams = 10;
constexpr int kLanes = 32;  // code lengths 0..31, one a lane
constexpr int kRow = kStreams * kLanes;  // words of af, present, ib, aff, dD, inc an image
constexpr int kMaxCodeLen = 31;
constexpr int kChunks = 29;  // 32-symbol chunks of the ten streams, cut per stream
constexpr int kTablesThreads = kChunks * kLanes;  // one warp a chunk
constexpr int kWalkThreads = kStreams * kLanes;   // one warp a stream
constexpr int kPrefixStream = 1;                  // format/constants.py SC_PREFIXES
constexpr int kPfxCols = 16;                      // pfx16's columns; the stream has 13 symbols
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kKraft = 1ULL << 32;  // a complete code's sum of 2^(32 - length)

__constant__ int kSizes[kStreams] = {256, 13, 64, 32, 11, 343, 64, 32, 32, 11};
__constant__ int kBase[kStreams] = {0, 256, 269, 333, 365, 376, 719, 783, 815, 847};
__constant__ int kFirstChunk[kStreams + 1] = {0, 8, 9, 11, 12, 13, 24, 26, 27, 28, 29};
__constant__ int kChunkStream[kChunks] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 2, 2, 3, 4, 5, 5,
                                          5, 5, 5, 5, 5, 5, 5, 5, 5, 6, 6, 7, 8, 9};

// The ten outputs of one call, carved by nt_decode_tables from one buffer
// of int32 words; aff, dD and inc are null where the call asks for the
// seven decode tables alone.
struct Tables {
  int* af;          // (B, 10, 32)
  int* present;     // (B, 10, 32)
  int* ib;          // (B, 10, 32)
  int* pfx16;       // (B, 16)
  int* sym_tbl;     // (B, 858)
  int* stream_max;  // (B, 10)
  int* aff;         // (B, 10, 32) or null
  int* dD;          // (B, 10, 32) or null
  int* inc;         // (B, 10, 32) or null
  uint8_t* ok;      // (B,) bytes
};

// The walk's thresholds at one (image, stream) row, lane l length l, from
// its first code a (uint32), present flag and ib: aff, the suffix minimum
// of the biased first codes of present lengths; dD, the differences of D =
// ib - (a >>> (32 - l)) at present lengths carried forward from the last
// present length at or below each lane, wrapping; inc, 1 up to the
// longest present length.
__device__ __forceinline__ void walk_row(unsigned a, bool pres, int ib, int lane, int* aff, int* dD,
                                         int* inc) {
  int m = pres ? (int)(a ^ 0x80000000u) : INT_MAX;
#pragma unroll
  for (int off = 1; off < kLanes; off <<= 1) {
    const int x = __shfl_down_sync(kFull, m, off);
    if (lane + off < kLanes) m = min(m, x);
  }
  const unsigned d_at = pres ? (unsigned)ib - (a >> ((32 - lane) & 31)) : 0u;
  const unsigned mask = __ballot_sync(kFull, pres);
  const unsigned upto = mask & ((2u << lane) - 1);  // lanes 0..lane (all 32 at lane 31)
  const int last = upto ? 31 - __clz(upto) : -1;
  const unsigned from_last = __shfl_sync(kFull, d_at, last < 0 ? 0 : last);
  const unsigned d_ff = last >= 0 ? from_last : 0u;
  const unsigned prev = __shfl_up_sync(kFull, d_ff, 1);
  const int longest = mask ? 31 - __clz(mask) : 0;  // no length present: inc[0] alone
  *aff = m;
  *dD = (int)(d_ff - (lane ? prev : 0u));
  *inc = lane <= longest ? 1 : 0;
}

// lens (B, 858) int32 or int64 -> the tables of `out`.  Block b is image b.
template <typename T>
__global__ void __launch_bounds__(kTablesThreads) decode_tables_kernel(const T* __restrict__ lens, Tables out) {
  __shared__ int s_at[kChunks][kLanes];        // a chunk's count of each length, then its offset
  __shared__ int s_shorter[kStreams][kLanes];  // a stream's symbols shorter than each length
  __shared__ int s_bad;                        // some stream's Kraft sum is not 2^32
  const int c = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;  // the warp's chunk
  const int s = kChunkStream[c], n = kSizes[s], base = kBase[s];
  const int p = (c - kFirstChunk[s]) * kLanes + lane;  // the lane's symbol in its stream
  const long long img = blockIdx.x;

  // 1: the lane's length, clamped, and its rank among the chunk's equal lengths
  int lc = 0;  // 0: a lane past the stream's end (a real length clamps to 1..31)
  bool in_range = true;
  if (p < n) {
    const long long raw = (long long)lens[img * nt::kSymbols + base + p];
    in_range = raw >= 1 && raw <= kMaxCodeLen;
    lc = raw < 1 ? 1 : (raw > kMaxCodeLen ? kMaxCodeLen : (int)raw);
  }
  const unsigned same = __match_any_sync(kFull, lc);
  const unsigned lower = same & ((1u << lane) - 1);
  const int rank = __popc(lower);
  s_at[c][lane] = 0;
  if (threadIdx.x == 0) s_bad = 0;
  __syncwarp();
  if (lc && lower == 0) s_at[c][lc] = __popc(same);
  const bool all_in_range = __syncthreads_and(in_range);

  // 2: one warp a stream, lane l length l: the chunks' offsets, the counts'
  // and the code space's exclusive scans (64 bits), the tables
  if (c < kStreams) {
    const int st = c;
    int count = 0;  // length 0 never occurs
    for (int k = kFirstChunk[st]; k < kFirstChunk[st + 1]; ++k) {
      const int here = s_at[k][lane];
      s_at[k][lane] = count;
      count += here;
    }
    const unsigned long long space = (unsigned long long)count << (32 - lane);
    int incl = count;
    unsigned long long space_incl = space;
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
      const int x = __shfl_up_sync(kFull, incl, off);
      const unsigned long long y = __shfl_up_sync(kFull, space_incl, off);
      if (lane >= off) {
        incl += x;
        space_incl += y;
      }
    }
    const int shorter = incl - count;
    const unsigned long long kraft = __shfl_sync(kFull, space_incl, kLanes - 1);
    const bool pres = count > 0;
    const unsigned a = pres ? (unsigned)(space_incl - space) : kFull;
    const int ib = pres ? shorter : 0;
    const long long o = img * kRow + st * kLanes + lane;
    out.af[o] = (int)a;
    out.present[o] = pres ? 1 : 0;
    out.ib[o] = ib;
    s_shorter[st][lane] = shorter;
    const unsigned lengths_present = __ballot_sync(kFull, pres);
    if (lane == 0) {
      out.stream_max[img * kStreams + st] = 31 - __clz(lengths_present);  // every stream has symbols
      if (kraft != kKraft) s_bad = 1;
    }
    if (out.aff != nullptr) walk_row(a, pres, ib, lane, out.aff + o, out.dD + o, out.inc + o);
  }
  __syncthreads();

  // 3: each symbol to its slot, ib[length] + the chunk's offset + its rank
  if (threadIdx.x == 0) out.ok[img] = all_in_range && !s_bad ? 1 : 0;
  if (p < n) {
    const int slot = s_shorter[s][lc] + s_at[c][lc] + rank;
    out.sym_tbl[img * nt::kSymbols + base + slot] = p;
    if (s == kPrefixStream) out.pfx16[img * kPfxCols + slot] = p;
  } else if (s == kPrefixStream && p < kPfxCols) {
    out.pfx16[img * kPfxCols + p] = 0;
  }
}

// af, present, ib (B, 10, 32) int32, any values (present nonzero: present)
// -> aff, dD, inc (B, 10, 32) int32.  One warp a (image, stream).
__global__ void __launch_bounds__(kWalkThreads)
walk_tables_kernel(const int* __restrict__ af, const int* __restrict__ present, const int* __restrict__ ib,
                   int* __restrict__ aff, int* __restrict__ dD, int* __restrict__ inc) {
  const int lane = threadIdx.x % kLanes;
  const long long o = (long long)blockIdx.x * kRow + threadIdx.x;
  walk_row((unsigned)af[o], present[o] != 0, ib[o], lane, aff + o, dD + o, inc + o);
}

}  // namespace

extern "C" {

// lens (B, 858) int32, or int64 where lens_are_64 is nonzero.  out: one
// buffer of int32 words holding, in this order, af, present, ib (B, 10,
// 32), pfx16 (B, 16), sym_tbl (B, 858), stream_max (B, 10); then, where
// with_walk is nonzero, aff, dD, inc (B, 10, 32); then tables_ok, B bytes.
int nt_decode_tables(const void* lens, int lens_are_64, void* out, int with_walk, int B, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long b = B;
  int* w = static_cast<int*>(out);
  Tables t;
  t.af = w;
  t.present = t.af + b * kRow;
  t.ib = t.present + b * kRow;
  t.pfx16 = t.ib + b * kRow;
  t.sym_tbl = t.pfx16 + b * kPfxCols;
  t.stream_max = t.sym_tbl + b * nt::kSymbols;
  w = t.stream_max + b * kStreams;
  t.aff = t.dD = t.inc = nullptr;
  if (with_walk) {
    t.aff = w;
    t.dD = t.aff + b * kRow;
    t.inc = t.dD + b * kRow;
    w = t.inc + b * kRow;
  }
  t.ok = reinterpret_cast<uint8_t*>(w);
  const dim3 grid(B);
  if (lens_are_64) {
    decode_tables_kernel<long long>
        <<<grid, kTablesThreads, 0, (cudaStream_t)stream>>>(static_cast<const long long*>(lens), t);
  } else {
    decode_tables_kernel<int><<<grid, kTablesThreads, 0, (cudaStream_t)stream>>>(static_cast<const int*>(lens), t);
  }
  return (int)cudaGetLastError();
}

// af, present, ib, aff, dD, inc (B, 10, 32) int32.
int nt_walk_tables(const void* af, const void* present, const void* ib, void* aff, void* dD, void* inc, int B,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  walk_tables_kernel<<<B, kWalkThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(af), static_cast<const int*>(present), static_cast<const int*>(ib),
      static_cast<int*>(aff), static_cast<int*>(dD), static_cast<int*>(inc));
  return (int)cudaGetLastError();
}

}  // extern "C"
