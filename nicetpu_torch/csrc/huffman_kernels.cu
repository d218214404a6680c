// CUDA kernel of the fused encode's Huffman tables (nicetpu_torch), for sm_90a.
//
// huffman_tables replaces nicetpu/kernels/huffman_dev.py build_tables_device
// (:224).  That is not a Pallas kernel but one jitted XLA program: a
// lax.fori_loop of 341 merge steps over (B, 10, 686) node lanes, a lax.cond
// around the length-limit re-merge and a lax.scan of first codes, so that a
// whole encode is one device dispatch with no host round trip for its
// tables.  The port's plain version (huffman_dev.build_tables_device_plain)
// computes the same in torch ops: some twenty small launches a merge step
// and a host read before the re-merge.  This kernel is the whole build in
// one launch, with nothing read back.  Its outputs equal the plain
// version's bit for bit for non-negative counts whose stream totals stay
// below 2^52, where the packed keys below are unique among live nodes.
//
// Design.  One block per (stream, image), grid (10, B), 352 threads:
// thread t holds slot t and symbol t of its stream.
//   * Keys: the plain version's packed int64 key
//     weight << 11 | internal << 10 | min_symbol, so that the ordinary minimum
//     is the reference's node (weight asc, leaves first, least symbol).
//   * Slots: a merge writes the merged node into the slot of the smaller of
//     the two keys and marks the other slot dead, so the n leaf slots hold
//     every live node.  Each symbol keeps, in registers, its code length and
//     the key of the node that holds it; keys are unique among live nodes,
//     so a symbol is under a merged node exactly when its key is one of the
//     two minima, and no slot index has to be broadcast.
//   * A step is one block-wide pair-min: a butterfly of int64 shuffles in
//     each warp, the warps' pairs through shared memory (two buffers in
//     turn, so one barrier a step), then every thread folds the pairs.
//     Stream s runs ALPHABET_SIZES[s] - 2 steps, 341 down to 9; a small
//     stream's block finishes early.
//   * Clamp: if any length exceeds 31 (__syncthreads_or), the block sums its
//     stream's counts, raises each to max(c, (total >> 20) + 1) and merges
//     again.  A stream that did not overflow would re-merge to the same
//     lengths, so deciding per stream equals JAX's batch-wide lax.cond.
//   * Codes: the counts of each length 1..32 in shared memory, each
//     symbol's first code summed in int64, its rank among the lower symbols
//     of its length, the low 32 bits written at STREAM_BASE[s] + t.
//   * Overflow: the block writes its stream's flag (a length over 31 after
//     the clamp); the wrapper ORs the ten flags of an image.
//
// What bounds it.  The counts and tables are a few kilobytes, so bytes do
// not, and the comparisons (about n^2 a stream) take well under a
// microsecond of the card's integer rate.  The bound is the chain of up to
// 2 x 341 dependent block reductions: each waits on the last.  The design
// keeps that chain as short as it can be in one launch: every (stream,
// image) chain runs at once in one wave of 10 B blocks, a step is five
// shuffle rounds and one barrier, and small streams stop at their own
// length instead of running 341 masked steps as the plain version does.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kStreams = 10;
constexpr int kPmax = 343;              // the largest alphabet (SMALL_DIFF)
constexpr int kMaxCodeLen = 31;         // the 5-bit max_aob header field
constexpr int kLens = kMaxCodeLen + 1;  // lengths 1..32 get codes, as in the plain version
constexpr int kHuffThreads = 352;       // 11 warps: thread t holds slot t and symbol t
constexpr int kHuffWarps = kHuffThreads / 32;
constexpr long long kDead = LLONG_MAX;  // the key of a dead slot
static_assert(kHuffThreads >= kPmax && kHuffThreads % 32 == 0, "one thread a slot, whole warps");

__constant__ int kSizes[kStreams] = {256, 13, 64, 32, 11, 343, 64, 32, 32, 11};
__constant__ int kBase[kStreams] = {0, 256, 269, 333, 365, 376, 719, 783, 815, 847};

// (m1, m2) <- the two smallest of {m1, m2, b1, b2}, given m1 <= m2 and b1 <= b2.
__device__ __forceinline__ void pair_min(long long& m1, long long& m2, long long b1, long long b2) {
  const long long lo = min(m1, b1), hi = max(m1, b1);
  m2 = min(hi, min(m2, b2));
  m1 = lo;
}

// The two smallest keys of the block's first `nwarps` warps, in every thread.
// part is this step's buffer of per-warp pairs.
__device__ __forceinline__ void two_smallest(long long key, long long (*part)[2], int nwarps,
                                             long long& k1, long long& k2) {
  long long m1 = key, m2 = kDead;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long o1 = __shfl_xor_sync(0xffffffffu, m1, off);
    const long long o2 = __shfl_xor_sync(0xffffffffu, m2, off);
    pair_min(m1, m2, o1, o2);
  }
  if ((threadIdx.x & 31) == 0) {
    part[threadIdx.x >> 5][0] = m1;
    part[threadIdx.x >> 5][1] = m2;
  }
  __syncthreads();
  k1 = part[0][0];
  k2 = part[0][1];
  for (int w = 1; w < nwarps; ++w) pair_min(k1, k2, part[w][0], part[w][1]);
}

// The code length of this thread's symbol after the n - 2 merges of the
// stream's n leaves (0 for a thread past the alphabet).  Integer arithmetic
// is the plain version's in two's complement: shifts and sums go through
// uint64 so that they wrap as torch's int64 do.
__device__ int merge_lengths(long long count, bool live, int n, long long (*part)[kHuffWarps][2]) {
  const unsigned long long leaf = ((unsigned long long)count << 11) | (unsigned)threadIdx.x;
  long long slot = live ? (long long)leaf : kDead;  // the key in slot t
  long long node = slot;                             // the key of the node holding symbol t
  int len = live ? 1 : 0;
  const int nwarps = (n + 31) >> 5;
  for (int it = 0; it < n - 2; ++it) {
    long long ka, kb;
    two_smallest(slot, part[it & 1], nwarps, ka, kb);
    const unsigned long long w = (unsigned long long)(ka >> 11) + (unsigned long long)(kb >> 11);
    const long long merged = (long long)((w << 11) | 1024ull) | min(ka & 1023LL, kb & 1023LL);
    if (slot == ka) {
      slot = merged;
    } else if (slot == kb) {
      slot = kDead;
    }
    if (live && (node == ka || node == kb)) {
      ++len;
      node = merged;
    }
  }
  return len;
}

// The sum of v over the block, in every thread (wrapping as int64 does).
__device__ long long block_sum(long long v, long long* red) {
  unsigned long long s = (unsigned long long)v;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = (long long)s;
  __syncthreads();
  s = 0;
  for (int w = 0; w < kHuffWarps; ++w) s += (unsigned long long)red[w];
  return (long long)s;
}

template <typename T>
__global__ void __launch_bounds__(kHuffThreads)
huffman_tables_kernel(const T* __restrict__ counts, int* __restrict__ lengths,
                      uint32_t* __restrict__ codes, uint8_t* __restrict__ stream_ovf) {
  __shared__ long long part[2][kHuffWarps][2];
  __shared__ long long red[kHuffWarps];
  __shared__ int s_len[kPmax];
  __shared__ int s_cnt[kLens];

  const int s = blockIdx.x;
  const long long img = blockIdx.y;
  const int t = threadIdx.x;
  const int n = kSizes[s];
  const long long at = img * nt::kSymbols + kBase[s] + t;
  const bool live = t < n;
  long long count = live ? (long long)counts[at] : 0;

  int len = merge_lengths(count, live, n, part);
  if (__syncthreads_or(live && len > kMaxCodeLen)) {
    const long long floor_w = (block_sum(count, red) >> 20) + 1;  // format.huffman.clamp_floor
    count = max(count, floor_w);
    len = merge_lengths(count, live, n, part);
  }
  const int over = __syncthreads_or(live && len > kMaxCodeLen);

  // canonical codes: (length asc, symbol asc), counting up from 0
  if (t < kLens) s_cnt[t] = 0;
  if (t < kPmax) s_len[t] = len;
  __syncthreads();
  const bool coded = live && len >= 1 && len <= kLens;
  if (coded) atomicAdd(&s_cnt[len - 1], 1);
  __syncthreads();
  uint32_t code = 0u;
  if (coded) {
    long long first = 0;  // (first[l-1] + cnt[l-1]) * 2 from first[1] = 0, in int64
    for (int j = 1; j < len; ++j) first += (long long)s_cnt[j - 1] << (len - j);
    int rank = 0;
    for (int p = 0; p < t; ++p) rank += s_len[p] == len;
    code = (uint32_t)(first + rank);
  }
  if (live) {
    lengths[at] = len;
    codes[at] = code;
  }
  if (t == 0) stream_ovf[img * kStreams + s] = over ? 1 : 0;
}

}  // namespace

extern "C" {

// counts (B, 858) int32, or int64 where counts_are_64 is nonzero; lengths
// (B, 858) int32; codes (B, 858) uint32; stream_ovf (B, 10) bytes.
int nt_huffman_tables(const void* counts, int counts_are_64, void* lengths, void* codes,
                      void* stream_ovf, int B, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(kStreams, B);
  auto* len = static_cast<int*>(lengths);
  auto* cd = static_cast<uint32_t*>(codes);
  auto* ovf = static_cast<uint8_t*>(stream_ovf);
  if (counts_are_64) {
    huffman_tables_kernel<long long><<<grid, kHuffThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const long long*>(counts), len, cd, ovf);
  } else {
    huffman_tables_kernel<int><<<grid, kHuffThreads, 0, (cudaStream_t)stream>>>(
        static_cast<const int*>(counts), len, cd, ovf);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
