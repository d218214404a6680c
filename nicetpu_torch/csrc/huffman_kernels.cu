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
// The algorithm.  Keys are the plain version's packed int64
// weight << 11 | internal << 10 | min_symbol, so that the ordinary minimum
// is the reference's node (weight asc, leaves first, least symbol).  A
// merge writes the merged node into the slot of the smaller of the two keys
// and kills the other slot, so the n leaf slots hold every live node; each
// symbol keeps its code length and the key of the node that holds it, and
// since keys are unique among live nodes a symbol is under a merged node
// exactly when its key is one of the two minima.  Stream s runs
// ALPHABET_SIZES[s] - 2 merge steps, 341 down to 9.
//
// What bounds it.  The counts and tables are a few kilobytes, so bytes do
// not, and the comparisons (about n^2 a stream) take well under a
// microsecond of the card's integer rate.  The bound is the chain of
// dependent merge steps: each step's two minima wait on the last step's
// slots.  So the design makes a step as short as a warp can run it, and
// keeps the chain at 341 steps:
//   * One warp a merge chain, its state in registers.  Lane l holds slots
//     and symbols l, l + 32, ... (K = ceil(n / 32) of each, at most 11) and
//     the two least keys of its own slots.  A step is two warp minima, the
//     warp's least key and then its least once the lane that held it offers
//     its second, with no shared memory and no block barrier; then each
//     lane updates its slots and recomputes its pair by a tree of pair-mins.
//   * Where the counts and the stream's total stay below 2^20 (every stream
//     of a 512^2 image), a key fits an int: each minimum is one
//     __reduce_min_sync, and the updates are sign masks with no predicate
//     (see Narrow); as equality tests and selects they chain through one
//     predicate register and the kernel takes 1.5x as long.  Else int64
//     keys: the high words, then the low words of the lanes that tie, and
//     equality tests.  A step's symbol updates run while the next step's
//     first minimum is in flight.
//   * The clamp re-merge beside the first merge.  Block (image, stream) has
//     two warps: warp 0 merges the counts, warp 1 at the same time the
//     counts raised to max(c, (total >> 20) + 1) (format.huffman.clamp_floor).
//     Warp 1's lengths are taken only where warp 0's pass 31 bits, as the
//     plain version re-merges only those streams: the longest chain is the
//     343-symbol stream's 341 steps instead of 2 x 254 after one another.
//   * Small blocks: 64 threads, grid (B, 10), so the 10 B chains of a
//     launch run at once and a stream's blocks are dispatched one after
//     another; with the stream index fastest, B = 32 took 1.4x as long as
//     B = 8.  (Both ratios: bench_huffman_ablation on an H100.)
//   * Canonical codes by the selected warp, 32 symbols a chunk: a symbol's
//     rank is the running count of its length plus the lower lanes of its
//     chunk with the same length (__match_any_sync); lane L - 1 sums length
//     L's first code from the counts.  Arithmetic in uint32 gives the low 32
//     bits of the plain version's int64 sums.  The block writes its
//     stream's overflow flag; the wrapper ORs the ten flags of an image.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kStreams = 10;
constexpr int kLanes = 32;
constexpr int kMaxCodeLen = 31;         // the 5-bit max_aob header field
constexpr int kLens = kMaxCodeLen + 1;  // lengths 1..32 get codes, as in the plain version
constexpr int kHuffThreads = 64;        // warp 0: the counts; warp 1: the clamped counts
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kNarrow = 1LL << 20;  // counts and total below this: 31-bit keys in an int

__constant__ int kSizes[kStreams] = {256, 13, 64, 32, 11, 343, 64, 32, 32, 11};
__constant__ int kBase[kStreams] = {0, 256, 269, 333, 365, 376, 719, 783, 815, 847};

// int keys, for counts and a total below 2^20: weights below 2^20, so every
// live key is below 2^31 - 1, the dead key, and the difference of two keys
// fits an int.  Since ka and kb are the two least live keys and every slot
// and every symbol's node holds a live key or the dead one, a key is ka or
// kb exactly when it is at most kb, and ka exactly when it is at most ka:
// the sign of kb - key decides, and the updates are masks with no predicate.
struct Narrow {
  using Key = int;
  static constexpr Key kDead = INT_MAX;
  __device__ static Key leaf(long long count, int sym) { return ((int)count << 11) | sym; }
  __device__ static Key warp_min(Key k) { return __reduce_min_sync(kFull, k); }
  __device__ static Key merged(Key ka, Key kb) {
    return (((ka >> 11) + (kb >> 11)) << 11) | 1024 | min(ka & 1023, kb & 1023);
  }
  // the slot's key after the step: ka's slot takes the merged node, kb's dies
  __device__ static Key slot_after(Key s, Key ka, Key kb, Key merged) {
    const int not_ab = (kb - s) >> 31, not_a = (ka - s) >> 31;  // all ones, or 0
    const int x = (s & not_ab) | (kDead & ~not_ab);
    return (x & not_a) | (merged & ~not_a);
  }
  // a symbol under ka or kb gains a bit and takes the merged key
  __device__ static void move_symbol(Key& node, int& len, Key ka, Key kb, Key merged) {
    const int not_ab = (kb - node) >> 31;
    len += 1 + not_ab;
    node = (node & not_ab) | (merged & ~not_ab);
  }
};

// int64 keys, in the plain version's two's complement arithmetic: shifts
// and sums go through uint64 so that they wrap as torch's int64 do.
struct Wide {
  using Key = long long;
  static constexpr Key kDead = LLONG_MAX;
  __device__ static Key leaf(long long count, int sym) {
    return (long long)(((unsigned long long)count << 11) | (unsigned)sym);
  }
  // The high words with the sign bit flipped (unsigned order is then int64
  // order), then the low words of the lanes that hold the least high word.
  __device__ static Key warp_min(Key k) {
    const unsigned hi = (unsigned)((unsigned long long)k >> 32) ^ 0x80000000u;
    const unsigned h = __reduce_min_sync(kFull, hi);
    const unsigned l = __reduce_min_sync(kFull, hi == h ? (unsigned)k : 0xffffffffu);
    return (long long)(((unsigned long long)(h ^ 0x80000000u) << 32) | l);
  }
  __device__ static Key merged(Key ka, Key kb) {
    const unsigned long long w = (unsigned long long)(ka >> 11) + (unsigned long long)(kb >> 11);
    return (long long)((w << 11) | 1024ull) | min(ka & 1023LL, kb & 1023LL);
  }
  __device__ static Key slot_after(Key s, Key ka, Key kb, Key merged) {
    return s == ka ? merged : (s == kb ? kDead : s);
  }
  __device__ static void move_symbol(Key& node, int& len, Key ka, Key kb, Key merged) {
    const bool under = node == ka || node == kb;
    len += under;
    node = under ? merged : node;
  }
};

// (m1, m2) <- the two smallest of {m1, m2, b1, b2}, given m1 <= m2 and b1 <= b2.
template <typename Key>
__device__ __forceinline__ void pair_min(Key& m1, Key& m2, Key b1, Key b2) {
  const Key lo = min(m1, b1), hi = max(m1, b1);
  m2 = min(hi, min(m2, b2));
  m1 = lo;
}

// Folds pairs [0, W) into pair 0, halving the count each level.
template <int W, typename Key, int P>
__device__ __forceinline__ void fold_pairs(Key (&a)[P], Key (&b)[P]) {
  if constexpr (W > 1) {
    constexpr int H = (W + 1) / 2;
#pragma unroll
    for (int i = 0; i + H < W; ++i) pair_min(a[i], b[i], a[i + H], b[i + H]);
    fold_pairs<H>(a, b);
  }
}

// The two least of a lane's K keys, by a tree of depth 1 + 2 log2(K / 2).
template <class KT, int K>
__device__ __forceinline__ void least_two(const typename KT::Key (&v)[K], typename KT::Key& m1,
                                          typename KT::Key& m2) {
  using Key = typename KT::Key;
  constexpr int P = (K + 1) / 2;
  const Key dead = KT::kDead;
  Key a[P], b[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (2 * i + 1 < K) {
      a[i] = min(v[2 * i], v[2 * i + 1]);
      b[i] = max(v[2 * i], v[2 * i + 1]);
    } else {
      a[i] = v[2 * i];
      b[i] = dead;
    }
  }
  fold_pairs<P>(a, b);
  m1 = a[0];
  m2 = b[0];
}

// A symbol of the merged nodes ka and kb gains a bit and takes the merged key.
template <class KT, int K>
__device__ __forceinline__ void move_symbols(typename KT::Key (&node)[K], int (&len)[K], typename KT::Key ka,
                                             typename KT::Key kb, typename KT::Key merged) {
#pragma unroll
  for (int j = 0; j < K; ++j) KT::move_symbol(node[j], len[j], ka, kb, merged);
}

// This warp's merge of the stream's n leaves: len[j] becomes the code
// length of symbol 32 j + lane (0 past the alphabet).
template <class KT, int K>
__device__ void merge_lengths(const long long (&count)[K], int n, int (&len)[K]) {
  using Key = typename KT::Key;
  const int lane = threadIdx.x & (kLanes - 1);
  const Key dead = KT::kDead;
  Key slot[K], node[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int p = kLanes * j + lane;
    slot[j] = p < n ? KT::leaf(count[j], p) : dead;
    node[j] = slot[j];
    len[j] = p < n;
  }
  Key m1, m2;
  least_two<KT>(slot, m1, m2);
  // the previous step's pair and merged key; -1 is no node's key (its low
  // 10 bits are 1023, no symbol) and lies below every key, so neither test
  // takes it and the first step moves no symbol
  Key pa = -1, pb = pa, pm = pa;
  for (int it = 0; it < n - 2; ++it) {
    const Key ka = KT::warp_min(m1);
    move_symbols<KT>(node, len, pa, pb, pm);  // the previous step's, while the minimum is in flight
    const Key kb = KT::warp_min(m1 == ka ? m2 : m1);
    const Key merged = KT::merged(ka, kb);
#pragma unroll
    for (int j = 0; j < K; ++j) slot[j] = KT::slot_after(slot[j], ka, kb, merged);
    least_two<KT>(slot, m1, m2);
    pa = ka;
    pb = kb;
    pm = merged;
  }
  move_symbols<KT>(node, len, pa, pb, pm);
}

// The sum of v over the warp, in every lane (wrapping as int64 does).
__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Block (image img, stream s): both merges, the selection, the codes.
template <typename T, int K>
__device__ void stream_tables(const T* __restrict__ counts, int* __restrict__ lengths,
                              uint32_t* __restrict__ codes, uint8_t* __restrict__ stream_ovf, int s,
                              long long img, int* s_over, unsigned* s_cnt, unsigned* s_first) {
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x & (kLanes - 1);
  const int n = kSizes[s];
  const long long row = img * nt::kSymbols + kBase[s];
  long long count[K];
  unsigned long long sum = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int p = kLanes * j + lane;
    count[j] = p < n ? (long long)counts[row + p] : 0;
    sum += (unsigned long long)count[j];
  }
  if (warp == 1) {  // the clamped counts: max(c, (total >> 20) + 1) on the live symbols
    const long long floor_w = ((long long)warp_sum(sum) >> 20) + 1;
    sum = 0;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (kLanes * j + lane < n) count[j] = max(count[j], floor_w);
      sum += (unsigned long long)count[j];
    }
  }
  bool small = true;
#pragma unroll
  for (int j = 0; j < K; ++j) small &= count[j] >= 0 && count[j] < kNarrow;
  const bool narrow = __all_sync(kFull, small) && warp_sum(sum) < (unsigned long long)kNarrow;
  int len[K];
  if (narrow) {
    merge_lengths<Narrow>(count, n, len);
  } else {
    merge_lengths<Wide>(count, n, len);
  }
  bool over = false;
#pragma unroll
  for (int j = 0; j < K; ++j) over |= len[j] > kMaxCodeLen;
  over = __any_sync(kFull, over);
  if (lane == 0) s_over[warp] = over;
  if (threadIdx.x < kLens) s_cnt[threadIdx.x] = 0;
  __syncthreads();
  // the clamped merge only where the first passes 31 bits
  const int sel = s_over[0] ? 1 : 0;
  if (warp != sel) return;

  // canonical codes: (length asc, symbol asc), counting up from 0
  const unsigned below = (1u << lane) - 1u;
  unsigned rank[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int l = len[j];
    const bool coded = l >= 1 && l <= kLens;
    const unsigned same = __match_any_sync(kFull, l);
    rank[j] = coded ? s_cnt[l - 1] + __popc(same & below) : 0u;
    __syncwarp();
    if (coded && (same & below) == 0) s_cnt[l - 1] += __popc(same);
    __syncwarp();
  }
  unsigned first = 0;  // length lane + 1: sum over j of cnt[j - 1] << (lane + 1 - j)
  for (int j = 1; j <= lane; ++j) first += s_cnt[j - 1] << (lane + 1 - j);
  s_first[lane] = first;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int p = kLanes * j + lane;
    if (p < n) {
      const int l = len[j];
      lengths[row + p] = l;
      codes[row + p] = l >= 1 && l <= kLens ? s_first[l - 1] + rank[j] : 0u;
    }
  }
  if (lane == 0) stream_ovf[img * kStreams + s] = s_over[sel] ? 1 : 0;
}

template <typename T>
__global__ void __launch_bounds__(kHuffThreads)
huffman_tables_kernel(const T* __restrict__ counts, int* __restrict__ lengths,
                      uint32_t* __restrict__ codes, uint8_t* __restrict__ stream_ovf) {
  __shared__ int s_over[2];
  __shared__ unsigned s_cnt[kLens];    // symbols of each length 1..32
  __shared__ unsigned s_first[kLens];  // each length's first code
  const int s = blockIdx.y;
  const long long img = blockIdx.x;
  switch ((kSizes[s] + kLanes - 1) / kLanes) {  // slots a lane: 8, 1, 2, 1, 1, 11, 2, 1, 1, 1
    case 1:
      stream_tables<T, 1>(counts, lengths, codes, stream_ovf, s, img, s_over, s_cnt, s_first);
      break;
    case 2:
      stream_tables<T, 2>(counts, lengths, codes, stream_ovf, s, img, s_over, s_cnt, s_first);
      break;
    case 8:
      stream_tables<T, 8>(counts, lengths, codes, stream_ovf, s, img, s_over, s_cnt, s_first);
      break;
    default:
      stream_tables<T, 11>(counts, lengths, codes, stream_ovf, s, img, s_over, s_cnt, s_first);
      break;
  }
}

}  // namespace

extern "C" {

// counts (B, 858) int32, or int64 where counts_are_64 is nonzero; lengths
// (B, 858) int32; codes (B, 858) uint32; stream_ovf (B, 10) bytes.
int nt_huffman_tables(const void* counts, int counts_are_64, void* lengths, void* codes,
                      void* stream_ovf, int B, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B, kStreams);  // a stream's blocks one after another
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
