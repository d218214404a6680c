// CUDA kernels of the fused encode (nicetpu_torch), for sm_90a.
//
// Built by nicetpu_torch/kernels/build.py with nvcc into a shared library
// with a plain C interface, loaded with ctypes; the wrappers and the plain
// PyTorch versions of each kernel live in nicetpu_torch/kernels/cuda_ops.py.
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so that a refused launch is reported.
//
// uint32 payload values (codes, records) arrive as int32 tensors holding
// the bit patterns; the kernels read and write them as uint32_t.

#include "common.cuh"

namespace {

using nt::aligned16;
using nt::block_slice;
using nt::kSymbols;
using nt::kThreads;

// ---------------------------------------------------------------------------
// histogram: replaces nicetpu/kernels/pallas_ops.py histogram_pallas
// (_hist_kernel), which counts bins with one-hot bf16 matmuls on the MXU.
// Here each block counts its slice of one image into an 858-bin histogram in
// shared memory with integer atomics, then adds the nonzero bins into the
// (B, 858) output (zeroed by the wrapper) with one global atomic per bin.
// Bound by device-memory bandwidth (4 bytes read per token) and, on skewed
// histograms, by shared-atomic conflicts.  Integer atomics make the result
// exact and independent of order.
// ---------------------------------------------------------------------------
__global__ void histogram_kernel(const int* __restrict__ bins, int* __restrict__ out,
                                 long long M) {
  __shared__ int hist[kSymbols];
  for (int i = threadIdx.x; i < kSymbols; i += blockDim.x) hist[i] = 0;
  __syncthreads();

  const int* src = bins + (long long)blockIdx.y * M;
  long long lo, hi;
  block_slice(M, &lo, &hi);
  long long i = lo;
  if (aligned16(src + lo)) {
    const long long n4 = (hi - lo) >> 2;
    const int4* src4 = reinterpret_cast<const int4*>(src + lo);
    for (long long v = threadIdx.x; v < n4; v += blockDim.x) {
      const int4 b = __ldg(src4 + v);
      if ((unsigned)b.x < kSymbols) atomicAdd(&hist[b.x], 1);
      if ((unsigned)b.y < kSymbols) atomicAdd(&hist[b.y], 1);
      if ((unsigned)b.z < kSymbols) atomicAdd(&hist[b.z], 1);
      if ((unsigned)b.w < kSymbols) atomicAdd(&hist[b.w], 1);
    }
    i = lo + 4 * n4;
  }
  for (i += threadIdx.x; i < hi; i += blockDim.x) {
    const unsigned b = (unsigned)__ldg(src + i);
    if (b < kSymbols) atomicAdd(&hist[b], 1);
  }
  __syncthreads();

  int* dst = out + (long long)blockIdx.y * kSymbols;
  for (int b = threadIdx.x; b < kSymbols; b += blockDim.x) {
    if (hist[b]) atomicAdd(&dst[b], hist[b]);
  }
}

// ---------------------------------------------------------------------------
// table_join: replaces pallas_ops.py table_join_pallas (_join_kernel), which
// gathers table bytes with one-hot matmuls.  Here each block loads its
// image's 858 code lengths and codes (about 7 KB) into shared memory and
// every thread maps its bins directly; holes map to (0, 0).  Bound by
// device-memory bandwidth: 4 bytes read and 8 written per token.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void join1(int b, const int* s_len, const uint32_t* s_code,
                                      int* L, uint32_t* cd) {
  const bool live = (unsigned)b < kSymbols;
  *L = live ? s_len[b] : 0;
  *cd = live ? s_code[b] : 0u;
}

__global__ void table_join_kernel(const int* __restrict__ bins, const int* __restrict__ lengths,
                                  const uint32_t* __restrict__ codes, int* __restrict__ aob,
                                  uint32_t* __restrict__ code, long long M) {
  __shared__ int s_len[kSymbols];
  __shared__ uint32_t s_code[kSymbols];
  const long long img = blockIdx.y;
  for (int i = threadIdx.x; i < kSymbols; i += blockDim.x) {
    s_len[i] = lengths[img * kSymbols + i];
    s_code[i] = codes[img * kSymbols + i];
  }
  __syncthreads();

  const long long base = img * M;
  long long lo, hi;
  block_slice(M, &lo, &hi);
  long long i = lo;
  if (aligned16(bins + base + lo) && aligned16(aob + base + lo) &&
      aligned16(code + base + lo)) {
    const long long n4 = (hi - lo) >> 2;
    const int4* src4 = reinterpret_cast<const int4*>(bins + base + lo);
    int4* aob4 = reinterpret_cast<int4*>(aob + base + lo);
    uint4* code4 = reinterpret_cast<uint4*>(code + base + lo);
    for (long long v = threadIdx.x; v < n4; v += blockDim.x) {
      const int4 b = __ldg(src4 + v);
      int4 L;
      uint4 cd;
      join1(b.x, s_len, s_code, &L.x, &cd.x);
      join1(b.y, s_len, s_code, &L.y, &cd.y);
      join1(b.z, s_len, s_code, &L.z, &cd.z);
      join1(b.w, s_len, s_code, &L.w, &cd.w);
      aob4[v] = L;
      code4[v] = cd;
    }
    i = lo + 4 * n4;
  }
  for (i += threadIdx.x; i < hi; i += blockDim.x) {
    join1(__ldg(bins + base + i), s_len, s_code, aob + base + i, code + base + i);
  }
}

// ---------------------------------------------------------------------------
// fold_records: replaces pallas_ops.py fold_records_pallas (_fold_kernel).
// One thread folds one group of 8 pixels: it packs the group's S (length,
// code) slots MSB-first into a left-aligned kCapw-word record and writes the
// record words and the bit length k.  Bits past 32*kCapw are dropped; the
// caller flags k > 32*kCapw as overflow.  Bound by device-memory bandwidth:
// 8*S bytes read and 4*(kCapw+1) written per group.
//
// The Pallas kernel keeps the record in ten vector registers and gives every
// slot a ten-way compare-select-or, because a register cannot be indexed at
// run time; one thread per group then reads its slots 4*S bytes apart from
// its neighbour's.  This kernel does neither:
//   * the slots of a block's kFoldThreads groups are one contiguous range of
//     device memory.  The block copies it into shared memory with cp.async,
//     kFoldTile slots of every group at a time into two buffers in turn, so
//     the next tile arrives under this tile's arithmetic.  The copies are 4
//     bytes each, a warp's covering two rows' 64 contiguous bytes, so any S
//     and any alignment take the same path (16-byte copies measured no
//     faster).  Each thread reads its own
//     row as int4; the row stride of kFoldTile + 4 words spreads a quarter
//     warp's 16-byte reads over all 32 banks.
//   * a slot at bit offset cum only touches words cum >> 5 and the one after,
//     and cum never falls, so the thread keeps just these two words (w0, w1)
//     in registers.  When cum >> 5 moves on, the finished word goes to the
//     thread's column of a shared-memory record tile, where a run-time index
//     costs nothing.  The two words a slot contributes come from the same
//     expressions as the generic fold's (slot_words), so codes with bits
//     above their length, zero-length slots and 32-bit lengths give the
//     same bits.  The record is then written out word by word, neighbouring
//     threads to neighbouring addresses.
// The window holds for lengths 0..32 (cum >> 5 then advances by at most one
// a slot, and never beyond the Pallas kernel's update window j < s + 2).  A
// group with any other length, which only an image that is re-encoded on the
// host can hold, is folded again by fold_group_generic, the ten-register
// fold whose arithmetic is the Pallas kernel's step for step, clipped shift
// amounts and update window included.
// ---------------------------------------------------------------------------
constexpr int kCapw = 10;          // words per group record (320 bits)
constexpr int kFoldThreads = 128;  // groups (threads) a block
constexpr int kFoldTile = 16;      // slots of every group a staged tile
constexpr int kFoldStride = kFoldTile + 4;  // words between rows of a tile
constexpr int kFoldStage = kFoldThreads * kFoldStride;  // words a buffer
// two buffers each of lengths and codes, and the record tile
constexpr int kFoldSmemBytes = (4 * kFoldStage + kCapw * kFoldThreads) * 4;
static_assert(kFoldSmemBytes <= 48 * 1024, "the fold's shared memory is launched without opt-in");
static_assert(kFoldTile % 4 == 0 && kFoldStride % 4 == 0, "rows of a tile are read as int4");

// The two record words a slot of length L and code cd contributes at bit
// offset sb of a word: hi into that word, lo into the next.
__device__ __forceinline__ void slot_words(int sb, int L, uint32_t cd, uint32_t& hi,
                                           uint32_t& lo) {
  const bool fits = sb + L <= 32;
  const int k = fits ? 0 : sb + L - 32;
  const int sh_hi = min(max(fits ? 32 - sb - L : k, 0), 31);
  hi = fits ? (cd << sh_hi) : (cd >> sh_hi);
  const uint32_t mask = k >= 32 ? 0xFFFFFFFFu : ((1u << k) - 1u);
  const int sh_lo = min(max(32 - k, 0), 31);
  lo = fits ? 0u : ((cd & mask) << sh_lo);
}

// The generic fold of one group, for any int32 lengths: the record in ten
// registers, every slot a kCapw-way select.  Writes the record into the
// thread's column of the record tile and returns the bit length.
__device__ __noinline__ int fold_group_generic(const int* __restrict__ aob,
                                               const uint32_t* __restrict__ code, int S,
                                               uint32_t* col) {
  uint32_t r[kCapw];
#pragma unroll
  for (int j = 0; j < kCapw; ++j) r[j] = 0u;
  int cum = 0;
  for (int s = 0; s < S; ++s) {
    const int L = __ldg(aob + s);
    const int sw = cum >> 5;
    uint32_t hi, lo;
    slot_words(cum & 31, L, __ldg(code + s), hi, lo);
#pragma unroll
    for (int j = 0; j < kCapw; ++j) {
      if (j < s + 2) {
        uint32_t upd = (sw == j) ? hi : 0u;
        if (j > 0 && sw == j - 1) upd |= lo;
        r[j] |= upd;
      }
    }
    cum += L;
  }
#pragma unroll
  for (int j = 0; j < kCapw; ++j) col[j * kFoldThreads] = r[j];
  return cum;
}

// A thread's fold in flight: w0 and w1 are record words cur and cur + 1.
struct FoldWindow {
  uint32_t w0 = 0u, w1 = 0u;
  int cum = 0, cur = 0;
  uint32_t seen = 0u;  // largest length, as unsigned: over 32 if any is outside 0..32
};

__device__ __forceinline__ void window_slot(int L, uint32_t cd, FoldWindow& f, uint32_t* col) {
  const int sw = f.cum >> 5;
  uint32_t hi, lo;
  slot_words(f.cum & 31, L, cd, hi, lo);
  if (sw != f.cur) {  // word cur is finished
    if ((unsigned)f.cur < kCapw) col[f.cur * kFoldThreads] = f.w0;
    f.w0 = f.w1;
    f.w1 = 0u;
    f.cur = sw;
  }
  f.w0 |= hi;
  f.w1 |= lo;
  f.cum += L;
  f.seen = max(f.seen, (uint32_t)L);
}

__global__ void __launch_bounds__(kFoldThreads)
fold_records_kernel(const int* __restrict__ aob, const uint32_t* __restrict__ code,
                    uint32_t* __restrict__ rec, int* __restrict__ kbits, int Mg, int S) {
  extern __shared__ __align__(16) uint32_t fold_smem[];
  uint32_t* s_len = fold_smem;                   // [2][kFoldStage]
  uint32_t* s_code = fold_smem + 2 * kFoldStage;  // [2][kFoldStage]
  uint32_t* col = fold_smem + 4 * kFoldStage + threadIdx.x;  // record tile [kCapw][kFoldThreads]

  const int tid = threadIdx.x;
  const long long img = blockIdx.y;
  const int g0 = blockIdx.x * kFoldThreads;
  const int rows = min(kFoldThreads, Mg - g0);
  const long long base = (img * Mg + g0) * S;  // the block's first slot
  const int tiles = (S + kFoldTile - 1) / kFoldTile;

  auto fetch = [&](int p) {  // start the copy of tile p: slots [p*kFoldTile, +kFoldTile) of every row
    const int c0 = p * kFoldTile;
    uint32_t* dl = s_len + (p & 1) * kFoldStage;
    uint32_t* dc = s_code + (p & 1) * kFoldStage;
    for (int i = tid; i < kFoldThreads * kFoldTile; i += kFoldThreads) {
      const int r = i / kFoldTile;
      const int c = i % kFoldTile;
      if (r < rows && c0 + c < S) {
        const long long src = base + (long long)r * S + c0 + c;
        nt::cp_async4(dl + r * kFoldStride + c, aob + src);
        nt::cp_async4(dc + r * kFoldStride + c, code + src);
      }
    }
    nt::cp_async_commit();
  };

  FoldWindow f;
  fetch(0);
  for (int p = 0; p < tiles; ++p) {
    if (p + 1 < tiles) {
      fetch(p + 1);
      nt::cp_async_wait<1>();
    } else {
      nt::cp_async_wait<0>();
    }
    __syncthreads();  // tile p has landed for every thread
    if (tid < rows) {
      const uint32_t* rl = s_len + (p & 1) * kFoldStage + tid * kFoldStride;
      const uint32_t* rc = s_code + (p & 1) * kFoldStage + tid * kFoldStride;
      const int left = S - p * kFoldTile;
      if (left >= kFoldTile) {
#pragma unroll
        for (int v = 0; v < kFoldTile / 4; ++v) {
          const uint4 L = reinterpret_cast<const uint4*>(rl)[v];
          const uint4 cd = reinterpret_cast<const uint4*>(rc)[v];
          window_slot((int)L.x, cd.x, f, col);
          window_slot((int)L.y, cd.y, f, col);
          window_slot((int)L.z, cd.z, f, col);
          window_slot((int)L.w, cd.w, f, col);
        }
      } else {
        for (int c = 0; c < left; ++c) window_slot((int)rl[c], rc[c], f, col);
      }
    }
    __syncthreads();  // before the copy of tile p + 2 overwrites this buffer
  }
  if (tid >= rows) return;

  const long long row = base + (long long)tid * S;
  if (f.seen > 32u) {  // a length outside 0..32: the window does not hold
    f.cum = fold_group_generic(aob + row, code + row, S, col);
    f.cur = kCapw;
  }
  const long long g = g0 + tid;
#pragma unroll
  for (int j = 0; j < kCapw; ++j) {
    uint32_t w = 0u;  // words the fold never reached
    if (j < f.cur) w = col[j * kFoldThreads];
    else if (j == f.cur) w = f.w0;
    else if (j == f.cur + 1) w = f.w1;
    rec[(img * kCapw + j) * Mg + g] = w;
  }
  kbits[img * Mg + g] = f.cum;
}

}  // namespace

extern "C" {

const char* nt_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int nt_histogram(const void* bins, void* out, int B, long long M, int device,
                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nt::blocks_per_row(M, B), B);
  histogram_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(bins), static_cast<int*>(out), M);
  return (int)cudaGetLastError();
}

int nt_table_join(const void* bins, const void* lengths, const void* codes, void* aob,
                  void* code, int B, long long M, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nt::blocks_per_row(M, B), B);
  table_join_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(bins), static_cast<const int*>(lengths),
      static_cast<const uint32_t*>(codes), static_cast<int*>(aob),
      static_cast<uint32_t*>(code), M);
  return (int)cudaGetLastError();
}

int nt_fold_records(const void* aob, const void* code, void* rec, void* kbits, int B, int Mg,
                    int S, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Mg + kFoldThreads - 1) / kFoldThreads, B);
  fold_records_kernel<<<grid, kFoldThreads, kFoldSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const int*>(aob), static_cast<const uint32_t*>(code),
      static_cast<uint32_t*>(rec), static_cast<int*>(kbits), Mg, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
