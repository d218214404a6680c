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
// One thread per group of 8 pixels: it walks the group's S (length, code)
// slots and packs them MSB-first into a left-aligned kCapw-word record kept
// in registers (the unrolled j loop keeps every index static), then writes
// the record words and the bit length k.  Bits past 32*kCapw are dropped;
// the caller flags k > 32*kCapw as overflow.  The arithmetic is that of the
// Pallas kernel step for step, including its clipped shift amounts and its
// update window j < s + 2, so overflowing groups agree too.  Bound by
// device-memory bandwidth: 8*S bytes read and 4*(kCapw+1) written per group;
// the slots load as int4.
// ---------------------------------------------------------------------------
constexpr int kCapw = 10;  // words per group record (320 bits)

__device__ __forceinline__ void fold_slot(int s, int L, uint32_t cd, int& cum,
                                          uint32_t (&rec)[kCapw]) {
  const int sw = cum >> 5;
  const int sb = cum & 31;
  const bool fits = sb + L <= 32;
  const int k = fits ? 0 : sb + L - 32;
  const int sh_hi = min(max(fits ? 32 - sb - L : k, 0), 31);
  const uint32_t hi = fits ? (cd << sh_hi) : (cd >> sh_hi);
  const uint32_t mask = k >= 32 ? 0xFFFFFFFFu : ((1u << k) - 1u);
  const int sh_lo = min(max(32 - k, 0), 31);
  const uint32_t lo = fits ? 0u : ((cd & mask) << sh_lo);
#pragma unroll
  for (int j = 0; j < kCapw; ++j) {
    if (j < s + 2) {
      uint32_t upd = (sw == j) ? hi : 0u;
      if (j > 0 && sw == j - 1) upd |= lo;
      rec[j] |= upd;
    }
  }
  cum += L;
}

__global__ void fold_records_kernel(const int* __restrict__ aob, const uint32_t* __restrict__ code,
                                    uint32_t* __restrict__ rec, int* __restrict__ kbits,
                                    int Mg, int S) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= Mg) return;
  const long long img = blockIdx.y;
  const long long off = (img * Mg + g) * S;
  uint32_t r[kCapw];
#pragma unroll
  for (int j = 0; j < kCapw; ++j) r[j] = 0u;
  int cum = 0;
  if ((S & 3) == 0 && aligned16(aob + off) && aligned16(code + off)) {
    const int4* a4 = reinterpret_cast<const int4*>(aob + off);
    const uint4* c4 = reinterpret_cast<const uint4*>(code + off);
    for (int v = 0; v < (S >> 2); ++v) {
      const int4 L = __ldg(a4 + v);
      const uint4 cd = __ldg(c4 + v);
      fold_slot(4 * v + 0, L.x, cd.x, cum, r);
      fold_slot(4 * v + 1, L.y, cd.y, cum, r);
      fold_slot(4 * v + 2, L.z, cd.z, cum, r);
      fold_slot(4 * v + 3, L.w, cd.w, cum, r);
    }
  } else {
    for (int s = 0; s < S; ++s) {
      fold_slot(s, __ldg(aob + off + s), __ldg(code + off + s), cum, r);
    }
  }
#pragma unroll
  for (int j = 0; j < kCapw; ++j) rec[(img * kCapw + j) * Mg + g] = r[j];
  kbits[img * Mg + g] = cum;
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
  constexpr int kFoldThreads = 128;
  dim3 grid((Mg + kFoldThreads - 1) / kFoldThreads, B);
  fold_records_kernel<<<grid, kFoldThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(aob), static_cast<const uint32_t*>(code),
      static_cast<uint32_t*>(rec), static_cast<int*>(kbits), Mg, S);
  return (int)cudaGetLastError();
}

}  // extern "C"
