// Helpers shared by the CUDA sources of nicetpu_torch (see build.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nt {

constexpr int kSymbols = 858;  // flat histogram bins; any other value is a hole
constexpr int kThreads = 256;
constexpr int kTargetBlocks = 132 * 8;  // 8 blocks for each of the H100's 132 SMs

// A batch's geometry table (kernels/geometry.py): (B, kGeoCols) int32, one
// row an image, its width in column 0 and its pixel count in column 1.  A
// kernel given no table (nullptr) takes its caller's scalars for every image.
constexpr int kGeoCols = 50;  // as geometry.COLS
__device__ __forceinline__ int geo_width(const int* geo, long long b, int width) {
  return geo != nullptr ? __ldg(geo + b * kGeoCols) : width;
}
__device__ __forceinline__ long long geo_pixels(const int* geo, long long b, long long n) {
  return geo != nullptr ? (long long)__ldg(geo + b * kGeoCols + 1) : n;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Asynchronous 4-byte copies from device memory into shared memory
// (cp.async).  A thread's copies since its last commit form one group;
// cp_async_wait<n> returns once all but its n newest groups have landed.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

// Contiguous slice [lo, hi) of one row of M elements for this block; lo is a
// multiple of 4 so that the int4 path starts aligned.  Rounding the slice up
// to a multiple of 4 can leave the last blocks with nothing: their slice is
// the empty [M, M).
__device__ __forceinline__ void block_slice(long long M, long long* lo, long long* hi) {
  long long per = (M + gridDim.x - 1) / gridDim.x;
  per = (per + 3) & ~3LL;
  *lo = min(M, per * blockIdx.x);
  *hi = min(M, *lo + per);
}

// Blocks along one row so that `rows` rows together fill the card.
inline int blocks_per_row(long long M, int rows) {
  long long want = (kTargetBlocks + rows - 1) / rows;
  long long most = (M + 1023) / 1024;  // at least ~1024 elements per block
  long long n = want < most ? want : most;
  return n < 1 ? 1 : (int)n;
}

}  // namespace nt
