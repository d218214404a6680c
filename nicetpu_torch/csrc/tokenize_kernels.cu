// The tokenizer of the encode (nicetpu_torch), for sm_90a: a raster's
// pixels -> flat histogram bins in serial slot order, and a run-digit
// overflow flag per image.
//
// Replaces nicetpu/kernels/encode2.py:46 `_tokenize_core`, with
// nicetpu/kernels/tokenize.py:36 `cascade` and :233 `assemble_bins`: jnp
// code that XLA runs inside the jitted `tokenize_compact` and `encode_fused`
// as part of one device program (no Pallas kernel).  Its plain PyTorch
// version is nicetpu_torch/kernels/tokenize.py `tokenize_bins_plain`, about
// three hundred small torch operations; the wrappers are in
// nicetpu_torch/kernels/cuda_ops.py.  Built by nicetpu_torch/kernels/build.py
// like the other sources: a plain C interface, launches on the caller's
// stream, allocates nothing, returns cudaGetLastError().
//
// Three launches a call:
//   1. tile_first_kernel: each tile of kTile pixels writes its first
//      changed position (or n_total);
//   2. tile_suffix_kernel: one block an image turns those into the first
//      change at or after each tile, in place, and writes n_total past the
//      last tile;
//   3. tokenize_kernel: one thread a pixel runs the mode cascade, finds the
//      next change inside its tile by a warp ballot and a shared-memory
//      minimum over the tile's later warps, beyond it from (2) and the
//      optional tail (the first changes of later shards), and writes its
//      5 + ndigits_cap bins as whole 16-byte vectors.
// The sharded encode runs (1)-(2) first, all-gathers each shard's first
// change, then runs (3) with the later shards' firsts as its tail.
//
// Bound by bytes: 3 bytes read a pixel and 4 * (5 + ndigits_cap) written
// (32 at 3 run digits), a few hundred integer operations a pixel.  The
// probes read the raster straight from device memory at up to 3W + 3 pixels
// back; a block's four row windows (about 3 KB) stay in L1 and a batch in
// L2, so the pixels leave device memory about once.  The stores are
// coalesced 16-byte vectors, a warp's 32 pixels one contiguous span of bins.
// Positions are int (rasters hold fewer than 2^31 pixels); flat bin indices
// are int64.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kTile = 256;  // pixels a tile, threads a block in passes 1 and 3; as cuda_ops.TOKENIZE_TILE
constexpr int kWarps = kTile / 32;
constexpr int kSuffixThreads = 1024;
constexpr int kMaxRunDigits = 11;

// flat histogram bins of the ten streams (format/constants.py STREAM_BASE)
constexpr int kRgb = 0, kPrefixes = 256, kLumaBaseDiff = 269, kLumaOtherDiff = 333,
              kLumaBackRef = 365, kSmallDiff = 376, kLumaBaseDiff2 = 719, kLumaOtherDiff2 = 783,
              kLumaOtherDiffB2 = 815, kBackRef = 847;
// mode prefixes (format/constants.py)
constexpr int kModeBackRef = 0, kModeRgb = 1, kModeLuma = 2, kModeSmallDiff = 3, kModeLuma2 = 4,
              kRunBase = 5;

struct Px {
  int r, g, b;
};

// Pixel k of one image's halo-extended raster; zeros before its start, as
// the plain version's zero-padded shifts read.
__device__ __forceinline__ Px load_px(const uint8_t* __restrict__ img, long long k) {
  if (k < 0) return {0, 0, 0};
  const uint8_t* p = img + 3 * k;
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

__device__ __forceinline__ bool same(Px a, Px b) { return a.r == b.r && a.g == b.g && a.b == b.b; }

// A pixel starts a token when it differs from the one before it, or is
// pixel 0 of the raster.
__device__ __forceinline__ bool is_change(const uint8_t* img, long long k, int pos, Px cur) {
  return pos == 0 || !same(cur, load_px(img, k - 1));
}

// COLOR_LUMA's differences against a reference pixel, and whether they fit
__device__ __forceinline__ bool luma(Px c, int rr, int rg, int rb, int* dg, int* dr, int* db) {
  *dg = (c.g - rg) & 255;
  *dr = (c.r - rr - *dg) & 255;
  *db = (c.b - rb - *dg) & 255;
  return (*dg >= 224 || *dg < 32) && (*dr >= 240 || *dr < 16) && (*db >= 240 || *db < 16);
}

// Pass 1: grid (tiles, B).  tiles[b][t] = first changed global position of
// tile t, else n_total.
__global__ void tile_first_kernel(const uint8_t* __restrict__ x, int* __restrict__ tiles,
                                  long long n_ext, long long halo, int n_local, int g0,
                                  int n_total, int T) {
  __shared__ unsigned warp_min[kWarps];
  const int b = blockIdx.y, t = blockIdx.x;
  const uint8_t* img = x + (long long)b * n_ext * 3;
  const int i = t * kTile + (int)threadIdx.x;
  unsigned v = (unsigned)n_total;
  if (i < n_local) {
    const long long k = halo + i;
    if (is_change(img, k, g0 + i, load_px(img, k))) v = (unsigned)(g0 + i);
  }
  v = __reduce_min_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) v = min(v, warp_min[w]);
    tiles[(long long)b * (T + 1) + t] = (int)v;
  }
}

// Pass 2: grid B, kSuffixThreads threads.  Thread s takes a contiguous
// segment of the image's tiles; a Hillis-Steele suffix minimum over the
// segments' minima gives each thread what lies after its segment, and it
// then rewrites its segment back to front.
__global__ void tile_suffix_kernel(int* __restrict__ tiles, int T, int n_total) {
  __shared__ int seg[kSuffixThreads];
  const int s = threadIdx.x;
  int* row = tiles + (long long)blockIdx.x * (T + 1);
  const int per = (T + kSuffixThreads - 1) / kSuffixThreads;
  const int lo = min(T, s * per), hi = min(T, lo + per);
  int m = n_total;
  for (int k = lo; k < hi; ++k) m = min(m, row[k]);
  seg[s] = m;
  __syncthreads();
  for (int d = 1; d < kSuffixThreads; d <<= 1) {
    const int other = s + d < kSuffixThreads ? seg[s + d] : n_total;
    __syncthreads();
    seg[s] = min(seg[s], other);
    __syncthreads();
  }
  int run = s + 1 < kSuffixThreads ? seg[s + 1] : n_total;
  for (int k = hi - 1; k >= lo; --k) {
    run = min(run, row[k]);
    row[k] = run;
  }
  if (s == 0) row[T] = n_total;
}

// Pass 3: grid (tiles, B), kTile threads, one a pixel.  kCap run-digit
// slots; S = 5 + kCap bins a pixel.
template <int kCap>
__global__ void __launch_bounds__(kTile) tokenize_kernel(
    const uint8_t* __restrict__ x, const int* __restrict__ tiles, const int* __restrict__ tail,
    int n_tail, int* __restrict__ bins, uint8_t* __restrict__ ovf, long long n_ext, long long halo,
    int n_local, int g0, int n_total, int W, int T, int invalid) {
  constexpr int S = 5 + kCap;
  __shared__ int warp_first[kWarps];
  const int b = blockIdx.y, t = blockIdx.x;
  const int lane = (int)threadIdx.x & 31, warp = (int)threadIdx.x >> 5;
  const uint8_t* img = x + (long long)b * n_ext * 3;
  const int i = t * kTile + (int)threadIdx.x;
  const bool live = i < n_local;
  const int pos = g0 + i;
  const long long k = halo + i;
  const Px c = live ? load_px(img, k) : Px{0, 0, 0};
  const bool enc = live && is_change(img, k, pos, c);

  // the next change after this pixel: in its warp, in a later warp of the
  // tile, in a later tile, or in a later shard (the tail)
  const unsigned ballot = __ballot_sync(0xffffffffu, enc);
  if (lane == 0) warp_first[warp] = ballot ? pos + __ffs(ballot) - 1 : INT_MAX;
  __syncthreads();
  if (!live) return;
  const unsigned later = lane == 31 ? 0u : ballot & (0xffffffffu << (lane + 1));
  int next = later ? pos - lane + __ffs(later) - 1 : INT_MAX;
  for (int w = warp + 1; w < kWarps; ++w) next = min(next, warp_first[w]);
  next = min(next, __ldg(tiles + (long long)b * (T + 1) + t + 1));
  for (int j = 0; j < n_tail; ++j) next = min(next, __ldg(tail + j));

  // the mode cascade (tokenize.cascade)
  const bool row0 = pos < W;
  const Px p = load_px(img, k - 1), u = load_px(img, k - W);
  const int back[5] = {1, W, W - 1, 2, 2 * W};
  int br_idx = -1;
#pragma unroll
  for (int q = 0; q < 5; ++q) {
    if (br_idx < 0 && pos >= back[q] && same(c, load_px(img, k - back[q]))) br_idx = q;
  }
  const int ar = (u.r + p.r) >> 1, ag = (u.g + p.g) >> 1, ab = (u.b + p.b) >> 1;
  const int sr = c.r - (row0 ? p.r : ar), sg = c.g - (row0 ? p.g : ag), sb = c.b - (row0 ? p.b : ab);
  const bool sd = pos > 0 && abs(sr) <= 3 && abs(sg) <= 3 && abs(sb) <= 3;
  const int sd_code = (3 + sr) + 7 * (3 + sg) + 49 * (3 + sb);
  int l2g, l2r, l2b;
  const bool l2 = luma(c, ar, ag, ab, &l2g, &l2r, &l2b) && !row0;
  const int lref[11] = {1, W, W - 1, W - 3, 3, 3 * W - 1, 3 * W, 3 * W + 1, W + 3, 3 * W + 3, 3 * W - 3};
  int lu_idx = -1, lug = 0, lur = 0, lub = 0;
#pragma unroll
  for (int q = 0; q < 11; ++q) {
    if (lu_idx < 0 && pos >= lref[q]) {
      const Px r = load_px(img, k - lref[q]);
      int dg, dr, db;
      if (luma(c, r.r, r.g, r.b, &dg, &dr, &db)) {
        lu_idx = q;
        lug = dg, lur = dr, lub = db;
      }
    }
  }
  const bool first = pos > 0;
  const int rr = (c.r - (row0 ? (first ? p.r : 0) : ar)) & 255;
  const int rg = (c.g - (row0 ? (first ? p.g : 0) : ag)) & 255;
  const int rb = (c.b - (row0 ? (first ? p.b : 0) : ab)) & 255;
  const int mode = br_idx >= 0 ? kModeBackRef
                   : sd        ? kModeSmallDiff
                   : l2        ? kModeLuma2
                   : lu_idx >= 0 ? kModeLuma
                                 : kModeRgb;

  // the slots (tokenize.assemble_bins)
  int out[S];
  out[0] = enc ? kPrefixes + mode : invalid;
  int s1, s2, s3;
  switch (mode) {
    case kModeBackRef: s1 = kBackRef + br_idx; s2 = s3 = invalid; break;
    case kModeSmallDiff: s1 = kSmallDiff + sd_code; s2 = s3 = invalid; break;
    case kModeLuma2:
      s1 = kLumaBaseDiff2 + ((l2g + 32) & 255);
      s2 = kLumaOtherDiff2 + ((l2r + 16) & 255);
      s3 = kLumaOtherDiffB2 + ((l2b + 16) & 255);
      break;
    case kModeLuma:
      s1 = kLumaBackRef + lu_idx;
      s2 = kLumaBaseDiff + ((lug + 32) & 255);
      s3 = kLumaOtherDiff + ((lur + 16) & 255);
      break;
    default: s1 = kRgb + rr; s2 = kRgb + rg; s3 = kRgb + rb;
  }
  out[1] = enc ? s1 : invalid;
  out[2] = enc ? s2 : invalid;
  out[3] = enc ? s3 : invalid;
  out[4] = enc && mode == kModeLuma ? kLumaOtherDiff + ((lub + 16) & 255) : invalid;
  // v = run - 1 in base 8, least significant digit first; ndigits is the
  // least d >= 1 with v < 8^d, i.e. ceil(bit length / 3)
  const int run = next - pos - 1;
  const bool has_run = enc && run > 0;
  const unsigned v = (unsigned)max(run - 1, 0);
  const int ndigits = max(1, (32 - __clz(v) + 2) / 3);
#pragma unroll
  for (int j = 0; j < kCap; ++j) {
    out[5 + j] = has_run && j < ndigits ? kPrefixes + (int)((v >> (3 * j)) & 7) + kRunBase : invalid;
  }
  if (kCap < kMaxRunDigits && has_run && ndigits > kCap) ovf[b] = 1;  // every writer stores 1

  int* dst = bins + ((long long)b * n_local + i) * S;
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int q = 0; q < S; q += 4) {
      reinterpret_cast<int4*>(dst)[q / 4] = make_int4(out[q], out[q + 1], out[q + 2], out[q + 3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < S; ++q) dst[q] = out[q];
  }
}

template <int kCap>
void launch_tokenize(dim3 grid, cudaStream_t stream, const uint8_t* x, const int* tiles,
                     const int* tail, int n_tail, int* bins, uint8_t* ovf, long long n_ext,
                     long long halo, int n_local, int g0, int n_total, int W, int T, int invalid) {
  tokenize_kernel<kCap><<<grid, kTile, 0, stream>>>(x, tiles, tail, n_tail, bins, ovf, n_ext, halo,
                                                    n_local, g0, n_total, W, T, invalid);
}

using LaunchFn = void (*)(dim3, cudaStream_t, const uint8_t*, const int*, const int*, int, int*,
                          uint8_t*, long long, long long, int, int, int, int, int, int);
constexpr LaunchFn kLaunch[kMaxRunDigits + 1] = {
    launch_tokenize<0>, launch_tokenize<1>, launch_tokenize<2>, launch_tokenize<3>,
    launch_tokenize<4>, launch_tokenize<5>, launch_tokenize<6>, launch_tokenize<7>,
    launch_tokenize<8>, launch_tokenize<9>, launch_tokenize<10>, launch_tokenize<11>};

int tiles_of(long long n_local) { return (int)((n_local + kTile - 1) / kTile); }

}  // namespace

extern "C" {

// Passes 1 and 2: tiles (B, T + 1) int32, T = ceil(n_local / kTile).
int nt_tokenize_tiles(const void* x, void* tiles, int B, long long n_ext, long long halo,
                      long long n_local, long long g0, long long n_total, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int T = tiles_of(n_local);
  auto s = (cudaStream_t)stream;
  tile_first_kernel<<<dim3(T, B), kTile, 0, s>>>(static_cast<const uint8_t*>(x),
                                                  static_cast<int*>(tiles), n_ext, halo,
                                                  (int)n_local, (int)g0, (int)n_total, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tile_suffix_kernel<<<B, kSuffixThreads, 0, s>>>(static_cast<int*>(tiles), T, (int)n_total);
  return (int)cudaGetLastError();
}

// Pass 3: bins (B, n_local * (5 + ndigits_cap)) int32, ovf (B,) bytes
// (zeroed here first).  tail: n_tail int32 on the device, or null.
int nt_tokenize_bins(const void* x, const void* tiles, const void* tail, int n_tail, void* bins,
                     void* ovf, int B, long long n_ext, long long halo, long long n_local,
                     long long g0, long long n_total, int width, int ndigits_cap, int invalid_bin,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndigits_cap < 0 || ndigits_cap > kMaxRunDigits) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  err = cudaMemsetAsync(ovf, 0, B, s);
  if (err != cudaSuccess) return (int)err;
  const int T = tiles_of(n_local);
  kLaunch[ndigits_cap](dim3(T, B), s, static_cast<const uint8_t*>(x),
                       static_cast<const int*>(tiles), static_cast<const int*>(tail), n_tail,
                       static_cast<int*>(bins), static_cast<uint8_t*>(ovf), n_ext, halo,
                       (int)n_local, (int)g0, (int)n_total, width, T, invalid_bin);
  return (int)cudaGetLastError();
}

}  // extern "C"
