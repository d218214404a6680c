// CUDA kernels of the device decode (nicetpu_torch), for sm_90a: the
// speculative chunk walk, the value join and the row reconstruction.
//
// Built by nicetpu_torch/kernels/build.py with nvcc into the same shared
// library as encode_kernels.cu (plain C interface, loaded with ctypes).  The
// wrappers and plain PyTorch versions live in kernels/decode3.py (walk),
// kernels/cuda_ops.py (value join) and kernels/recon.py with
// kernels/decode_dev.py (row reconstruction).  Every entry point launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError().
//
// Payload words arrive as int32 tensors holding uint32 bit patterns; the walk
// reads them as uint32_t, so windows and shifts are unsigned and logical.

#include "common.cuh"

namespace {

using nt::aligned16;
using nt::block_slice;
using nt::kSymbols;
using nt::kThreads;

constexpr int kStreams = 10;
constexpr int kLens = 32;
constexpr int kPrefixStream = 1;    // SC_PREFIXES
constexpr int kPrefixSymbols = 13;  // its alphabet
constexpr int kModes = 5;           // prefixes 0..4 carry payload; 5..12 are run digits
constexpr int kSlots = 4;

// ---------------------------------------------------------------------------
// walk: replaces nicetpu/kernels/decode3.py walk_pallas (_walk_kernel,
// _walk_block_body, _decode_group, _canon_decode).  One thread per chunk; a
// block never spans two images.  The image's threshold tables (aff, dD, inc:
// 10 x 32 each), its canonical prefix order and the mode -> stream map sit in
// shared memory.  Each step decodes one pixel group at bit p: the prefix
// symbol, then the mode's payload codes, each by the monotone threshold count
// of derive_walk_tables; then p = max(p + 1, q).  A window is read straight
// from the words in global memory (two loads, the last word repeating past
// the end, as walk_ref does), which replaces the TPU's per-chunk word blocks
// and two-level one-hot fetch.  A chunk freezes at its bound or at wbits and
// writes pos = -1 and zeros for every later step.  Each threshold sum runs
// over lengths 1.._deep_cap(s) and stops at the first miss: the thresholds
// rise with the length, so no later length can hit, and the sums equal those
// of the TPU's gated (GATING / maxl) loops.  With records == nullptr only the
// exits are written (the non-final rounds).
//
// Bound: its least time is set by bytes (the records, 16 bytes a step, and
// the words), but the kernel is held back by the serial chain of each
// thread: every step waits on its window loads and a data-dependent
// threshold loop, and there is one thread per chunk (2,064 chunks an image
// on the main path), so the card holds few warps per SM and hides little
// latency.  Splitting a chunk's walk across threads is later work.
// ---------------------------------------------------------------------------
struct WalkTables {
  int aff[kStreams][kLens];
  int dD[kStreams][kLens];
  int inc[kStreams][kLens];
  int pfx[16];
  int cap[kStreams];
  int slot[kModes][kSlots];
};

__device__ __forceinline__ uint32_t window(const uint32_t* __restrict__ w, int Wn, int q) {
  const int i = q >> 5;
  const int sh = q & 31;
  const uint32_t w0 = __ldg(w + min(i, Wn - 1));
  const uint32_t w1 = __ldg(w + min(i + 1, Wn - 1));
  return sh ? (w0 << sh) | (w1 >> (32 - sh)) : w0;
}

// (L, idx) of the canonical codeword at window win for stream s.
__device__ __forceinline__ void canon(const WalkTables& t, int s, uint32_t win, int* L,
                                      int* idx) {
  const int win_b = (int)(win ^ 0x80000000u);
  const int cap = t.cap[s];
  int len = 0;
  uint32_t acc = 0;
  for (int l = 1; l <= cap; ++l) {
    if (win_b < t.aff[s][l]) break;
    len += t.inc[s][l];
    acc += (uint32_t)t.dD[s][l];
  }
  *L = len;
  *idx = (int)(acc + (win >> (32 - max(len, 1))));
}

__global__ void walk_kernel(const uint32_t* __restrict__ words, int Wn,
                            const int* __restrict__ entries, const int* __restrict__ aff,
                            const int* __restrict__ dD, const int* __restrict__ inc,
                            const int* __restrict__ pfx, const int* __restrict__ wbits,
                            int* __restrict__ pos, int* __restrict__ sym, uint32_t* __restrict__ i12,
                            uint32_t* __restrict__ i34, int* __restrict__ exits, int nch,
                            int chunk_bits, int steps) {
  __shared__ WalkTables t;
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < kStreams * kLens; i += blockDim.x) {
    (&t.aff[0][0])[i] = aff[b * kStreams * kLens + i];
    (&t.dD[0][0])[i] = dD[b * kStreams * kLens + i];
    (&t.inc[0][0])[i] = inc[b * kStreams * kLens + i];
  }
  if (threadIdx.x < 16) t.pfx[threadIdx.x] = pfx[b * 16 + threadIdx.x];
  if (threadIdx.x == 0) {
    // _deep_cap(s) = min(31, alphabet - 1); SLOT_STREAM (-1: no code)
    const int caps[kStreams] = {31, 12, 31, 31, 10, 31, 31, 31, 31, 10};
    const int slot[kModes][kSlots] = {
        {9, -1, -1, -1}, {0, 0, 0, -1}, {4, 2, 3, 3}, {5, -1, -1, -1}, {6, 7, 8, -1}};
    for (int s = 0; s < kStreams; ++s) t.cap[s] = caps[s];
    for (int m = 0; m < kModes; ++m)
      for (int k = 0; k < kSlots; ++k) t.slot[m][k] = slot[m][k];
  }
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nch) return;
  const uint32_t* w = words + (long long)b * Wn;
  const int limit = min((c + 1) * chunk_bits, wbits[b]);
  const long long chunk = (long long)b * nch + c;
  int p = entries[chunk];
  int step = 0;
  for (; step < steps && p < limit; ++step) {
    int L0, idx0;
    canon(t, kPrefixStream, window(w, Wn, p), &L0, &idx0);
    const int m = (idx0 >= 0 && idx0 < kPrefixSymbols) ? t.pfx[idx0] : 0;
    int q = p + L0;
    int idx[kSlots] = {0, 0, 0, 0};
    if (m >= 0 && m < kModes) {
      for (int k = 0; k < kSlots; ++k) {
        const int s = t.slot[m][k];
        if (s < 0) continue;
        int Lk;
        canon(t, s, window(w, Wn, q), &Lk, &idx[k]);
        q += Lk;
      }
    }
    if (pos != nullptr) {
      const long long r = chunk * steps + step;
      pos[r] = p;
      sym[r] = m;
      i12[r] = (uint32_t)idx[0] | ((uint32_t)idx[1] << 16);
      i34[r] = (uint32_t)idx[2] | ((uint32_t)idx[3] << 16);
    }
    p = max(p + 1, q);
  }
  if (pos != nullptr) {
    for (; step < steps; ++step) {
      const long long r = chunk * steps + step;
      pos[r] = -1;
      sym[r] = 0;
      i12[r] = 0;
      i34[r] = 0;
    }
  }
  exits[chunk] = p;
}

// ---------------------------------------------------------------------------
// value_join: replaces nicetpu/kernels/pallas_ops.py value_join_pallas
// (_value_join_kernel), which looks values up with one-hot bf16 matmuls.
// Here each block loads its image's 858-entry table (3.4 KB) into shared
// memory and maps its slice of one slot array directly: a bin >= 858 is a
// hole and maps to 0, a negative bin reads entry 0 (the gather of JAX's
// _sym_join).  One launch covers all K slot arrays (grid.y = K * B).  Bound
// by device-memory bandwidth: 4 bytes read and 4 written per bin, int4 loads.
// ---------------------------------------------------------------------------
__device__ __forceinline__ int join1(int v, const int* s_tbl) {
  return v < kSymbols ? s_tbl[max(v, 0)] : 0;
}

__global__ void value_join_kernel(const int* __restrict__ bins, const int* __restrict__ tbl,
                                  int* __restrict__ out, int B, long long M) {
  __shared__ int s_tbl[kSymbols];
  const long long kb = blockIdx.y;  // slot array k, image b: kb = k * B + b
  const int b = (int)(kb % B);
  for (int i = threadIdx.x; i < kSymbols; i += blockDim.x) s_tbl[i] = tbl[b * kSymbols + i];
  __syncthreads();

  const int* src = bins + kb * M;
  int* dst = out + kb * M;
  long long lo, hi;
  block_slice(M, &lo, &hi);
  long long i = lo;
  if (aligned16(src + lo) && aligned16(dst + lo)) {
    const long long n4 = (hi - lo) >> 2;
    const int4* s4 = reinterpret_cast<const int4*>(src + lo);
    int4* d4 = reinterpret_cast<int4*>(dst + lo);
    for (long long v = threadIdx.x; v < n4; v += blockDim.x) {
      const int4 x = __ldg(s4 + v);
      d4[v] = make_int4(join1(x.x, s_tbl), join1(x.y, s_tbl), join1(x.z, s_tbl),
                        join1(x.w, s_tbl));
    }
    i = lo + 4 * n4;
  }
  for (i += threadIdx.x; i < hi; i += blockDim.x) dst[i] = join1(__ldg(src + i), s_tbl);
}

// ---------------------------------------------------------------------------
// reconstruct_rows: replaces nicetpu/kernels/recon_pallas.py
// reconstruct_rows_pallas (_recon_kernel).  The value chain
//   out[p] = form_p(out[p-1], out[p-2], out[p-3], out[p-W], out[p-refoff]) + d
// is serial through the whole raster for each (image, channel): `prev` wraps
// from the end of one row to the start of the next, so a row cannot start
// before the row above has finished (no row wavefront).  One warp per
// (image, channel), row by row:
//   1. the 32 lanes gather each pixel's chain-independent inputs (form,
//      delta, the pixel above, the CONST reference) into one packed word in
//      shared memory, from a ring of the last 4 rows (every reference reaches
//      at most 3W + 3 back, which is inside 4 rows);
//   2. lane 0 runs the chain over the row: per pixel one shared load of the
//      packed word and a handful of integer ops on the lag registers;
//   3. the lanes store the row to device memory, coalesced.
// A CONST reference that lands in the current row (offsets W-3..W-1 from the
// last 3 columns reach columns 0..2) is read by lane 0 from the row itself.
// Reads before the raster start are zeros, as in reconstruct_rows and the
// Pallas kernel.  refoff must hold 0 or one of decode_dev._const_offsets(W).
//
// Bound: its least time is set by bytes (32 a pixel), but the kernel is
// held back by the chain's latency: lane 0 runs N = H * W dependent steps,
// each row also waits for the lanes' global loads, and only 3 * B warps
// run.  The TPU kernel's 256-candidate segment LUTs cut the dependent path
// per row from W steps to about 2 * W / S + S, at 256 times the work;
// bringing that to Hopper is later work.  The ring and the packed row take
// 8 bytes a pixel of a row: in shared memory up to W = 29,048, in the
// wrapper's scratch in device memory beyond.
// ---------------------------------------------------------------------------
__device__ __forceinline__ int chain_step(uint32_t pk, const uint8_t* cur, int& r1, int& r2,
                                          int& r3) {
  const int f = pk & 7;
  const int d = (pk >> 3) & 255;
  const int ab = (pk >> 11) & 255;
  const int cc = pk >> 27;
  int v;
  switch (f) {
    case 0:
      v = (cc ? cur[cc - 1] : (pk >> 19) & 255) + d;
      break;
    case 1:
      v = r1 + d;
      break;
    case 2:
      v = r2 + d;
      break;
    case 3:
      v = r3 + d;
      break;
    default:
      v = ((ab + r1) >> 1) + d;
  }
  v &= 255;
  r3 = r2;
  r2 = r1;
  r1 = v;
  return v;
}

__global__ void reconstruct_rows_kernel(const int* __restrict__ form, const int* __restrict__ delta,
                                        const int* __restrict__ refoff, int* __restrict__ out,
                                        uint8_t* scratch, int N, int W) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int bc = blockIdx.x;  // b * 3 + c
  const long long b = bc / 3;
  const long long stride = (8LL * W + 15) / 16 * 16;  // recon._scratch_stride
  uint8_t* buf = scratch ? scratch + bc * stride : smem;
  uint32_t* pre = reinterpret_cast<uint32_t*>(buf);  // packed inputs of the row, 4W bytes
  uint8_t* ring = buf + 4LL * W;                      // rows r-4 .. r-1, slot (row & 3)
  const int lane = threadIdx.x;
  for (int i = lane; i < 4 * W; i += 32) ring[i] = 0;
  __syncwarp();

  const int* f_img = form + b * N;
  const int* ro_img = refoff + b * N;
  const int* d_img = delta + (long long)bc * N;
  int* o_img = out + (long long)bc * N;
  const int H = N / W;
  int r1 = 0, r2 = 0, r3 = 0;
  for (int r = 0; r < H; ++r) {
    uint8_t* cur = ring + (r & 3) * W;
    const uint8_t* above = ring + ((r + 3) & 3) * W;  // row r - 1 (zeros before row 0)
    for (int x = lane; x < W; x += 32) {
      const long long i = (long long)r * W + x;
      const int f0 = f_img[i];
      const int f = (f0 >= 0 && f0 <= 3) ? f0 : 4;  // any other form is HALF
      const int ro = ro_img[i];
      uint32_t cv = 0, cc = 0;  // cc: 1 + column of a reference in the current row
      if (ro > 0) {
        const int k = x - ro;
        if (k >= 0) {
          cc = k + 1;
        } else {
          const int back = (W - 1 - k) / W;  // rows back, 1..4
          cv = r >= back ? ring[((r - back) & 3) * W + k + back * W] : 0;
        }
      }
      pre[x] = f | ((uint32_t)(d_img[i] & 255) << 3) | ((uint32_t)above[x] << 11) | (cv << 19) |
               (cc << 27);
    }
    __syncwarp();
    if (lane == 0) {
      int x = 0;
      for (; x + 4 <= W; x += 4) {
        const uint4 p4 = *reinterpret_cast<const uint4*>(pre + x);
        cur[x] = chain_step(p4.x, cur, r1, r2, r3);
        cur[x + 1] = chain_step(p4.y, cur, r1, r2, r3);
        cur[x + 2] = chain_step(p4.z, cur, r1, r2, r3);
        cur[x + 3] = chain_step(p4.w, cur, r1, r2, r3);
      }
      for (; x < W; ++x) cur[x] = chain_step(pre[x], cur, r1, r2, r3);
    }
    __syncwarp();
    for (int x = lane; x < W; x += 32) o_img[(long long)r * W + x] = cur[x];
  }
}

}  // namespace

extern "C" {

int nt_walk(const void* words, int Wn, const void* entries, const void* aff, const void* dD,
            const void* inc, const void* pfx, const void* wbits, void* pos, void* sym, void* i12,
            void* i34, void* exits, int B, int nch, int chunk_bits, int steps, int device,
            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int kWalkThreads = 64;
  dim3 grid((nch + kWalkThreads - 1) / kWalkThreads, B);
  walk_kernel<<<grid, kWalkThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(words), Wn, static_cast<const int*>(entries),
      static_cast<const int*>(aff), static_cast<const int*>(dD), static_cast<const int*>(inc),
      static_cast<const int*>(pfx), static_cast<const int*>(wbits), static_cast<int*>(pos),
      static_cast<int*>(sym), static_cast<uint32_t*>(i12), static_cast<uint32_t*>(i34),
      static_cast<int*>(exits), nch, chunk_bits, steps);
  return (int)cudaGetLastError();
}

int nt_value_join(const void* bins, const void* tbl, void* out, int K, int B, long long M,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nt::blocks_per_row(M, K * B), K * B);
  value_join_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(bins), static_cast<const int*>(tbl), static_cast<int*>(out), B, M);
  return (int)cudaGetLastError();
}

int nt_reconstruct_rows(const void* form, const void* delta, const void* refoff, void* out,
                        void* scratch, int B, int N, int W, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = scratch ? 0 : 8 * (size_t)W;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(reconstruct_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  reconstruct_rows_kernel<<<3 * B, 32, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(form), static_cast<const int*>(delta),
      static_cast<const int*>(refoff), static_cast<int*>(out), static_cast<uint8_t*>(scratch), N,
      W);
  return (int)cudaGetLastError();
}

}  // extern "C"
