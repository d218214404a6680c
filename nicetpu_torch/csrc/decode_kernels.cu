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

#include <cooperative_groups.h>
#include <cstdio>

#include "common.cuh"

namespace {

namespace cg = cooperative_groups;

using nt::aligned16;
using nt::block_slice;
using nt::cp_async4;
using nt::cp_async_commit;
using nt::cp_async_wait_all;
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
// block never spans two images.  Each code is decoded by the threshold count
// of derive_walk_tables: with the thresholds aff[s][1..cap] of stream s, the
// code's length L and index idx at window win are
//   n   = the thresholds hit before the first miss (win ^ MSB >= aff[s][l])
//   L   = inc[s][1] + .. + inc[s][n]
//   idx = dD[s][1] + .. + dD[s][n] + (win >>> (32 - max(L, 1))),
// the sums of the TPU's gated GATING / maxl loops.  The prologue turns the
// image's tables into shared-memory ones: thr[s][l], the running maximum of
// aff[s][1..l] (a threshold is hit before the first miss iff every one up to
// it is, so n is the count of thr[s][1..cap] at most the window, found by a
// five-step binary search), cinc and cdD, the running sums of inc and dD; and
// from them the first-level decode table, indexed by stream and the window's
// top kLutBits bits: n never falls as the window grows, so where the lowest
// and the highest window of a prefix give the same n, every window of the
// prefix does, and if also max(L, 1) <= kLutBits the prefix fixes (L, idx).
// Such an entry holds L << kLutIdxBits | idx (when idx < 2^kLutIdxBits); every
// other entry is -1 and its codes take the binary search.  The prefixes of
// one stream share a warp, so their threshold loads are broadcasts.
//
// The words the block's chunks cover, one contiguous range of blockDim *
// chunk_bits/32 + 8 words (at most kStageWords), are copied into shared
// memory once, with cp.async while the tables are built.  Each step decodes
// one pixel group at bit p: the prefix symbol, then the mode's payload codes;
// then p = max(p + 1, q).  A window is two words, the last word repeating
// past the end as in walk_ref; a window outside the staged range (an entry
// before its chunk's start, when the previous chunk ran out of steps) is read
// from device memory.  This replaces the TPU's per-chunk word blocks and
// two-level one-hot fetch.  Chunk c ends at bit (c + 1) * chunk_bits; a word
// index below 0 is clamped to the first word.  A shard of the decode across
// ranks passes its slice of the words with every position relative to the
// slice's first bit, so that positions stay in int32 for payloads of 2^31
// bits or more; an entry below 0 comes only from a previous shard's chunk
// that failed to cross, so its records do not matter: the gates reject the
// raster.  A chunk freezes at its bound or at wbits and
// writes pos = -1 and zeros for every later step.  A thread keeps kTile steps of records in registers and stores
// them as whole 32-byte sectors: neighbouring threads' records lie steps * 4
// bytes apart, so one record a store would cost a sector each.  With records
// == nullptr only the exits are written (the non-final rounds).
//
// Bound: its least time is set by bytes (the records, 16 bytes a step, and
// the words), but the kernel is held back by the serial chain of each
// thread: one thread per chunk (2,064 chunks an image on the main path)
// leaves few warps per SM to hide latency, so the design shortens each
// step's chain instead: shared-memory windows and one table load a code in
// the common case, in place of two device-memory loads and a data-dependent
// loop of up to 31 compares.
// ---------------------------------------------------------------------------
constexpr int kLutBits = 10;
constexpr int kLutIdxBits = 26;
constexpr int kLutSize = kStreams << kLutBits;
constexpr int kStageWords = 12288;  // 48 KB of words at most
constexpr int kWalkThreads = 64;
constexpr int kTile = 8;  // steps of records buffered in registers (decode3.WALK_TILE)
constexpr int kLutBatch = 8;  // table entries a thread computes before it stores them
static_assert(kLutSize % (kLutBatch * kWalkThreads) == 0, "the table fills whole batches");

// kTile ints from registers to 16-byte aligned memory.
__device__ __forceinline__ void store_tile(int* dst, const int (&v)[kTile]) {
  int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int i = 0; i < kTile / 4; ++i)
    d[i] = make_int4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

struct WalkTables {
  int lut[kLutSize];
  int thr[kStreams][kLens];       // running maximum of aff over lengths 1..l
  int cinc[kStreams][kLens];      // running sums of inc and dD over lengths 1..l
  uint32_t cdD[kStreams][kLens];  // (index 0: the empty sum)
  int pfx[16];
  int cap[kStreams];
  int slot[kModes][kSlots];
};

struct Words {
  const uint32_t* s;  // the staged words [lo, lo + n)
  int lo, n;
  const uint32_t* g;  // the image's words in device memory
  int Wn;
};

// The window at bit q of the words (below 0 only when an entry lies before a
// shard's slice, which the gates reject).
__device__ __forceinline__ uint32_t window(const Words& w, int q) {
  const int i0 = min(max(q >> 5, 0), w.Wn - 1);
  const int i1 = min(max((q >> 5) + 1, 0), w.Wn - 1);
  const int sh = q & 31;
  uint32_t w0, w1;
  if (i0 >= w.lo && i1 < w.lo + w.n) {
    w0 = w.s[i0 - w.lo];
    w1 = w.s[i1 - w.lo];
  } else {
    w0 = __ldg(w.g + i0);
    w1 = __ldg(w.g + i1);
  }
  return sh ? (w0 << sh) | (w1 >> (32 - sh)) : w0;
}

// The thresholds of stream s hit before the first miss at the biased window
// win_b = win ^ MSB (thr rises with the length, so this is a count).
__device__ __forceinline__ int first_miss(const WalkTables& t, int s, int win_b) {
  const int cap = t.cap[s];
  int n = 0;
#pragma unroll
  for (int step = 16; step; step >>= 1) {
    const int m = n + step;  // <= 31: the load needs no guard
    n = (m <= cap) & (t.thr[s][m] <= win_b) ? m : n;
  }
  return n;
}

// Entry e = (stream s, prefix j) of the first-level table; its windows run
// from lo = j << (32 - kLutBits) to lo | (2^(32 - kLutBits) - 1).
__device__ __forceinline__ int lut_entry(const WalkTables& t, int e) {
  const int s = e >> kLutBits;
  const uint32_t lo = (uint32_t)(e & ((1 << kLutBits) - 1)) << (32 - kLutBits);
  const int lo_b = (int)(lo ^ 0x80000000u);
  const int n = first_miss(t, s, lo_b);
  const int hi_b = lo_b + ((1 << (32 - kLutBits)) - 1);
  const int next = t.thr[s][min(n + 1, kLens - 1)];
  const bool same = n == t.cap[s] || next > hi_b;  // no threshold inside the prefix
  const int L = t.cinc[s][n];
  const int Lc = max(L, 1);
  if (!same || Lc > kLutBits) return -1;
  const uint32_t idx = t.cdD[s][n] + (lo >> (32 - Lc));
  return idx < (1u << kLutIdxBits) ? (L << kLutIdxBits) | (int)idx : -1;
}

// (L, idx) of the canonical codeword at window win for stream s.
__device__ __forceinline__ void canon(const WalkTables& t, int s, uint32_t win, int* L,
                                      int* idx) {
  const int e = t.lut[(s << kLutBits) + (win >> (32 - kLutBits))];
  if (e >= 0) {
    *L = e >> kLutIdxBits;
    *idx = e & ((1 << kLutIdxBits) - 1);
    return;
  }
  const int n = first_miss(t, s, (int)(win ^ 0x80000000u));
  *L = t.cinc[s][n];
  *idx = (int)(t.cdD[s][n] + (win >> (32 - max(*L, 1))));
}

__global__ void __launch_bounds__(kWalkThreads)
    walk_kernel(const uint32_t* __restrict__ words, int Wn, const int* __restrict__ entries,
                const int* __restrict__ aff, const int* __restrict__ dD,
                const int* __restrict__ inc, const int* __restrict__ pfx,
                const int* __restrict__ wbits, int* __restrict__ pos, int* __restrict__ sym,
                uint32_t* __restrict__ i12, uint32_t* __restrict__ i34, int* __restrict__ exits,
                int nch, int chunk_bits, int steps) {
  extern __shared__ __align__(16) uint8_t smem[];
  WalkTables& t = *reinterpret_cast<WalkTables*>(smem);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(smem + sizeof(WalkTables));
  const int b = blockIdx.y;
  Words w;
  w.g = words + (long long)b * Wn;
  w.Wn = Wn;
  w.s = s_words;
  // the block's first chunk starts at bit blockIdx.x * blockDim.x * chunk_bits
  const long long lo_bit = (long long)blockIdx.x * blockDim.x * chunk_bits;
  w.lo = (int)min(lo_bit >> 5, (long long)Wn);
  const long long span = (long long)blockDim.x * (chunk_bits >> 5) + 8;
  w.n = (int)max(0LL, min(min(span, (long long)kStageWords), (long long)Wn - w.lo));
  // the words arrive while the tables are built
  for (int i = threadIdx.x; i < w.n; i += blockDim.x) cp_async4(s_words + i, w.g + w.lo + i);
  cp_async_commit();
  if (threadIdx.x < 16) t.pfx[threadIdx.x] = pfx[b * 16 + threadIdx.x];
  if (threadIdx.x < kStreams) {
    // _deep_cap(s) = min(31, alphabet - 1); SLOT_STREAM (-1: no code)
    const int caps[kStreams] = {31, 12, 31, 31, 10, 31, 31, 31, 31, 10};
    const int s = threadIdx.x;
    const int* a = aff + (b * kStreams + s) * kLens;
    const int* n = inc + (b * kStreams + s) * kLens;
    const int* d = dD + (b * kStreams + s) * kLens;
    int av[kLens], nv[kLens], dv[kLens];  // every load issued before the first store
#pragma unroll
    for (int l = 1; l < kLens; ++l) {
      av[l] = __ldg(a + l);
      nv[l] = __ldg(n + l);
      dv[l] = __ldg(d + l);
    }
    int hi = INT32_MIN, ci = 0;
    uint32_t cd = 0;
    t.thr[s][0] = INT32_MIN;
    t.cinc[s][0] = 0;
    t.cdD[s][0] = 0;
#pragma unroll
    for (int l = 1; l < kLens; ++l) {
      hi = max(hi, av[l]);
      ci += nv[l];
      cd += (uint32_t)dv[l];
      t.thr[s][l] = hi;
      t.cinc[s][l] = ci;
      t.cdD[s][l] = cd;
    }
    t.cap[s] = caps[s];
  }
  if (threadIdx.x == 0) {
    const int slot[kModes][kSlots] = {
        {9, -1, -1, -1}, {0, 0, 0, -1}, {4, 2, 3, 3}, {5, -1, -1, -1}, {6, 7, 8, -1}};
    for (int m = 0; m < kModes; ++m)
      for (int k = 0; k < kSlots; ++k) t.slot[m][k] = slot[m][k];
  }
  __syncthreads();
  // the first-level table, kLutBatch entries a thread at a time: their
  // searches are independent, and no store comes between their loads
  for (int e0 = threadIdx.x; e0 < kLutSize; e0 += kLutBatch * kWalkThreads) {
    int v[kLutBatch];
#pragma unroll
    for (int u = 0; u < kLutBatch; ++u) v[u] = lut_entry(t, e0 + u * kWalkThreads);
#pragma unroll
    for (int u = 0; u < kLutBatch; ++u) t.lut[e0 + u * kWalkThreads] = v[u];
  }
  cp_async_wait_all();
  __syncthreads();

  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nch) return;
  const int limit = min((c + 1) * chunk_bits, wbits[b]);
  const long long chunk = (long long)b * nch + c;
  // records go out kTile steps at a time, two 16-byte stores per array
  // (whole 32-byte sectors); steps is a multiple of kTile
  int p = entries[chunk];
  int step = 0;
  while (step < steps) {
    int rp[kTile], rs[kTile], ra[kTile], rb[kTile];  // ra, rb: uint32 bit patterns
#pragma unroll
    for (int u = 0; u < kTile; ++u) {
      rp[u] = -1;
      rs[u] = 0;
      ra[u] = 0;
      rb[u] = 0;
      if (p < limit) {
        int L0, idx0;
        canon(t, kPrefixStream, window(w, p), &L0, &idx0);
        const int m = (idx0 >= 0 && idx0 < kPrefixSymbols) ? t.pfx[idx0] : 0;
        int q = p + L0;
        int idx[kSlots] = {0, 0, 0, 0};
        if (m >= 0 && m < kModes) {
          for (int k = 0; k < kSlots; ++k) {
            const int s = t.slot[m][k];
            if (s < 0) continue;
            int Lk;
            canon(t, s, window(w, q), &Lk, &idx[k]);
            q += Lk;
          }
        }
        rp[u] = p;
        rs[u] = m;
        ra[u] = (int)((uint32_t)idx[0] | ((uint32_t)idx[1] << 16));
        rb[u] = (int)((uint32_t)idx[2] | ((uint32_t)idx[3] << 16));
        p = max(p + 1, q);
      }
    }
    if (pos != nullptr) {
      const long long r = chunk * steps + step;
      store_tile(pos + r, rp);
      store_tile(sym + r, rs);
      store_tile(reinterpret_cast<int*>(i12) + r, ra);
      store_tile(reinterpret_cast<int*>(i34) + r, rb);
    }
    step += kTile;
    if (p >= limit) break;  // frozen: every later record is dead
  }
  if (pos != nullptr) {
    const int4 dead = make_int4(-1, -1, -1, -1), zero = make_int4(0, 0, 0, 0);
    const long long r0 = chunk * steps;
    for (; step < steps; step += 4) {
      *reinterpret_cast<int4*>(pos + r0 + step) = dead;
      *reinterpret_cast<int4*>(sym + r0 + step) = zero;
      *reinterpret_cast<int4*>(i12 + r0 + step) = zero;
      *reinterpret_cast<int4*>(i34 + r0 + step) = zero;
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
// reconstruct_rows_pallas (_recon_kernel), with the segment-LUT scheme of
// nicetpu/kernels/decode_dev.py reconstruct_rows.  The value chain
//   out[p] = form_p(out[p-1], out[p-2], out[p-3], out[p-W], out[p-refoff]) + d
// is serial through the whole raster for each (image, channel): `prev` wraps
// from the end of one row to the start of the next, so the rows go in order
// (no row wavefront) and the work is spread *within* a row.  Each pixel reads
// at most one chain value x (lag 1, 2 or 3; CONST reads none), and every form
// is one expression,
//   v = ((k * x + c) >> 1) & 255,  k = 2, c = 2d        for ADD1..3 (x + d)
//                                  k = 1, c = ab + 2d   for HALF ((ab + x) >> 1) + d
//                                  k = 0, c = 2(cv + d) for CONST,
// so a pixel is a (lag, k, c) triple, fixed before the chain runs.  A segment
// of kSeg pixels then maps the chain value at its entry to each of its last
// three values: three 256-entry LUTs, each with a tag naming the entry lag it
// reads.  One block per (image, channel) walks the rows; for each row:
//   1. stage: the row's form, delta and refoff were copied into shared memory
//      with cp.async while the previous row computed; the threads turn each
//      pixel into its (lag, k, c), reading the pixel above and the CONST
//      reference from a ring of the last 4 rows (every reference reaches at
//      most 3W + 3 back), then start the next row's copy.  The ring starts
//      as the four rows before the block: zeros, or the carry prev4 (B, 3,
//      4W) of a row block decoded after the rows above it (decode across
//      ranks), whose values must lie in 0..255;
//   2. build: one warp per segment, 8 candidate entry values a lane, pushes
//      the candidates through the segment's pixels.  A value v rides as the
//      float 2^23 + v, so one fused multiply-add rounded toward zero,
//      x * (k / 2) + (2^23 - k 2^22 + c / 2), gives 2^23 + ((k v + c) >> 1)
//      exactly (every operand is exact in float32), and one byte permute
//      keeps the low byte (the & 255) under the exponent bits of 2^23: half
//      of each step runs on the float pipe, which issues twice the integer
//      pipe's rate.  A segment whose pixels all read lag 1 (HALF, ADD1,
//      CONST: almost every pixel of a photo) takes a path with no select,
//      and once the warp's 256 candidates share one value in each lag (HALF
//      halves their spread, CONST ends it) it carries that one value; the
//      tags follow the lags;
//   3. resolve: one thread carries the true entry triple across the segments,
//      three byte lookups each.  Past 2 * kGroup segments a warp first
//      composes each group of kGroup segments into one LUT triple, so that
//      the serial chain runs over the groups and then, in parallel, within
//      each group;
//   4. replay: one thread per segment runs its pixels from its true entry
//      values, the same step on one value;
//   5. fix-up: CONST references from the last 3 columns with offsets W-1..W-3
//      land in columns 0..2 of the current row, which the build and replay
//      read stale (as the JAX scheme does); one thread recomputes those three
//      columns serially and stores them.
// Reads before the raster start are zeros (or the carry), as in
// decode_dev.reconstruct_rows and the Pallas kernel.  refoff must hold 0 or one of
// decode_dev._const_offsets(W) (every offset is >= max(4, W - 3)).
// A batch of images of several shapes (the round trip's) comes as rows of
// the largest image's N with the batch's geometry table: each chain runs
// its own image's N_b / W_b rows of W_b pixels and writes zeros past N_b;
// the shared memory (or scratch) is sized for the widest image.
//
// The buffers take about 53 bytes a pixel of a row.  Where a row's fit one
// block's shared memory (up to about 4,288 pixels on an H100), one block runs
// a chain (reconstruct_rows_kernel<true>).  Wider rows run on a thread-block
// cluster, each CTA a column slice (reconstruct_rows_cluster_kernel, below);
// rows too wide for even a 16-CTA cluster (about 63,000 pixels and more) run
// on one block with the buffers in the wrapper's scratch in device memory
// (reconstruct_rows_kernel<false>, its scratch sized by nt_recon_plan, without
// the cp.async staging).
//
// Bound: its least time is set by bytes (32 a pixel), but the scheme does 256
// candidates of work a pixel, two instructions each, so it is bound by the
// issue rate of the SMs it occupies, plus per-row latencies.  One block a
// chain occupies 3 * B SMs and pays the resolve (S steps, or S / kGroup +
// kGroup through the groups) and the replay (kSeg steps) a row.  A cluster of C CTAs
// a chain spreads the build over 3 * B * C SMs, so that a row's candidate
// work is W / C pixels a CTA, and pays instead two cluster barriers a row and
// the carry across the C slices (C steps, from shared memory).  Tensor cores
// have no part in this integer chain.
// ---------------------------------------------------------------------------
constexpr int kSeg = 32;    // pixels a segment
constexpr int kCand = 8;    // candidates a lane: a warp covers one segment's 256
constexpr int kGroup = 16;  // segments a group of the two-level resolve
constexpr uint32_t kTwo23 = 0x4B000000u;  // bits of 2^23

__host__ __device__ constexpr size_t r16(size_t n) { return (n + 15) & ~size_t(15); }

// Byte offsets of one chain's buffers.
struct ReconLayout {
  size_t fk, meta, ring, lut, tags, bnd, flag, glut, gtags, gbnd, stage, end;
  __host__ __device__ explicit ReconLayout(int W) {
    const size_t S = (W + kSeg - 1) / kSeg;
    fk = 0;                                // per pixel: float2 (k / 2, addend)
    meta = fk + r16(8 * (size_t)W);        // per pixel: lag | cc << 2 | d << 8
    ring = meta + r16(4 * (size_t)W);      // rows r-4 .. r-1, stride r16(W)
    lut = ring + 4 * r16(W);               // S x 3 lags x 256 bytes
    tags = lut + 768 * S;                  // S words: t1 | t2 << 8 | t3 << 16
    bnd = tags + r16(4 * S);               // S words: entry v1 | v2 << 8 | v3 << 16
    flag = bnd + r16(4 * S);               // S words: a pixel reads lag 2 or 3
    const size_t NG = (S + kGroup - 1) / kGroup;
    glut = flag + r16(4 * S);              // NG composed LUT triples (two-level resolve)
    gtags = glut + 768 * NG;               // their tags
    gbnd = gtags + r16(4 * NG);            // their entry triples
    stage = gbnd + r16(4 * NG);            // form, delta, refoff of the next row
    end = stage + r16(12 * (size_t)W);     // (shared memory only)
  }
};

// The value v as the float 2^23 + v, and back.
__device__ __forceinline__ float as_chain(uint32_t v) { return __uint_as_float(kTwo23 | v); }
__device__ __forceinline__ uint32_t chain_byte(float x) { return __float_as_uint(x) & 255; }

// One step: 2^23 + (((k v + c) >> 1) & 255) from x = 2^23 + v; one byte
// permute keeps the low byte and puts back the exponent bits of 2^23.
__device__ __forceinline__ float chain_step(float x, float2 fk) {
  return __uint_as_float(__byte_perm(__float_as_uint(__fmaf_rz(x, fk.x, fk.y)), kTwo23, 0x7650));
}

__device__ __forceinline__ float2 pixel_fk(uint32_t k, uint32_t c) {
  // k / 2 and 2^23 - k 2^22 + c / 2, both exact in float32
  return make_float2(0.5f * (float)k, (float)((2u << 22) - k * (1u << 22)) + 0.5f * (float)c);
}

// Carries the entry triple (v1, v2, v3) across the segments [s0, s1) of a LUT
// array (768 bytes a segment), storing each segment's entry triple; the next
// segment's tags are loaded ahead of this one's store, and where all three
// LUTs read lag 1 the three lookups share one index.
__device__ __forceinline__ void resolve_run(const uint8_t* lut, const uint32_t* tg,
                                            uint32_t* entry, int s0, int s1, int v1, int v2,
                                            int v3) {
  uint32_t t_next = tg[s0];
  for (int s = s0; s < s1; ++s) {
    const uint32_t t = t_next;
    if (s + 1 < s1) t_next = tg[s + 1];
    const uint8_t* l = lut + s * 768;
    entry[s] = v1 | (v2 << 8) | (v3 << 16);
    int n1, n2, n3;
    if (t == 0) {
      n1 = l[v1];
      n2 = l[256 + v1];
      n3 = l[512 + v1];
    } else {
      const int a1 = t & 255, a2 = (t >> 8) & 255, a3 = t >> 16;
      n1 = l[a1 == 0 ? v1 : a1 == 1 ? v2 : v3];
      n2 = l[256 + (a2 == 0 ? v1 : a2 == 1 ? v2 : v3)];
      n3 = l[512 + (a3 == 0 ? v1 : a3 == 1 ? v2 : v3)];
    }
    v1 = n1;
    v2 = n2;
    v3 = n3;
  }
}

// One warp composes the segments [s0, s1) into one LUT triple (glut, 768
// bytes) and its tags: lane l follows candidates 8l .. 8l+7 of each lag.
__device__ __forceinline__ void compose_group(const uint8_t* lut, const uint32_t* tg, int s0,
                                              int s1, uint8_t* glut, uint32_t* gtag, int lane) {
  uint32_t v[3][kCand];
#pragma unroll
  for (int i = 0; i < kCand; ++i) v[0][i] = v[1][i] = v[2][i] = kCand * lane + i;
  uint32_t g1 = 0, g2 = 1, g3 = 2;  // the group's entry lag each lag reads
  for (int s = s0; s < s1; ++s) {
    const uint32_t t = tg[s];
    const uint8_t* l = lut + s * 768;
    const uint32_t a1 = t & 255, a2 = (t >> 8) & 255, a3 = t >> 16;
    uint32_t nv[3][kCand];
#pragma unroll
    for (int i = 0; i < kCand; ++i) {
      nv[0][i] = l[a1 == 0 ? v[0][i] : a1 == 1 ? v[1][i] : v[2][i]];
      nv[1][i] = l[256 + (a2 == 0 ? v[0][i] : a2 == 1 ? v[1][i] : v[2][i])];
      nv[2][i] = l[512 + (a3 == 0 ? v[0][i] : a3 == 1 ? v[1][i] : v[2][i])];
    }
#pragma unroll
    for (int i = 0; i < kCand; ++i) {
      v[0][i] = nv[0][i];
      v[1][i] = nv[1][i];
      v[2][i] = nv[2][i];
    }
    const uint32_t h1 = a1 == 0 ? g1 : a1 == 1 ? g2 : g3;
    const uint32_t h2 = a2 == 0 ? g1 : a2 == 1 ? g2 : g3;
    const uint32_t h3 = a3 == 0 ? g1 : a3 == 1 ? g2 : g3;
    g1 = h1;
    g2 = h2;
    g3 = h3;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(glut + k * 256 + kCand * lane);
    dst[0] = v[k][0] | (v[k][1] << 8) | (v[k][2] << 16) | (v[k][3] << 24);
    dst[1] = v[k][4] | (v[k][5] << 8) | (v[k][6] << 16) | (v[k][7] << 24);
  }
  if (lane == 0) *gtag = g1 | (g2 << 8) | (g3 << 16);
}

constexpr int kCollapseFirst = 12;  // build steps before the first collapse test
constexpr int kCollapseEvery = 4;   // and between the later ones

// One build step of a lag-1 pixel on a lane's candidates.
__device__ __forceinline__ void lag1_step(float2 p, float (&r1)[kCand], float (&r2)[kCand],
                                          float (&r3)[kCand]) {
#pragma unroll
  for (int i = 0; i < kCand; ++i) {
    r3[i] = r2[i];
    r2[i] = r1[i];
    r1[i] = chain_step(r1[i], p);
  }
}

// Whether every candidate of the warp holds one value in each lag.
__device__ __forceinline__ bool all_equal(const float (&r1)[kCand], const float (&r2)[kCand],
                                          const float (&r3)[kCand]) {
  const float a1 = __shfl_sync(0xffffffffu, r1[0], 0);
  const float a2 = __shfl_sync(0xffffffffu, r2[0], 0);
  const float a3 = __shfl_sync(0xffffffffu, r3[0], 0);
  bool eq = true;
#pragma unroll
  for (int i = 0; i < kCand; ++i) eq &= (r1[i] == a1) & (r2[i] == a2) & (r3[i] == a3);
  return __all_sync(0xffffffffu, eq);
}

// Four candidates' low bytes packed into a word.
__device__ __forceinline__ uint32_t pack4(const float* x) {
  const uint32_t lo = __byte_perm(__float_as_uint(x[0]), __float_as_uint(x[1]), 0x0040);
  const uint32_t hi = __byte_perm(__float_as_uint(x[2]), __float_as_uint(x[3]), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// Step 1 for one pixel, at column x of the row and xl of the buffers: its
// (k / 2, addend) and meta from its form f, CONST offset ro and delta byte d;
// flags its segment where it reads lag 2 or 3.  ring_at(slot, col) reads a
// row above from the ring; above is row r - 1 at the buffers' columns.
template <class RingAt>
__device__ __forceinline__ void stage_pixel(int f, int ro, uint32_t d, int x, int xl, int r, int W,
                                            RingAt ring_at, const uint8_t* above, float2* fk,
                                            uint32_t* meta, uint32_t* flag) {
  uint32_t cv = 0, cc = 0;
  if (ro > 0) {
    const int k = x - ro;
    if (k >= 0) {
      cc = k + 1;  // 1 + column of a reference into this row, fixed up later
    } else {
      // rows back, 1..4 (k >= -(3W + 3)); a row before the block is
      // still in its ring slot (the carry, or zeros)
      const int back = k >= -W ? 1 : (k >= -2 * W ? 2 : (k >= -3 * W ? 3 : 4));
      cv = ring_at((r - back) & 3, k + back * W);
    }
  }
  uint32_t c, k, lag = 1;
  if (f == 0) {
    k = 0;
    c = 2 * ((cv + d) & 255);
  } else if (f >= 1 && f <= 3) {
    k = 2;
    c = 2 * d;
    lag = f;
    cc = 0;
  } else {
    k = 1;
    c = above[xl] + 2 * d;
    cc = 0;
  }
  fk[xl] = pixel_fk(k, c);
  meta[xl] = lag | (cc << 2) | (d << 8);
  if (lag != 1) flag[xl / kSeg] = 1;
}

// Step 2 for one segment of n pixels (fk and meta from its first): lane l
// pushes candidates 8l .. 8l+7 of each lag through them and stores its bytes
// of the segment's three LUTs (lut2, 96 words); lane 0 stores the tags.
__device__ __forceinline__ void build_segment(const float2* fk, const uint32_t* meta,
                                              const uint32_t* flag, int n, int l, uint2* lut2,
                                              uint32_t* tag) {
  float r1[kCand], r2[kCand], r3[kCand];
#pragma unroll
  for (int i = 0; i < kCand; ++i) r1[i] = r2[i] = r3[i] = as_chain(kCand * l + i);
  uint32_t t1 = 0, t2 = 1, t3 = 2;
  if (n == kSeg && !*flag) {  // every pixel reads lag 1: the tags end at 0
    // HALF halves the spread of the candidates and CONST ends it, so the
    // 256 candidates soon share one value in each lag: from there one
    // value is carried for all of them
#pragma unroll
    for (int j = 0; j < kCollapseFirst; ++j) lag1_step(fk[j], r1, r2, r3);
    bool one = all_equal(r1, r2, r3);
#pragma unroll
    for (int j0 = kCollapseFirst; j0 < kSeg; j0 += kCollapseEvery) {
      if (!one) {  // the same for the whole warp
#pragma unroll
        for (int j = j0; j < j0 + kCollapseEvery; ++j) lag1_step(fk[j], r1, r2, r3);
        one = all_equal(r1, r2, r3);
      } else {
#pragma unroll
        for (int j = j0; j < j0 + kCollapseEvery; ++j) {
          r3[0] = r2[0];
          r2[0] = r1[0];
          r1[0] = chain_step(r1[0], fk[j]);
        }
      }
    }
    if (one) {
#pragma unroll
      for (int i = 1; i < kCand; ++i) {
        r1[i] = r1[0];
        r2[i] = r2[0];
        r3[i] = r3[0];
      }
    }
    t1 = t2 = t3 = 0;
  } else {
    for (int j = 0; j < n; ++j) {
      const float2 p = fk[j];
      const uint32_t lag = meta[j] & 3;
#pragma unroll
      for (int i = 0; i < kCand; ++i) {
        const float x = lag == 3 ? r3[i] : (lag == 2 ? r2[i] : r1[i]);
        r3[i] = r2[i];
        r2[i] = r1[i];
        r1[i] = chain_step(x, p);
      }
      const uint32_t tn = lag == 3 ? t3 : (lag == 2 ? t2 : t1);
      t3 = t2;
      t2 = t1;
      t1 = tn;
    }
  }
  lut2[l] = make_uint2(pack4(r1), pack4(r1 + 4));
  lut2[32 + l] = make_uint2(pack4(r2), pack4(r2 + 4));
  lut2[64 + l] = make_uint2(pack4(r3), pack4(r3 + 4));
  if (l == 0) *tag = t1 | (t2 << 8) | (t3 << 16);
}

// Step 4 for one segment of n pixels (fk, meta and the ring row cur from its
// first): its values from the entry triple e, four bytes to a ring word;
// clears its flag, which this row's build alone reads.
__device__ __forceinline__ void replay_segment(const float2* fk, const uint32_t* meta,
                                               uint32_t* flag, uint32_t e, int n, uint8_t* cur) {
  float v1 = as_chain(e & 255), v2 = as_chain((e >> 8) & 255), v3 = as_chain(e >> 16);
  const bool lag1 = !*flag;
  *flag = 0;
  uint32_t* cur32 = reinterpret_cast<uint32_t*>(cur);
  if (n == kSeg) {  // straight-line, 8 pixels' loads ahead of the chain
#pragma unroll
    for (int j0 = 0; j0 < kSeg; j0 += 8) {
      float2 p[8];
      uint32_t lag[8];
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        p[u] = fk[j0 + u];
        lag[u] = lag1 ? 1 : meta[j0 + u] & 3;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float x = lag[u] == 3 ? v3 : (lag[u] == 2 ? v2 : v1);
        v3 = v2;
        v2 = v1;
        v[u] = v1 = chain_step(x, p[u]);
      }
      cur32[j0 >> 2] = pack4(v);
      cur32[(j0 >> 2) + 1] = pack4(v + 4);
    }
  } else {
    for (int j0 = 0; j0 < n; j0 += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (j0 + u < n) {
          const uint32_t lag = meta[j0 + u] & 3;
          const float x = lag == 3 ? v3 : (lag == 2 ? v2 : v1);
          v3 = v2;
          v2 = v1;
          v1 = chain_step(x, fk[j0 + u]);
        }
        v[u] = v1;
      }
      cur32[j0 >> 2] = pack4(v);
    }
  }
}

// N_row: the pixels of each (B, N_row) row of the inputs; W_max: the width
// the buffers are sized for; geo: the geometry table, or nullptr for N_row
// pixels of width W_max in every image.
template <bool kStaged>
__global__ void __launch_bounds__(1024)
    reconstruct_rows_kernel(const int* __restrict__ form, const int* __restrict__ delta,
                            const int* __restrict__ refoff, const int* __restrict__ prev4,
                            int* __restrict__ out, uint8_t* scratch, const int* __restrict__ geo, int N_row,
                            int W_max) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int bc = blockIdx.x;  // b * 3 + c
  const long long b = bc / 3;
  const int W = nt::geo_width(geo, b, W_max);
  const int N = (int)nt::geo_pixels(geo, b, N_row);
  const ReconLayout lay(W);
  uint8_t* buf = kStaged ? smem : scratch + (long long)bc * ReconLayout(W_max).stage;
  float2* fk = reinterpret_cast<float2*>(buf + lay.fk);
  uint32_t* meta = reinterpret_cast<uint32_t*>(buf + lay.meta);
  uint8_t* ring = buf + lay.ring;
  uint2* lut2 = reinterpret_cast<uint2*>(buf + lay.lut);
  const uint8_t* lut8 = buf + lay.lut;
  uint32_t* tags = reinterpret_cast<uint32_t*>(buf + lay.tags);
  uint32_t* bnd = reinterpret_cast<uint32_t*>(buf + lay.bnd);
  uint32_t* flag = reinterpret_cast<uint32_t*>(buf + lay.flag);
  uint8_t* glut = buf + lay.glut;
  uint32_t* gtags = reinterpret_cast<uint32_t*>(buf + lay.gtags);
  uint32_t* gbnd = reinterpret_cast<uint32_t*>(buf + lay.gbnd);
  int* st_form = reinterpret_cast<int*>(buf + lay.stage);
  int* st_delta = st_form + W;
  int* st_ro = st_delta + W;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int Wp = (int)r16(W);
  const int S = (W + kSeg - 1) / kSeg;
  const int H = N / W;
  const int* f_img = form + b * N_row;
  const int* ro_img = refoff + b * N_row;
  const int* d_img = delta + (long long)bc * N_row;
  int* o_img = out + (long long)bc * N_row;
  for (int i = N + tid; i < N_row; i += nt) o_img[i] = 0;  // past the image

  auto ring_at = [&](int slot, int col) -> uint32_t { return ring[slot * Wp + col]; };

  // rows -4 .. -1: the carry (row -4 + j in slot j, since row r lives in
  // slot r & 3), or zeros before the raster start
  const int* p4 = prev4 != nullptr ? prev4 + (long long)bc * 4 * W : nullptr;
  for (int i = tid; i < 4 * Wp; i += nt) {
    const int j = i / Wp, x = i - j * Wp;
    ring[i] = p4 != nullptr && x < W ? (uint8_t)p4[j * W + x] : 0;
  }
  for (int s = tid; s < S; s += nt) flag[s] = 0;
  auto fetch = [&](int r) {  // cp.async the inputs of row r into the stage
    const long long base = (long long)r * W;
    for (int x = tid; x < W; x += nt) {
      cp_async4(st_form + x, f_img + base + x);
      cp_async4(st_delta + x, d_img + base + x);
      cp_async4(st_ro + x, ro_img + base + x);
    }
    cp_async_commit();
  };
  if (kStaged) fetch(0);

  for (int r = 0; r < H; ++r) {
    uint8_t* cur = ring + (r & 3) * Wp;
    const uint8_t* above = ring + ((r + 3) & 3) * Wp;  // row r - 1 (zeros before row 0)
    if (kStaged) cp_async_wait_all();
    __syncthreads();  // the stage, the flags, and the previous row's ring and fix-up

    // 1. stage: each pixel's (lag, k, c)
    for (int x = tid; x < W; x += nt) {
      const long long i = (long long)r * W + x;
      const int f = kStaged ? st_form[x] : f_img[i];  // any form outside 0..3 is HALF
      const int ro = kStaged ? st_ro[x] : ro_img[i];
      const uint32_t d = (kStaged ? st_delta[x] : d_img[i]) & 255;
      stage_pixel(f, ro, d, x, x, r, W, ring_at, above, fk, meta, flag);
    }
    __syncthreads();
    if (kStaged && r + 1 < H) fetch(r + 1);  // overlaps the rest of this row

    // 2. build: item = (segment s, lane l holding candidates 8l .. 8l+7)
    for (int item = tid; item < S * 32; item += nt) {
      const int s = item >> 5;
      const int x0 = s * kSeg;
      build_segment(fk + x0, meta + x0, flag + s, min(kSeg, W - x0), item & 31, lut2 + s * 96,
                    tags + s);
    }
    __syncthreads();

    // 3. resolve: the entry triple of every segment.  Past 2 * kGroup
    //    segments, a warp first composes each group of kGroup segments into
    //    one LUT triple, one thread carries the triple across the groups, and
    //    one thread per group then across its segments.
    if (S <= 2 * kGroup) {
      if (tid == 0) resolve_run(lut8, tags, bnd, 0, S, above[W - 1], above[W - 2], above[W - 3]);
    } else {
      const int NG = (S + kGroup - 1) / kGroup;
      for (int g = tid >> 5; g < NG; g += nt >> 5)
        compose_group(lut8, tags, g * kGroup, min(S, (g + 1) * kGroup), glut + g * 768, gtags + g,
                      tid & 31);
      __syncthreads();
      if (tid == 0) resolve_run(glut, gtags, gbnd, 0, NG, above[W - 1], above[W - 2], above[W - 3]);
      __syncthreads();
      for (int g = tid; g < NG; g += nt) {
        const uint32_t e = gbnd[g];
        resolve_run(lut8, tags, bnd, g * kGroup, min(S, (g + 1) * kGroup), e & 255, (e >> 8) & 255,
                    e >> 16);
      }
    }
    __syncthreads();

    // 4. replay: one thread per segment, four bytes to a ring word
    for (int s = tid; s < S; s += nt) {
      const int x0 = s * kSeg;
      replay_segment(fk + x0, meta + x0, flag + s, bnd[s], min(kSeg, W - x0), cur + x0);
    }
    __syncthreads();

    // store all but the last 3 columns; 5. one thread fixes those up
    for (int x = tid; x < W - 3; x += nt) o_img[(long long)r * W + x] = cur[x];
    if (tid == 0) {
      for (int x = W - 3; x < W; ++x) {
        const uint32_t m = meta[x];
        const uint32_t cc = (m >> 2) & 3, lag = m & 3;
        float2 p = fk[x];
        if (cc) p = pixel_fk(0, 2 * ((cur[cc - 1] + (m >> 8)) & 255));
        const int back = x - (int)lag;  // the lag's column, -2 .. W - 2
        const uint32_t xv = back >= 0 ? cur[back] : above[W + back];
        const uint32_t v = chain_byte(chain_step(as_chain(xv), p));
        cur[x] = v;
        o_img[(long long)r * W + x] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// reconstruct_rows_cluster: the same scheme for rows too wide for one block's
// shared memory, one thread-block cluster of C CTAs a (image, channel) chain.
// The S segments of a row split evenly over the CTAs: CTA j owns segments
// [j S / C, (j + 1) S / C) and their columns, and holds their fk, meta,
// flags, LUTs, staged inputs and its columns of the 4-row ring in its own
// shared memory.  For each row:
//   1. stage: each CTA stages its slice.  A CONST reference reaches at most 3
//      columns either side of its pixel, wrapping at the row's ends, so those
//      at a slice's edges (and the first and last columns' wrap) read the
//      rows above from the neighbouring CTA's ring through distributed shared
//      memory;
//   2. build: each CTA builds its segments' LUTs, as the one-block kernel;
//   3. resolve, in three levels: each CTA composes its groups of kCGroup
//      segments, then its groups into one LUT triple (the CTA's); after a
//      cluster barrier every CTA copies the triples of the CTAs before it,
//      and one thread carries the row's entry triple (the previous row's
//      last three values) across them and on across its own groups; one
//      thread a group then resolves its segments;
//   4. replay: each CTA replays its segments and stores its columns;
//   5. fix-up: the last CTA recomputes columns W - 3 .. W - 1.  Their CONST
//      references land in columns 0..2 of the row, which one of its threads
//      computes during step 3 from the first CTA's first three pixels and
//      the row's entry triple.
// Two cluster barriers a row: after the composition (every CTA's stage done
// and its triple written; every CTA reads the triples and the row's entry
// only after it) and after the replay (the ring rows final for the next
// row's stage); the stores of a row's columns run between that barrier's
// arrive and its wait.  The outputs equal the one-block kernel's: the same
// steps in the same precision.
// ---------------------------------------------------------------------------
constexpr int kMaxCtas = 16;       // the largest cluster (16 is non-portable)
constexpr int kSlicePixels = 1024; // a CTA's share of a row that sets the cluster's size
constexpr int kCGroup = 8;         // segments a group in a CTA's resolve

// First segment of CTA j of C over S segments.
__host__ __device__ __forceinline__ int slice_seg(int j, int S, int C) {
  return (int)((long long)j * S / C);
}

// Byte offsets of one CTA's buffers at width W over C CTAs.
struct ClusterLayout {
  int SP, P;  // the most segments and columns of a slice
  size_t fk, meta, ring, lut, tags, bnd, flag, xlut, xtags, xbnd, clut, misc, stage, end;
  __host__ __device__ ClusterLayout(int W, int C) {
    const int S = (W + kSeg - 1) / kSeg;
    SP = (S + C - 1) / C;
    P = SP * kSeg;
    const size_t NX = C - 1 + (SP + kCGroup - 1) / kCGroup;  // the CTAs before, then own groups
    fk = 0;                             // per column: float2 (k / 2, addend)
    meta = fk + 8 * (size_t)P;          // per column: lag | cc << 2 | d << 8
    ring = meta + 4 * (size_t)P;        // rows r-4 .. r-1 of the slice, stride P
    lut = ring + 4 * (size_t)P;         // SP x 3 lags x 256 bytes
    tags = lut + 768 * (size_t)SP;
    bnd = tags + r16(4 * (size_t)SP);
    flag = bnd + r16(4 * (size_t)SP);
    xlut = flag + r16(4 * (size_t)SP);  // NX LUT triples: the CTAs' before this one, own groups'
    xtags = xlut + 768 * NX;
    xbnd = xtags + r16(4 * NX);
    clut = xbnd + r16(4 * NX);          // this CTA's triple, read by the CTAs after it
    misc = clut + 768;                  // words: its tags, the row's entry, columns 0..2
    stage = misc + 16;                  // form, delta, refoff of the next row
    end = stage + 12 * (size_t)P;
  }
};

// A cluster barrier in two halves (release on arrive, acquire on wait, by
// default): a thread's writes before its arrive are seen after every wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// N_row, W_max, geo: as reconstruct_rows_kernel's.
__global__ void __launch_bounds__(1024)
    reconstruct_rows_cluster_kernel(const int* __restrict__ form, const int* __restrict__ delta,
                                    const int* __restrict__ refoff, const int* __restrict__ prev4,
                                    int* __restrict__ out, const int* __restrict__ geo, int N_row, int W_max) {
  extern __shared__ __align__(16) uint8_t smem[];
  const cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int j = (int)cluster.block_rank();
  const int bc = blockIdx.x / C;  // b * 3 + c
  const long long b = bc / 3;
  const int W = nt::geo_width(geo, b, W_max);
  const int N = (int)nt::geo_pixels(geo, b, N_row);
  const ClusterLayout lay(W, C);
  float2* fk = reinterpret_cast<float2*>(smem + lay.fk);
  uint32_t* meta = reinterpret_cast<uint32_t*>(smem + lay.meta);
  uint8_t* ring = smem + lay.ring;
  uint2* lut2 = reinterpret_cast<uint2*>(smem + lay.lut);
  const uint8_t* lut8 = smem + lay.lut;
  uint32_t* tags = reinterpret_cast<uint32_t*>(smem + lay.tags);
  uint32_t* bnd = reinterpret_cast<uint32_t*>(smem + lay.bnd);
  uint32_t* flag = reinterpret_cast<uint32_t*>(smem + lay.flag);
  uint8_t* xlut = smem + lay.xlut;
  uint32_t* xtags = reinterpret_cast<uint32_t*>(smem + lay.xtags);
  uint32_t* xbnd = reinterpret_cast<uint32_t*>(smem + lay.xbnd);
  uint8_t* clut = smem + lay.clut;
  uint32_t* misc = reinterpret_cast<uint32_t*>(smem + lay.misc);  // ctag, entry, edge
  int* st_form = reinterpret_cast<int*>(smem + lay.stage);
  int* st_delta = st_form + lay.P;
  int* st_ro = st_delta + lay.P;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int Pp = lay.P;  // ring stride
  const int S = (W + kSeg - 1) / kSeg;
  const int s0 = slice_seg(j, S, C);
  const int nseg = slice_seg(j + 1, S, C) - s0;
  const int x0 = s0 * kSeg;
  const int P = min(W, (s0 + nseg) * kSeg) - x0;  // this slice's columns
  const int NG = (nseg + kCGroup - 1) / kCGroup;
  const bool last = j == C - 1;
  const int H = N / W;
  const int* f_img = form + b * N_row;
  const int* ro_img = refoff + b * N_row;
  const int* d_img = delta + (long long)bc * N_row;
  int* o_img = out + (long long)bc * N_row;
  for (int i = N + j * nt + tid; i < N_row; i += C * nt) o_img[i] = 0;  // past the image

  // the ring's byte at column col of a slot, from the CTA that owns it
  auto ring_at = [&](int slot, int col) -> uint32_t {
    if (col >= x0 && col < x0 + P) return ring[slot * Pp + col - x0];
    const int o = (int)(((long long)(col / kSeg + 1) * C + S - 1) / S) - 1;
    return *cluster.map_shared_rank(ring + slot * Pp + col - slice_seg(o, S, C) * kSeg, o);
  };

  const int* p4 = prev4 != nullptr ? prev4 + (long long)bc * 4 * W : nullptr;
  for (int i = tid; i < 4 * Pp; i += nt) {
    const int q = i / Pp, xl = i - q * Pp;
    ring[i] = p4 != nullptr && xl < P ? (uint8_t)p4[q * W + x0 + xl] : 0;
  }
  for (int s = tid; s < nseg; s += nt) flag[s] = 0;
  auto fetch = [&](int r) {  // cp.async the slice's inputs of row r into the stage
    const long long base = (long long)r * W + x0;
    for (int x = tid; x < P; x += nt) {
      cp_async4(st_form + x, f_img + base + x);
      cp_async4(st_delta + x, d_img + base + x);
      cp_async4(st_ro + x, ro_img + base + x);
    }
    cp_async_commit();
  };
  fetch(0);
  cp_async_wait_all();
  cluster_arrive();  // the rings are set, and every CTA of the cluster runs

  for (int r = 0; r < H; ++r) {
    uint8_t* cur = ring + (r & 3) * Pp;
    const uint8_t* above = ring + ((r + 3) & 3) * Pp;  // row r - 1
    cluster_wait();  // the rows above are final in every slice; this row's stage is here

    // 1. stage: each column's (lag, k, c)
    for (int xl = tid; xl < P; xl += nt)  // any form outside 0..3 is HALF
      stage_pixel(st_form[xl], st_ro[xl], st_delta[xl] & 255, x0 + xl, xl, r, W, ring_at, above, fk,
                  meta, flag);
    __syncthreads();
    if (r + 1 < H) fetch(r + 1);  // overlaps the rest of this row

    // 2. build: item = (segment s, lane l holding candidates 8l .. 8l+7)
    for (int item = tid; item < nseg * 32; item += nt) {
      const int s = item >> 5;
      const int xs = s * kSeg;
      build_segment(fk + xs, meta + xs, flag + s, min(kSeg, P - xs), item & 31, lut2 + s * 96,
                    tags + s);
    }
    __syncthreads();

    // 3. resolve: a warp composes each group into xlut slot j + g, one warp
    //    the groups into the CTA's triple (the last CTA's is read by none)
    for (int g = tid >> 5; g < NG; g += nt >> 5)
      compose_group(lut8, tags, g * kCGroup, min(nseg, (g + 1) * kCGroup), xlut + (j + g) * 768,
                    xtags + j + g, tid & 31);
    __syncthreads();
    if (!last && tid < 32) compose_group(xlut, xtags, j, j + NG, clut, misc, tid);
    cluster_arrive();
    cluster_wait();  // every CTA's triple, and every stage of this row, done

    // the triples of the CTAs before this one, and the row's entry triple
    for (int i = tid; i < j * 48; i += nt) {
      const int o = i / 48, q = i - o * 48;
      reinterpret_cast<uint4*>(xlut + o * 768)[q] =
          *cluster.map_shared_rank(reinterpret_cast<const uint4*>(clut) + q, o);
    }
    for (int o = tid; o < j; o += nt) xtags[o] = *cluster.map_shared_rank(misc, o);
    if (tid == nt - 1) {
      const int slot = (r + 3) & 3;
      misc[1] = ring_at(slot, W - 1) | (ring_at(slot, W - 2) << 8) | (ring_at(slot, W - 3) << 16);
    }
    __syncthreads();
    if (tid == 0) {
      const uint32_t e = misc[1];
      resolve_run(xlut, xtags, xbnd, 0, j + NG, e & 255, (e >> 8) & 255, e >> 16);
    } else if (last && tid == nt - 1) {
      // columns 0..2 of this row, for the fix-up: the first CTA's first
      // three pixels from the row's entry triple (none of them is fixed up)
      const float2* fk0 = cluster.map_shared_rank(fk, 0);
      const uint32_t* meta0 = cluster.map_shared_rank(meta, 0);
      const uint32_t e = misc[1];
      float v1 = as_chain(e & 255), v2 = as_chain((e >> 8) & 255), v3 = as_chain(e >> 16);
      uint32_t edge = 0;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
        const uint32_t lag = meta0[u] & 3;
        const float x = lag == 3 ? v3 : (lag == 2 ? v2 : v1);
        v3 = v2;
        v2 = v1;
        v1 = chain_step(x, fk0[u]);
        edge |= chain_byte(v1) << (8 * u);
      }
      misc[2] = edge;
    }
    __syncthreads();
    for (int g = tid; g < NG; g += nt) {
      const uint32_t e = xbnd[j + g];
      resolve_run(lut8, tags, bnd, g * kCGroup, min(nseg, (g + 1) * kCGroup), e & 255,
                  (e >> 8) & 255, e >> 16);
    }
    __syncthreads();

    // 4. replay: one thread per segment, four bytes to a ring word
    for (int s = tid; s < nseg; s += nt) {
      const int xs = s * kSeg;
      replay_segment(fk + xs, meta + xs, flag + s, bnd[s], min(kSeg, P - xs), cur + xs);
    }
    __syncthreads();

    // 5. the last CTA's thread 0 fixes up columns W - 3 .. W - 1 (the slice
    //    holds far more than the 6 columns they read back)
    const long long row = (long long)r * W + x0;
    if (last && tid == 0) {
      const uint32_t edge = misc[2];
      for (int xl = P - 3; xl < P; ++xl) {
        const uint32_t m = meta[xl];
        const uint32_t cc = (m >> 2) & 3, lag = m & 3;
        float2 p = fk[xl];
        if (cc) p = pixel_fk(0, 2 * ((((edge >> (8 * (cc - 1))) & 255) + (m >> 8)) & 255));
        const uint32_t v = chain_byte(chain_step(as_chain(cur[xl - lag]), p));
        cur[xl] = v;
        o_img[row + xl] = v;
      }
    }
    cp_async_wait_all();  // the next row's stage
    cluster_arrive();     // this row's ring columns are final
    for (int xl = tid; xl < (last ? P - 3 : P); xl += nt) o_img[row + xl] = cur[xl];
  }
  cluster_wait();  // no CTA leaves while another may read its shared memory
}

}  // namespace

extern "C" {

int nt_walk(const void* words, int Wn, const void* entries, const void* aff, const void* dD,
            const void* inc, const void* pfx, const void* wbits, void* pos, void* sym, void* i12,
            void* i34, void* exits, int B, int nch, int chunk_bits, int steps, int device,
            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long stage = (long long)kWalkThreads * (chunk_bits / 32) + 8;
  const size_t smem = sizeof(WalkTables) + 4 * (size_t)(stage < kStageWords ? stage : kStageWords);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((nch + kWalkThreads - 1) / kWalkThreads, B);
  walk_kernel<<<grid, kWalkThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(words), Wn, static_cast<const int*>(entries),
      static_cast<const int*>(aff), static_cast<const int*>(dD), static_cast<const int*>(inc),
      static_cast<const int*>(pfx), static_cast<const int*>(wbits),
      static_cast<int*>(pos), static_cast<int*>(sym), static_cast<uint32_t*>(i12),
      static_cast<uint32_t*>(i34), static_cast<int*>(exits), nch, chunk_bits, steps);
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

}  // extern "C"

namespace {

constexpr int kMaxDevices = 64;
int g_cluster_limit[kMaxDevices];  // 0 not probed yet, -1 no cluster, else the most CTAs

// The most CTAs a cluster of the cluster kernel takes on a device: 16, or 8
// where it refuses 16 (said once on stderr), or none below sm_90.  Probed
// once a device at its largest shared memory, when the kernel's attributes
// are set, once.  A failed probe returns its error and leaves none behind,
// and an sm_90 device that refuses an 8-CTA cluster is an error: neither
// falls back to the device-memory scratch path.  Sets the current device.
cudaError_t cluster_limit(int device, int optin, int* most) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int& lim = g_cluster_limit[device];
  if (lim == 0) {  // two threads may both probe; each stores the same answer
    int major = 0;
    cudaError_t err = cudaDeviceGetAttribute(&major, cudaDevAttrComputeCapabilityMajor, device);
    if (err != cudaSuccess) return err;
    int found = -1;
    if (major >= 9) {
      const void* fn = reinterpret_cast<const void*>(reconstruct_rows_cluster_kernel);
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      for (int c = kMaxCtas; c >= 8 && found < 0 && err == cudaSuccess; c /= 2) {
        cudaLaunchConfig_t cfg = {};
        cudaLaunchAttribute attr = {};
        attr.id = cudaLaunchAttributeClusterDimension;
        attr.val.clusterDim.x = c;
        attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
        cfg.gridDim = dim3(c);
        cfg.blockDim = dim3(1024);
        cfg.dynamicSmemBytes = optin;
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
        int n = 0;
        err = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
        if (err == cudaSuccess && n > 0) found = c;
      }
      if (err != cudaSuccess) {
        cudaGetLastError();  // the probe's own error, returned here
        return err;
      }
      if (found < 0) return cudaErrorNotSupported;
      if (found < kMaxCtas)
        std::fprintf(stderr, "nicetpu_torch: device %d refuses %d-CTA clusters; wide rows take %d\n",
                     device, kMaxCtas, found);
    }
    lim = found;
  }
  *most = lim > 0 ? lim : 0;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Where a chain of width W runs on this device: ctas 1 (one block, buffers
// in shared memory), 2..16 (a cluster: the fewest, a power of two, that
// gives each CTA at most about kSlicePixels columns and fits) or 0 (one
// block, buffers in device memory); scratch, the device-memory bytes a
// chain needs (0 unless ctas is 0).  Returns a CUDA error.
int nt_recon_plan(int W, int device, int* ctas, long long* scratch) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  *ctas = 1;
  *scratch = 0;
  if (ReconLayout(W).end <= (size_t)optin) return (int)cudaSuccess;
  int most = 0;
  err = cluster_limit(device, optin, &most);
  if (err != cudaSuccess) return (int)err;
  const int S = (W + kSeg - 1) / kSeg;
  int c = 2;
  while (c < most && c * kSlicePixels < W) c *= 2;
  for (*ctas = 0; c <= most && 2 * c <= S; c *= 2) {
    if (ClusterLayout(W, c).end <= (size_t)optin) {
      *ctas = c;
      return (int)cudaSuccess;
    }
  }
  *scratch = (long long)ReconLayout(W).stage;
  return (int)cudaSuccess;
}

// prev4: the (B, 3, 4W) carry, or nullptr for zeros before the raster start;
// ctas and scratch (its bytes a chain where ctas is 0) as nt_recon_plan
// gives them for W on this device.  geo: the (B, kGeoCols) geometry table,
// whose images' N_b <= N and W_b <= W all take the path ctas names, or
// nullptr (every image N pixels of width W).
int nt_reconstruct_rows(const void* form, const void* delta, const void* refoff, const void* prev4,
                        void* out, void* scratch, int ctas, const void* geo, int B, int N, int W, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int S = (W + kSeg - 1) / kSeg;
  const int threads = 32 * S < 256 ? 256 : (32 * S > 1024 ? 1024 : 32 * S);
  const int* f = static_cast<const int*>(form);
  const int* d = static_cast<const int*>(delta);
  const int* ro = static_cast<const int*>(refoff);
  const int* p4 = static_cast<const int*>(prev4);
  int* o = static_cast<int*>(out);
  const int* g = static_cast<const int*>(geo);
  cudaStream_t st = (cudaStream_t)stream;
  if (ctas == 0) {
    if (!scratch) return (int)cudaErrorInvalidValue;
    reconstruct_rows_kernel<false>
        <<<3 * B, threads, 0, st>>>(f, d, ro, p4, o, static_cast<uint8_t*>(scratch), g, N, W);
  } else if (ctas > 1) {
    // a size the probe allowed (it set the attributes), each CTA two segments or more
    if (device < 0 || device >= kMaxDevices || ctas > g_cluster_limit[device] || 2 * ctas > S)
      return (int)cudaErrorInvalidValue;
    const ClusterLayout lay(W, ctas);
    const int cthreads = 32 * lay.SP < 256 ? 256 : (32 * lay.SP > 1024 ? 1024 : 32 * lay.SP);
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr = {};
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = ctas;
    attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(3 * B * ctas);
    cfg.blockDim = dim3(cthreads);
    cfg.dynamicSmemBytes = lay.end;
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, reconstruct_rows_cluster_kernel, f, d, ro, p4, o, g, N, W);
    if (err != cudaSuccess) return (int)err;
  } else if (ctas == 1) {
    const size_t smem = ReconLayout(W).end;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(reconstruct_rows_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    reconstruct_rows_kernel<true><<<3 * B, threads, smem, st>>>(f, d, ro, p4, o, nullptr, g, N, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
