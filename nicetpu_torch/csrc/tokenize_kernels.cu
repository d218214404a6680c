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
// One launch a call (after one memset of a small scratch buffer).  A block
// takes a span of kSpan pixels of one image; spans are handed out by an
// atomic ticket, the last span of each image first, so that a block only
// ever waits on spans whose blocks already run (forward progress without
// co-residency and without relying on blockIdx order).  A block:
//   1. stages the pixels its probes read into shared memory as packed
//      32-bit words, zeros before the raster: four row segments at
//      distances 0, W, 2W and 3W (about 4 x (kSpan + 6) pixels), or one
//      window [s - 3W - 3, e) where that is no longer (W <= 1038), so a
//      probe is one shared-memory load at a constant offset.  Four pixels
//      are three aligned words of x, read by three 4-byte loads, unpacked by
//      byte permutes and stored as one 16-byte vector (pixel by pixel where
//      x is not word-aligned: the raster's 3-byte pixels rule out cp.async
//      and bulk copies of whole pixels);
//   2. finds its change mask by warp ballots and publishes its first change
//      (or "none") with a release store;
//   3. one warp looks ahead: it reads the later spans' words with acquire
//      loads, 32 at a time, until a span with a change (the common case:
//      the next one); an all-run span publishes the first change at or
//      after its start once it knows it, so a chain of them is crossed
//      without waiting on each block in turn;
//   4. each pixel's next change comes from its mask word and a suffix
//      minimum over the span's 32 mask words, then the tail (the first
//      changes of later shards);
//   5. each warp runs the mode cascade for its 32 pixels, stages their
//      5 + ndigits_cap bins in its own shared-memory buffer and writes them
//      out as one contiguous span of 16-byte vectors (coalesced scalars where
//      4 does not divide the slot count).
// The sharded encode finds each shard's first change first
// (first_change_kernel, one block an image, stops at the first block of
// pixels with a change), all-gathers it, and passes the later shards' as the
// tail.
// A batch of images of several shapes (the round trip's) is one upload
// padded to the largest image, with the batch's geometry table: a block
// takes its image's width and pixel count from it, looks ahead only over
// its image's spans, and writes holes past its image's pixels (a span wholly
// past them writes nothing else), so each image's bins are its own alone.
//
// Bound by bytes: 3 bytes read a pixel and 4 * (5 + ndigits_cap) written
// (32 at 3 run digits).  On an H100 80GB HBM3 at 700 W it runs at about half
// that bound (PERF.md §6): a block's serial steps (ticket, staging, three
// barriers, the look-ahead) take longer than its cascade, which hides
// under them.  Positions are int (rasters hold fewer than 2^31 pixels);
// flat bin indices are int64.

#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;  // pixels a thread
constexpr int kSpan = kThreads * kRounds;  // pixels a span; as cuda_ops.TOKENIZE_SPAN
constexpr int kMaskWords = kSpan / 32;  // at most one warp's lanes
static_assert(kMaskWords <= 32, "a span's mask words are one warp's lanes");
constexpr int kSegPitch = kSpan + 12;  // a staged row segment: up to kSpan + 6 pixels, 3 of alignment
constexpr int kStage = 4 * kSegPitch;  // words of staged pixels
constexpr int kMaxRunDigits = 11;
constexpr int kFirstThreads = 1024, kFirstPer = 4;  // first_change_kernel

// A span's published word: 0 not yet published; kNoChange, no change in the
// span and the next one not yet known; else 1 + the first change at or after
// the span's start.
constexpr unsigned kNoChange = 0xffffffffu;

// flat histogram bins of the ten streams (format/constants.py STREAM_BASE)
constexpr int kRgb = 0, kPrefixes = 256, kLumaBaseDiff = 269, kLumaOtherDiff = 333,
              kLumaBackRef = 365, kSmallDiff = 376, kLumaBaseDiff2 = 719, kLumaOtherDiff2 = 783,
              kLumaOtherDiffB2 = 815, kBackRef = 847;
// mode prefixes (format/constants.py)
constexpr int kModeBackRef = 0, kModeRgb = 1, kModeLuma = 2, kModeSmallDiff = 3, kModeLuma2 = 4,
              kRunBase = 5;

// A packed pixel: g in bits 0-10, r in 11-21, b in 22-31, each lane wide
// enough that the sums and differences below never carry into the next.
__host__ __device__ constexpr unsigned lanes(unsigned g, unsigned r, unsigned b) { return g | r << 11 | b << 22; }
constexpr unsigned kByteLanes = lanes(255, 255, 255);
// c - ref + kLumaBias leaves (dg + 32) & 255 in the g lane's low byte; minus
// that value in the r and b lanes it leaves (dr + 16) & 255 and (db + 16) & 255
constexpr unsigned kLumaBias = lanes(288, 560, 48), kLumaSpread = lanes(0, 1, 1);
constexpr unsigned kLumaMiss = lanes(0xc0, 0xe0, 0xe0);  // a set bit: the difference does not fit
constexpr unsigned kSdBias = lanes(259, 259, 259), kResBias = lanes(256, 256, 256);

__device__ __forceinline__ unsigned load_px(const uint8_t* __restrict__ img, long long k) {
  if (k < 0) return 0;
  const uint8_t* p = img + 3 * k;
  return lanes(__ldg(p + 1), __ldg(p), __ldg(p + 2));
}

// A pixel's bytes r, g, b in the low three bytes of w -> a packed pixel
__device__ __forceinline__ unsigned rgb_lanes(unsigned w) {
  return lanes((w >> 8) & 255u, w & 255u, (w >> 16) & 255u);
}

// Packed pixels k0 .. k0 + len - 1 of the image whose pixel 0 is flat pixel
// img0 of x (total pixels in all) into st[at ...], zeros where k < 0.
// at = f_lo mod 4, so that four pixels that start at a multiple of 4 (twelve
// bytes, three aligned words of x) land in one 16-byte store.
__device__ __forceinline__ void stage_range(unsigned* st, int at, const uint8_t* __restrict__ x, long long total,
                                            long long img0, long long k0, int len, int tid) {
  const long long f_lo = img0 + k0, f_hi = f_lo + len;
  if (reinterpret_cast<uintptr_t>(x) & 3) {  // x not word-aligned: pixel by pixel
    for (int i = tid; i < len; i += kThreads) st[at + i] = k0 + i < 0 ? 0u : load_px(x, f_lo + i);
    return;
  }
  const unsigned* xw = reinterpret_cast<const unsigned*>(x);
  for (long long g = (f_lo >> 2) + tid; 4 * g < f_hi; g += kThreads) {
    const long long f = 4 * g;
    unsigned q[4];
    if (f >= 0 && f + 4 <= total) {
      const unsigned w0 = __ldg(xw + 3 * g), w1 = __ldg(xw + 3 * g + 1), w2 = __ldg(xw + 3 * g + 2);
      q[0] = rgb_lanes(w0), q[1] = rgb_lanes(__byte_perm(w0, w1, 0x0543));
      q[2] = rgb_lanes(__byte_perm(w1, w2, 0x0432)), q[3] = rgb_lanes(w2 >> 8);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = f + i >= 0 && f + i < total ? load_px(x, f + i) : 0u;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = f + i < img0 ? 0u : q[i];
    const int d = (int)(f - f_lo);
    if (d >= 0 && f + 4 <= f_hi) {
      *reinterpret_cast<uint4*>(st + at + d) = make_uint4(q[0], q[1], q[2], q[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (d + i >= 0 && f + i < f_hi) st[at + d + i] = q[i];
      }
    }
  }
}

// COLOR_LUMA's differences against ref: the g, r, b lanes' low bytes hold
// (dg + 32) & 255, (dr + 16) & 255, (db + 16) & 255; they fit where no bit of
// kLumaMiss is set.
__device__ __forceinline__ unsigned luma(unsigned cb, unsigned ref) {
  const unsigned x = cb - ref;
  return x - (x & 255u) * kLumaSpread;
}
__device__ __forceinline__ bool fits(unsigned d) { return (d & kLumaMiss) == 0; }

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Where a span's probes read its staged pixels: offsets into the stage of
// the pixel at distance 0 (+3), W (+3), 2W and 3W (+3) before its pixel 0.
struct Bases {
  int d0, dW, d2W, d3W;
};

// The mode cascade (tokenize.cascade) and the slots (tokenize.assemble_bins)
// of a changed pixel p of the span at global position pos.  kEdge: the span
// starts before 3W + 3, where the position masks matter.
template <int kCap, bool kEdge>
__device__ __forceinline__ bool cascade(const unsigned* st, Bases o, int p, int pos, int W, int next,
                                        int invalid, int* out) {
  const long long lp = pos;
  auto at = [&](long long off) { return !kEdge || lp >= off; };
  const unsigned c = st[o.d0 + p + 3], pv = st[o.d0 + p + 2], u = st[o.dW + p + 3];
  const bool row0 = kEdge && lp < W, first = !kEdge || pos > 0;

  int br = -1;  // BACK_REF: the first exact match at 1, W, W-1, 2, 2W
  if (c == st[o.d2W + p] && at(2LL * W)) br = 4;
  if (c == st[o.d0 + p + 1] && at(2)) br = 3;
  if (c == st[o.dW + p + 4] && at(W - 1)) br = 2;
  if (c == u && at(W)) br = 1;
  if (c == pv && at(1)) br = 0;

  const unsigned avg = ((u + pv) >> 1) & kByteLanes;
  const unsigned t = c + kSdBias - (row0 ? pv : avg);  // lanes: 256 + 3 + difference
  const int sg = (int)(t & 0x7ff) - 256, sr = (int)((t >> 11) & 0x7ff) - 256, sb = (int)(t >> 22) - 256;
  const bool sd = first && (unsigned)sg <= 6u && (unsigned)sr <= 6u && (unsigned)sb <= 6u;
  const unsigned cb = c + kLumaBias;
  const unsigned l2 = luma(cb, avg);
  const bool l2_hit = !row0 && fits(l2);

  // COLOR_LUMA: the first of 11 references that fits, scanned last to first;
  // a warp skips it where none of its pixels needs it
  int li = -1;
  unsigned lx = 0;
  const bool need = br < 0 && !sd && !l2_hit;
  if (__any_sync(__activemask(), need)) {
#define NT_PROBE(q, idx, off)                         \
  {                                                   \
    const unsigned d = luma(cb, st[idx]);             \
    if (fits(d) && at(off)) li = q, lx = d;           \
  }
    NT_PROBE(10, o.d3W + p + 6, 3LL * W - 3)
    NT_PROBE(9, o.d3W + p, 3LL * W + 3)
    NT_PROBE(8, o.dW + p, (long long)W + 3)
    NT_PROBE(7, o.d3W + p + 2, 3LL * W + 1)
    NT_PROBE(6, o.d3W + p + 3, 3LL * W)
    NT_PROBE(5, o.d3W + p + 4, 3LL * W - 1)
    NT_PROBE(4, o.d0 + p, 3)
    NT_PROBE(3, o.dW + p + 6, (long long)W - 3)
    NT_PROBE(2, o.dW + p + 4, (long long)W - 1)
    NT_PROBE(1, o.dW + p + 3, (long long)W)
    NT_PROBE(0, o.d0 + p + 2, 1)
#undef NT_PROBE
  }
  // RGB residuals; pixel 0's predictor is 0
  const unsigned z = c + kResBias - (row0 ? (first ? pv : 0u) : avg);
  const int mode = br >= 0 ? kModeBackRef : sd ? kModeSmallDiff : l2_hit ? kModeLuma2 : li >= 0 ? kModeLuma : kModeRgb;

  out[0] = kPrefixes + mode;
  switch (mode) {
    case kModeBackRef:
      out[1] = kBackRef + br, out[2] = out[3] = out[4] = invalid;
      break;
    case kModeSmallDiff:
      out[1] = kSmallDiff + sr + 7 * sg + 49 * sb, out[2] = out[3] = out[4] = invalid;
      break;
    case kModeLuma2:
      out[1] = kLumaBaseDiff2 + (int)(l2 & 255), out[2] = kLumaOtherDiff2 + (int)((l2 >> 11) & 255);
      out[3] = kLumaOtherDiffB2 + (int)((l2 >> 22) & 255), out[4] = invalid;
      break;
    case kModeLuma:
      out[1] = kLumaBackRef + li, out[2] = kLumaBaseDiff + (int)(lx & 255);
      out[3] = kLumaOtherDiff + (int)((lx >> 11) & 255), out[4] = kLumaOtherDiff + (int)((lx >> 22) & 255);
      break;
    default:
      out[1] = kRgb + (int)((z >> 11) & 255), out[2] = kRgb + (int)(z & 255);
      out[3] = kRgb + (int)((z >> 22) & 255), out[4] = invalid;
  }
  // v = run - 1 in base 8, least significant digit first; ndigits is the
  // least d >= 1 with v < 8^d, i.e. ceil(bit length / 3)
  const int run = next - pos - 1;
  const unsigned v = (unsigned)max(run - 1, 0);
  const int ndigits = run > 0 ? max(1, (32 - __clz(v) + 2) / 3) : 0;
#pragma unroll
  for (int j = 0; j < kCap; ++j) out[5 + j] = j < ndigits ? kPrefixes + kRunBase + (int)((v >> (3 * j)) & 7) : invalid;
  return kCap < kMaxRunDigits && ndigits > kCap;
}

// Grid: one block a span, B * spans blocks.  kCap run-digit slots; S = 5 +
// kCap bins a pixel.  scratch (zeroed by the caller's memset): ticket, and
// words[b * spans + j] as above.  geo: the geometry table, or nullptr for
// W and n_total in every image.
template <int kCap>
__global__ void __launch_bounds__(kThreads) tokenize_kernel(
    const uint8_t* __restrict__ x, const int* __restrict__ tail, int n_tail, int* __restrict__ bins,
    uint8_t* __restrict__ ovf, unsigned* __restrict__ ticket, unsigned* __restrict__ words, long long n_ext,
    long long halo, int n_local, int g0, int n_total, int W, int spans, int invalid, const int* __restrict__ geo) {
  constexpr int S = 5 + kCap;
  constexpr bool kVec = S % 4 == 0, kSwizzle = S % 8 == 0;
  __shared__ __align__(16) unsigned stage[kStage];
  __shared__ unsigned mask[kMaskWords];
  __shared__ int word_next[kMaskWords];  // the first change after mask word w
  __shared__ __align__(16) int outbuf[kWarps][32 * S];
  __shared__ int sh_ticket, sh_tail;

  const int tid = (int)threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) sh_ticket = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int b = sh_ticket / spans, j = spans - 1 - sh_ticket % spans;  // the last span of an image first
  W = nt::geo_width(geo, b, W);
  n_total = (int)nt::geo_pixels(geo, b, n_total);
  const int n_img = min(n_local, n_total - g0);  // the image's local pixels
  const int img_spans = (n_img + kSpan - 1) / kSpan;
  const int s = j * kSpan, n = min(kSpan, n_img - s), base = g0 + s;
  unsigned* img_words = words + (long long)b * spans;
  const int n_out = min(kSpan, n_local - s);  // the span's pixels in the output
  auto holes = [&](int p_lo) {  // the span's pixels from p_lo on lie past the image
    int* dst = bins + ((long long)b * n_local + s) * S;
    for (int i = p_lo * S + tid; i < n_out * S; i += kThreads) dst[i] = invalid;
  };
  if (n <= 0) {
    holes(0);
    return;
  }

  // 1. stage: four row segments, or one window where W is small; each
  // range starts at the stage offset congruent to its first flat pixel mod 4
  const long long ks = halo + s, img0 = (long long)b * n_ext, total = (long long)(gridDim.x / spans) * n_ext;
  auto place = [&](int at0, long long k0) { return at0 + (int)((img0 + k0 - at0) & 3); };
  Bases o;
  if (3LL * W + 6 + kSpan <= kStage) {
    const int at = place(0, ks - 3LL * W - 3);
    o = {at + 3 * W, at + 2 * W, at + W + 3, at};
    stage_range(stage, at, x, total, img0, ks - 3LL * W - 3, n + 3 * W + 3, tid);
  } else {
    o = {place(0, ks - 3), place(kSegPitch, ks - W - 3), place(2 * kSegPitch, ks - 2LL * W),
         place(3 * kSegPitch, ks - 3LL * W - 3)};
    stage_range(stage, o.d0, x, total, img0, ks - 3, n + 3, tid);
    stage_range(stage, o.dW, x, total, img0, ks - W - 3, n + 6, tid);
    stage_range(stage, o.d2W, x, total, img0, ks - 2LL * W, n, tid);
    stage_range(stage, o.d3W, x, total, img0, ks - 3LL * W - 3, n + 6, tid);
  }
  __syncthreads();

  // 2. the change mask, a word a warp a round
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int p = r * kThreads + tid;
    const bool enc = p < n && (base + p == 0 || stage[o.d0 + p + 3] != stage[o.d0 + p + 2]);
    const unsigned ballot = __ballot_sync(0xffffffffu, enc);
    if (lane == 0) mask[r * kWarps + warp] = ballot;
  }
  __syncthreads();

  // 3. publish, look ahead, publish again; the suffix over the mask words
  if (warp == 0) {
    const unsigned m = lane < kMaskWords ? mask[lane] : 0u;
    const int f = m ? base + 32 * lane + __ffs(m) - 1 : INT_MAX;
    const int own = __reduce_min_sync(0xffffffffu, f);
    if (lane == 0) st_release(img_words + j, own < INT_MAX ? (unsigned)own + 1 : kNoChange);
    int next = n_total;
    for (int q0 = j + 1;;) {
      const int q = q0 + lane;
      const unsigned w = q < img_spans ? ld_acquire(img_words + q) : (unsigned)n_total + 1;
      const unsigned known = __ballot_sync(0xffffffffu, w != 0 && w != kNoChange);
      const unsigned ready = __ballot_sync(0xffffffffu, w != 0);
      if (known) {
        const int at = __ffs(known) - 1;
        const unsigned before = (1u << at) - 1;
        if ((ready & before) == before) {  // every span before it: no change
          next = (int)__shfl_sync(0xffffffffu, w, at) - 1;
          break;
        }
      } else if (ready == 0xffffffffu) {
        q0 += 32;
        continue;
      }
      __nanosleep(32);
    }
    if (lane == 0 && own == INT_MAX) st_release(img_words + j, (unsigned)next + 1);
    int t = INT_MAX;
    for (int i = lane; i < n_tail; i += 32) t = min(t, __ldg(tail + i));
    t = __reduce_min_sync(0xffffffffu, t);
    int sfx = __shfl_down_sync(0xffffffffu, f, 1);
    if (lane == kMaskWords - 1) sfx = next;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int other = __shfl_down_sync(0xffffffffu, sfx, d);
      if (lane + d < 32) sfx = min(sfx, other);
    }
    if (lane < kMaskWords) word_next[lane] = min(sfx, t);
    if (lane == 0) sh_tail = t;
  }
  __syncthreads();

  // 4-5. a warp's 32 pixels a round: the cascade, the bins, one store span
  const bool edge = (long long)base < 3LL * W + 3;
  const int tail_min = sh_tail;
  int* buf = outbuf[warp];
  bool over = false;
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    const int p0 = r * kThreads + warp * 32, count = min(32, n - p0);
    if (count <= 0) break;
    const int p = p0 + lane, pos = base + p;
    const unsigned ballot = mask[r * kWarps + warp];
    int out[S];
    if (lane < count && (ballot >> lane & 1u)) {
      const unsigned later = lane == 31 ? 0u : ballot & (0xffffffffu << (lane + 1));
      const int next = later ? min(pos - lane + __ffs(later) - 1, tail_min) : word_next[r * kWarps + warp];
      over |= edge ? cascade<kCap, true>(stage, o, p, pos, W, next, invalid, out)
                   : cascade<kCap, false>(stage, o, p, pos, W, next, invalid, out);
    } else {
#pragma unroll
      for (int q = 0; q < S; ++q) out[q] = invalid;
    }
    if (lane < count) {
      if constexpr (kVec) {
#pragma unroll
        for (int q = 0; q < S / 4; ++q) {
          const int chunk = lane * (S / 4) + q;
          reinterpret_cast<int4*>(buf)[kSwizzle ? chunk ^ ((chunk >> 3) & 7) : chunk] =
              make_int4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
        }
      } else {
#pragma unroll
        for (int q = 0; q < S; ++q) buf[lane * S + q] = out[q];
      }
    }
    __syncwarp();
    int* dst = bins + ((long long)b * n_local + s + p0) * S;
    if constexpr (kVec) {
      for (int chunk = lane; chunk < count * (S / 4); chunk += 32) {
        reinterpret_cast<int4*>(dst)[chunk] =
            reinterpret_cast<const int4*>(buf)[kSwizzle ? chunk ^ ((chunk >> 3) & 7) : chunk];
      }
    } else {
      for (int i = lane; i < count * S; i += 32) dst[i] = buf[i];
    }
    __syncwarp();
  }
  if (n < n_out) holes(n);
  if (__any_sync(0xffffffffu, over) && lane == 0) ovf[b] = 1;  // every writer stores 1
}

// Grid B, kFirstThreads threads: out[b] = the first changed global position
// of image b's local pixels, else n_total.  Blocks of kFirstThreads *
// kFirstPer pixels in turn, stopping at the first that holds a change.
__global__ void __launch_bounds__(kFirstThreads) first_change_kernel(
    const uint8_t* __restrict__ x, int* __restrict__ out, long long n_ext, long long halo, int n_local,
    int g0, int n_total) {
  __shared__ int warp_min[kFirstThreads / 32];
  const int tid = (int)threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint8_t* img = x + (long long)blockIdx.x * n_ext * 3;
  for (int i0 = 0; i0 < n_local; i0 += kFirstThreads * kFirstPer) {
    int f = INT_MAX;
#pragma unroll
    for (int q = kFirstPer - 1; q >= 0; --q) {
      const int i = i0 + q * kFirstThreads + tid;
      if (i < n_local && (g0 + i == 0 || load_px(img, halo + i) != load_px(img, halo + i - 1))) f = g0 + i;
    }
    if (__syncthreads_or(f < INT_MAX)) {
      f = __reduce_min_sync(0xffffffffu, f);
      if (lane == 0) warp_min[warp] = f;
      __syncthreads();
      if (warp == 0) {
        f = __reduce_min_sync(0xffffffffu, warp_min[lane]);
        if (lane == 0) out[blockIdx.x] = f;
      }
      return;
    }
  }
  if (tid == 0) out[blockIdx.x] = n_total;
}

template <int kCap>
void launch_tokenize(int grid, cudaStream_t stream, const uint8_t* x, const int* tail, int n_tail, int* bins,
                     uint8_t* ovf, unsigned* ticket, unsigned* words, long long n_ext, long long halo,
                     int n_local, int g0, int n_total, int W, int spans, int invalid, const int* geo) {
  tokenize_kernel<kCap><<<grid, kThreads, 0, stream>>>(x, tail, n_tail, bins, ovf, ticket, words, n_ext, halo,
                                                      n_local, g0, n_total, W, spans, invalid, geo);
}

using LaunchFn = void (*)(int, cudaStream_t, const uint8_t*, const int*, int, int*, uint8_t*, unsigned*,
                          unsigned*, long long, long long, int, int, int, int, int, int, const int*);
constexpr LaunchFn kLaunch[kMaxRunDigits + 1] = {
    launch_tokenize<0>, launch_tokenize<1>, launch_tokenize<2>, launch_tokenize<3>,
    launch_tokenize<4>, launch_tokenize<5>, launch_tokenize<6>, launch_tokenize<7>,
    launch_tokenize<8>, launch_tokenize<9>, launch_tokenize<10>, launch_tokenize<11>};

}  // namespace

extern "C" {

// first (B,) int32.
int nt_first_change(const void* x, void* first, int B, long long n_ext, long long halo, long long n_local,
                    long long g0, long long n_total, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  first_change_kernel<<<B, kFirstThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(x), static_cast<int*>(first), n_ext, halo, (int)n_local, (int)g0,
      (int)n_total);
  return (int)cudaGetLastError();
}

// bins (B, n_local * (5 + ndigits_cap)) int32.  scratch: scratch_bytes of
// device memory, zeroed here first: the overflow flags (B bytes), then at
// byte ticket_at the ticket and the B * ceil(n_local / kSpan) span words.
// tail: n_tail int32 on the device, or null.  geo: the (B, kGeoCols)
// geometry table on the device (halo and g0 0), or null.
int nt_tokenize_bins(const void* x, const void* tail, int n_tail, void* bins, void* scratch,
                     long long scratch_bytes, long long ticket_at, int B, long long n_ext, long long halo,
                     long long n_local, long long g0, long long n_total, int width, int ndigits_cap,
                     int invalid_bin, const void* geo, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (ndigits_cap < 0 || ndigits_cap > kMaxRunDigits) return (int)cudaErrorInvalidValue;
  const long long spans = (n_local + kSpan - 1) / kSpan;
  if (ticket_at % 4 || scratch_bytes < ticket_at + 4 * (1 + B * spans) || B * spans >= INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  auto s = (cudaStream_t)stream;
  err = cudaMemsetAsync(scratch, 0, scratch_bytes, s);
  if (err != cudaSuccess) return (int)err;
  auto* ticket = reinterpret_cast<unsigned*>(static_cast<uint8_t*>(scratch) + ticket_at);
  kLaunch[ndigits_cap]((int)(B * spans), s, static_cast<const uint8_t*>(x), static_cast<const int*>(tail),
                       n_tail, static_cast<int*>(bins), static_cast<uint8_t*>(scratch), ticket, ticket + 1,
                       n_ext, halo, (int)n_local, (int)g0, (int)n_total, width, (int)spans, invalid_bin,
                       static_cast<const int*>(geo));
  return (int)cudaGetLastError();
}

}  // extern "C"
