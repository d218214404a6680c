// CUDA kernels of the decode core's slot assembly (nicetpu_torch), for sm_90a.
//
// Built by nicetpu_torch/kernels/build.py into the kernel library (plain C
// interface, loaded with ctypes).  Wrapper: kernels/cuda_ops.py
// slot_assemble; plain version: kernels/decode3.py slot_assemble_plain
// (_slot_starts, then _compact).  Every entry point launches on the caller's
// stream, allocates nothing, and returns cudaGetLastError().
//
// Replaces no Pallas kernel: it stands for the JAX decode core's in-layout
// scans, nicetpu/kernels/decode3.py _cumsum_walk (:651) and _cummax_walk
// (:667), jnp inside the jitted core, which scan within each chunk and then
// over the tiny (B, nch) per-chunk totals broadcast back.  From the walk's
// final-round records, (B, nch, steps) int32 pos, sym, i12, i34 in serial
// slot order, it computes what _slot_starts and _compact compute: each
// slot's digit ordinal since the last prefix (MAX_RUN_DIGITS of them count;
// the 11th digit's value is capped at 1), its coverage clamped at N, the
// int64 exclusive pixel start, ok_cov (the coverage reaches N), and each
// image's real slots (prefixes starting below N) compacted in order into
// (B, K) arrays with their fills (PREFIX_RUN_BASE, 0, 0, N) and `live`.
// N is each image's own pixel count where the caller passes the batch's
// geometry table (a round-trip batch of several shapes), else one N for all.
//
// The scan state along an image is (run bit: a prefix was seen, digits
// since the last prefix or the start), packed in one int; `join` composes
// two segments (the later one's state if it holds a prefix, else the sum),
// an associative operation, so chunks scan independently:
//   1. slot_summary_kernel, one warp a chunk: its state from the image
//      start's, its prefixes, the syms of its first MAX_RUN_DIGITS leading
//      digits (before its first prefix: only they can count, and their
//      coverage depends on the digits carried in) and the coverage from its
//      first prefix on, which does not;
//   2. slot_scan_kernel, one block an image: the (B, nch) summaries scanned
//      in tiles, carrying the digit ordinal in and finishing each chunk's
//      leading coverage; writes each chunk's carry (ordinal, prefix rank,
//      int64 coverage offset), ok_cov and the real count.  Coverage never
//      falls, so a chunk ending at or below N holds only real prefixes, one
//      starting at N or past holds none, and the one chunk across N is
//      walked again by one warp to count its real prefixes;
//   3. slot_compact_kernel, one warp a chunk: the chunk again with its
//      carry, each real slot's sym, i12, i34 and start stored at its rank
//      (the image's prefixes before it: every one of them is real), then a
//      grid-stride pass writing `live` and the fills past each count.
// The wrapper reads the (B,) counts between 2 and 3 to size K.
//
// Bound: bytes.  It reads pos and sym twice (passes 1 and 3, 8 bytes a slot
// each time), i12 and i34 of the real slots, and writes 21 bytes a real
// column; its scratch is 80 bytes a chunk, nothing a slot.  torch's scans
// over (B, S) run each row's innermost dimension on a few SMs, serially; here
// every chunk is a warp's independent work (thousands an image), a warp
// takes 128 slots a step with 16-byte loads (4 a lane) and a shuffle scan,
// and only the per-image pass over the summaries is serial, in tiles of
// kScanThreads chunks.

#include "common.cuh"

namespace {

constexpr int kRunBase = 5;       // C.PREFIX_RUN_BASE: smaller symbols are prefixes, the rest run digits
constexpr int kMaxDigits = 11;    // C.MAX_RUN_DIGITS
constexpr int kRun = 1 << 24;     // the state's run bit; below it the digit count
constexpr int kSumInts = 16;      // a chunk's summary: npfx, digits, rest (int64), nlead, 11 leading syms
constexpr int kLead = 5;          // where the leading syms start in it
constexpr int kCarryInts = 4;     // a chunk's carry: ordinal in (-1: no prefix yet), rank in, coverage in (int64)
constexpr int kChunkWarps = 8;    // chunks a block of passes 1 and 3, one warp each
constexpr int kScanThreads = 512; // chunks a tile of pass 2
constexpr int kTileSlots = 128;   // slots a warp takes a step, 4 a lane
constexpr unsigned kFull = 0xffffffffu;

static_assert(kLead + kMaxDigits == kSumInts, "the summary holds every leading sym");

// Segment a, then segment b.
__device__ __forceinline__ int join(int a, int b) { return (b & kRun) ? b : a + b; }
// The same with the digit count held at kMaxDigits (pass 2's elements are).
__device__ __forceinline__ int join_sat(int a, int b) {
  return (b & kRun) ? b : (a & kRun) | min(kMaxDigits, (a & (kRun - 1)) + b);
}

// Coverage of a run digit of symbol s at ordinal k < kMaxDigits.
__device__ __forceinline__ long long digit_cov(int s, int k, long long N) {
  long long dv = (long long)s - kRunBase;
  if (k == kMaxDigits - 1 && dv > 1) dv = 1;
  return min(N, (dv << (3 * k)) + (k == 0));
}

template <class T>
__device__ __forceinline__ T shfl_up(T x, int d) {
  return __shfl_up_sync(kFull, x, d);
}

struct Acc {  // pass 2's coverage and prefix sums
  long long cov;
  int pfx;
};
__device__ __forceinline__ Acc shfl_up(Acc x, int d) {
  return {__shfl_up_sync(kFull, x.cov, d), __shfl_up_sync(kFull, x.pfx, d)};
}
__device__ __forceinline__ Acc operator+(Acc a, Acc b) { return {a.cov + b.cov, a.pfx + b.pfx}; }

struct Join {
  __device__ int operator()(int a, int b) const { return join(a, b); }
};
struct AddAcc {
  __device__ Acc operator()(Acc a, Acc b) const { return a + b; }
};
struct JoinSat {
  __device__ int operator()(int a, int b) const { return join_sat(a, b); }
};

template <class T, class Op>
__device__ __forceinline__ T warp_incl(T x, Op op) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T y = shfl_up(x, d);
    if (lane >= d) x = op(y, x);
  }
  return x;
}

// Block-wide exclusive scan (identity id); *total gets the whole block's.
// `warps` holds 32 values; the caller's next use of it follows a barrier.
template <class T, class Op>
__device__ T block_excl(T x, Op op, T id, T* warps, T* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const T incl = warp_incl(x, op);
  if (lane == 31) warps[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const T w = warp_incl(lane < nw ? warps[lane] : id, op);
    __syncwarp();
    warps[lane] = w;
  }
  __syncthreads();
  T ex = shfl_up(incl, 1);
  if (lane == 0) ex = id;
  *total = warps[nw - 1];
  const T before = warp ? warps[warp - 1] : id;
  __syncthreads();
  return op(before, ex);
}

struct Slots {  // one image's records and where a chunk's lie
  const int* pos;
  const int* sym;
  const int* i12;
  const int* i34;
  int wb;      // the image's payload bits
  int steps;
  long long N;
  bool vec;    // 16-byte loads: steps % 4 == 0 and pos, sym aligned
};

struct Compacted {  // pass 3's outputs, (B, K)
  int* sym;
  int* i12;
  int* i34;
  long long* start;
};

enum Mode { kSummary, kCount, kWrite };

// One warp walks the chunk of records at `base` from state st, coverage
// offset cov and prefix rank `rank`.  kSummary writes the chunk's summary
// to summ (started from the image start's state, cov and rank 0); kCount
// returns its real prefixes; kWrite stores each real slot at row + rank.
template <Mode M>
__device__ int chunk_walk(const Slots& r, long long base, int st, long long cov, int rank,
                          int* summ, const Compacted& o, long long row) {
  const int lane = threadIdx.x & 31;
  int npfx = 0, nlead = 0, nreal = 0;
  long long rest = 0;
  for (int t0 = 0; t0 < r.steps; t0 += kTileSlots) {
    if (M != kSummary && cov >= r.N) break;  // every later slot starts at N or past
    const int i0 = t0 + 4 * lane;
    int p[4], s[4];
    if (r.vec && i0 < r.steps) {
      const int4 pv = *reinterpret_cast<const int4*>(r.pos + base + i0);
      const int4 sv = *reinterpret_cast<const int4*>(r.sym + base + i0);
      p[0] = pv.x, p[1] = pv.y, p[2] = pv.z, p[3] = pv.w;
      s[0] = sv.x, s[1] = sv.y, s[2] = sv.z, s[3] = sv.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool in = i0 + u < r.steps;
        p[u] = in ? r.pos[base + i0 + u] : -1;
        s[u] = in ? r.sym[base + i0 + u] : 0;
      }
    }
    int e[4], agg = 0;  // each slot's segment: a prefix, a digit or nothing
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool valid = p[u] >= 0 && p[u] < r.wb;
      e[u] = !valid ? 0 : (s[u] < kRunBase ? kRun : 1);
      agg = join(agg, e[u]);
    }
    const int incl = warp_incl(agg, Join());
    int before = shfl_up(incl, 1);
    before = join(st, lane ? before : 0);
    st = join(st, __shfl_sync(kFull, incl, 31));
    long long cv[4], lsum = 0;
    int lp = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = before & (kRun - 1);
      long long c = 0;
      if (e[u] == kRun) {
        c = min(r.N, 1LL);
        ++lp;
      } else if (e[u] == 1) {
        if (before & kRun) {
          if (k < kMaxDigits) c = digit_cov(s[u], k, r.N);
        } else if (M == kSummary) {
          ++nlead;
          if (k < kMaxDigits) summ[kLead + k] = s[u];
        }
      }
      cv[u] = c;
      lsum += c;
      before = join(before, e[u]);
    }
    if (M == kSummary) {
      rest += lsum;
      npfx += lp;
      continue;
    }
    const Acc mine{lsum, lp};
    const Acc inc = warp_incl(mine, AddAcc());
    long long sc = cov + inc.cov - lsum;
    int sr = rank + inc.pfx - lp;
    cov += __shfl_sync(kFull, inc.cov, 31);
    rank += __shfl_sync(kFull, inc.pfx, 31);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (e[u] == kRun && sc < r.N) {
        if (M == kCount) {
          ++nreal;
        } else {
          const long long at = row + sr;
          const long long from = base + i0 + u;
          o.sym[at] = s[u];
          o.i12[at] = r.i12[from];
          o.i34[at] = r.i34[from];
          o.start[at] = sc;
        }
      }
      sc += cv[u];
      sr += e[u] == kRun;
    }
  }
#pragma unroll
  for (int d = 16; d; d >>= 1) {
    npfx += __shfl_xor_sync(kFull, npfx, d);
    nlead += __shfl_xor_sync(kFull, nlead, d);
    nreal += __shfl_xor_sync(kFull, nreal, d);
    rest += __shfl_xor_sync(kFull, rest, d);
  }
  if (M == kSummary && lane == 0) {
    summ[0] = npfx;
    summ[1] = st & (kRun - 1);  // digits after its last prefix, or all of them
    *reinterpret_cast<long long*>(summ + 2) = rest;
    summ[4] = nlead;
  }
  return nreal;
}

// Image b's records; its N from the geometry table where there is one.
__device__ __forceinline__ Slots image_slots(const int* pos, const int* sym, const int* i12, const int* i34,
                                             const int* wbits, int b, int steps, long long N, const int* geo,
                                             int vec) {
  return {pos, sym, i12, i34, wbits[b], steps, nt::geo_pixels(geo, b, N), vec != 0};
}

__global__ void __launch_bounds__(kChunkWarps * 32)
    slot_summary_kernel(const int* __restrict__ pos, const int* __restrict__ sym, const int* __restrict__ wbits,
                        int* __restrict__ summ, int nch, int steps, long long N, const int* __restrict__ geo,
                        int vec) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * kChunkWarps + (threadIdx.x >> 5);
  if (c >= nch) return;
  const long long chunk = (long long)b * nch + c;
  const Slots r = image_slots(pos, sym, nullptr, nullptr, wbits, b, steps, N, geo, vec);
  chunk_walk<kSummary>(r, chunk * steps, 0, 0, 0, summ + chunk * kSumInts, Compacted{}, 0);
}

__global__ void __launch_bounds__(kScanThreads)
    slot_scan_kernel(const int* __restrict__ pos, const int* __restrict__ sym, const int* __restrict__ wbits,
                     const int* __restrict__ summ, int* __restrict__ carry, int* __restrict__ counts,
                     bool* __restrict__ ok_cov, int nch, int steps, long long N, const int* __restrict__ geo,
                     int vec) {
  __shared__ int s_st[32];
  __shared__ Acc s_acc[32];
  __shared__ int s_real[32];
  __shared__ int s_cross;  // the chunk across N, or -1
  const int b = blockIdx.x;
  const long long N_all = N;
  N = nt::geo_pixels(geo, b, N);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_cross = -1;
  int st_carry = 0, real = 0;
  Acc acc_carry{0, 0};
  for (int c0 = 0; c0 < nch; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool in = c < nch;
    const int* sm = summ + ((long long)b * nch + c) * kSumInts;
    int npfx = 0, dig = 0, nlead = 0;
    long long rest = 0;
    if (in) {
      npfx = sm[0];
      dig = sm[1];
      rest = *reinterpret_cast<const long long*>(sm + 2);
      nlead = sm[4];
    }
    int st_total;
    const int e = (npfx > 0 ? kRun : 0) | min(dig, kMaxDigits);
    const int st_in = join_sat(st_carry, block_excl(e, JoinSat(), 0, s_st, &st_total));
    st_carry = join_sat(st_carry, st_total);
    const int d_in = (st_in & kRun) ? st_in & (kRun - 1) : -1;
    long long ccov = rest;
    if (in && d_in >= 0)
      for (int j = 0; j < nlead && d_in + j < kMaxDigits; ++j) ccov += digit_cov(sm[kLead + j], d_in + j, N);
    Acc acc_total;
    const Acc at = acc_carry + block_excl(Acc{ccov, npfx}, AddAcc(), Acc{0, 0}, s_acc, &acc_total);
    acc_carry = acc_carry + acc_total;
    if (in) {
      int* cr = carry + ((long long)b * nch + c) * kCarryInts;
      cr[0] = d_in;
      cr[1] = at.pfx;
      *reinterpret_cast<long long*>(cr + 2) = at.cov;
      if (at.cov + ccov <= N)
        real += npfx;
      else if (at.cov < N)
        s_cross = c;
    }
  }
#pragma unroll
  for (int d = 16; d; d >>= 1) real += __shfl_xor_sync(kFull, real, d);
  if (lane == 0) s_real[warp] = real;
  __syncthreads();  // also publishes s_cross and the carries written above
  if (warp == 0) {
    real = lane < (int)(blockDim.x >> 5) ? s_real[lane] : 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) real += __shfl_xor_sync(kFull, real, d);
    const int c = s_cross;
    if (c >= 0) {
      const long long chunk = (long long)b * nch + c;
      const int* cr = carry + chunk * kCarryInts;
      const int d_in = cr[0];
      const Slots r = image_slots(pos, sym, nullptr, nullptr, wbits, b, steps, N_all, geo, vec);
      real += chunk_walk<kCount>(r, chunk * steps, d_in >= 0 ? kRun | d_in : 0,
                                 *reinterpret_cast<const long long*>(cr + 2), cr[1], nullptr, Compacted{}, 0);
    }
    if (lane == 0) {
      counts[b] = real;
      ok_cov[b] = acc_carry.cov >= N;
    }
  }
}

__global__ void __launch_bounds__(kChunkWarps * 32)
    slot_compact_kernel(const int* __restrict__ pos, const int* __restrict__ sym, const int* __restrict__ i12,
                        const int* __restrict__ i34, const int* __restrict__ wbits, const int* __restrict__ carry,
                        const int* __restrict__ counts, Compacted o, bool* __restrict__ live, int B, int nch,
                        int steps, long long N, long long K, const int* __restrict__ geo, int vec) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * kChunkWarps + (threadIdx.x >> 5);
  if (c < nch) {
    const long long chunk = (long long)b * nch + c;
    const int* cr = carry + chunk * kCarryInts;
    const long long cov = *reinterpret_cast<const long long*>(cr + 2);
    if (cov < nt::geo_pixels(geo, b, N)) {
      const int d_in = cr[0];
      const Slots r = image_slots(pos, sym, i12, i34, wbits, b, steps, N, geo, vec);
      chunk_walk<kWrite>(r, chunk * steps, d_in >= 0 ? kRun | d_in : 0, cov, cr[1], nullptr, o, b * K);
    }
  }
  // `live` everywhere, the fills past each image's count
  const long long total = (long long)B * K;
  const long long stride = (long long)gridDim.x * gridDim.y * blockDim.x;
  for (long long i = ((long long)blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int bb = (int)(i / K);
    const bool on = i - bb * K < counts[bb];
    live[i] = on;
    if (!on) {
      o.sym[i] = kRunBase;
      o.i12[i] = 0;
      o.i34[i] = 0;
      o.start[i] = nt::geo_pixels(geo, bb, N);
    }
  }
}

}  // namespace

extern "C" {

// Bytes of scratch nt_slot_scan and nt_slot_compact share: the summaries and
// carries, 80 bytes a chunk, then the (B,) int32 counts, then the (B,) ok_cov
// bytes.  The wrapper allocates them (cuda_ops.slot_assemble).  geo: the
// (B, kGeoCols) geometry table (each image's own N), or null for N in all.
int nt_slot_scan(const void* pos, const void* sym, const void* wbits, void* scratch, int B, int nch, int steps,
                 long long N, const void* geo, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int* summ = static_cast<int*>(scratch);
  int* carry = summ + (long long)B * nch * kSumInts;
  int* counts = carry + (long long)B * nch * kCarryInts;
  bool* ok = reinterpret_cast<bool*>(counts + B);
  cudaStream_t st = (cudaStream_t)stream;
  const int* p = static_cast<const int*>(pos);
  const int* s = static_cast<const int*>(sym);
  const int* wb = static_cast<const int*>(wbits);
  const int* g = static_cast<const int*>(geo);
  slot_summary_kernel<<<dim3((nch + kChunkWarps - 1) / kChunkWarps, B), kChunkWarps * 32, 0, st>>>(
      p, s, wb, summ, nch, steps, N, g, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  slot_scan_kernel<<<B, kScanThreads, 0, st>>>(p, s, wb, summ, carry, counts, ok, nch, steps, N, g, vec);
  return (int)cudaGetLastError();
}

int nt_slot_compact(const void* pos, const void* sym, const void* i12, const void* i34, const void* wbits,
                    const void* scratch, void* out_sym, void* out_i12, void* out_i34, void* out_start, void* live,
                    int B, int nch, int steps, long long N, long long K, const void* geo, int vec, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int* carry = static_cast<const int*>(scratch) + (long long)B * nch * kSumInts;
  const int* counts = carry + (long long)B * nch * kCarryInts;
  const Compacted o{static_cast<int*>(out_sym), static_cast<int*>(out_i12), static_cast<int*>(out_i34),
                    static_cast<long long*>(out_start)};
  slot_compact_kernel<<<dim3((nch + kChunkWarps - 1) / kChunkWarps, B), kChunkWarps * 32, 0,
                        (cudaStream_t)stream>>>(
      static_cast<const int*>(pos), static_cast<const int*>(sym), static_cast<const int*>(i12),
      static_cast<const int*>(i34), static_cast<const int*>(wbits), carry, counts, o, static_cast<bool*>(live), B,
      nch, steps, N, K, static_cast<const int*>(geo), vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
