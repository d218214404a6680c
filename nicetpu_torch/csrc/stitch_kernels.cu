// CUDA kernel of the sharded encode's stitch (nicetpu_torch), for sm_90a.
//
// Built by nicetpu_torch/kernels/build.py into the kernel library (plain C
// interface, loaded with ctypes).  Wrapper: kernels/cuda_ops.py stitch_file;
// plain version: dist/sharded.py stitch_file_plain (stitch_payload, then the
// file around the payload).  The entry point launches on the caller's stream,
// allocates nothing, and returns cudaGetLastError().
//
// Replaces no Pallas kernel: the JAX package stitches the shards' payloads on
// the host, in numpy (nicetpu/dist/sharded.py stitch_payload), and so did the
// port's rank 0 before this kernel: each shard widened to uint64, shifted
// twice and ORed into a buffer, narrowed, byte-swapped and cut, every pass on
// one core, then the file concatenated around it.
//
// What it writes, from the gathered (n, k) words on rank 0's card: the whole
// .nice file, hlen + total / 8 + 5 bytes,
//   * the header (file header and stream headers, built on the host and
//     passed by value, at most kMaxHeader bytes),
//   * the payload: the shards' bit strings in rank order, shard d from bit
//     off[d] (the exclusive scan of the shards' totals, passed by value),
//     MSB-first and big-endian by 32-bit word, cut after its last whole byte,
//   * the trailer [B, B, 0, 0, 0], B the partial last byte (0 where the total
//     is a multiple of 8).
// Shard d's bits are the first off[d + 1] - off[d] bits of its row, MSB-first
// in each word; its bits past that are never read (the encoder leaves them
// zero, and stitch_payload ORs them in).  A shard of 0 bits is skipped.
//
// Schedule: one thread a 16-byte chunk of the file, written by one 16-byte
// store.  A chunk whose 128 bits lie inside one shard (all but a few) reads
// the five words of that shard that cover them, found by a binary search of
// the offsets, and funnel-shifts four big-endian words out of them.  The
// other chunks (those over the header, across a shard's edge, a shard shorter
// than 32 bits, the payload's end and the trailer) build each 32-bit payload
// word from every shard that covers it, then put the header's bytes and the
// trailer's second B in place, and store byte by byte where the chunk runs
// past the file's end.
//
// Bound: bytes.  The words are read once and the file written once: 2 x 229
// MB at 16384^2 (raster16k), 0.14 ms at 3.35 TB/s.  A warp's 32 chunks read
// 512 contiguous bytes of one shard in five 4-byte loads a thread (shard rows
// start at any bit, so the loads are not 16-byte aligned; L1 merges them) and
// write 512 contiguous bytes.

#include <cstring>

#include "common.cuh"

namespace {

using nt::aligned16;
using nt::kThreads;

constexpr int kMaxShards = 128;   // shards a launch takes (ranks of a group)
constexpr int kMaxHeader = 1024;  // header bytes (a .nice file's are 770)
constexpr int kChunk = 16;        // file bytes a thread

// Passed by value: 2,064 bytes of the 4,096 a launch's parameters may hold.
struct StitchArgs {
  long long off[kMaxShards + 1];  // shard d's first payload bit; off[n] the total
  unsigned char header[kMaxHeader];
  int n;
  int hlen;
};

// Bits [y, y + 32) of a shard's bit string of b >= 1 bits, MSB-first, zero
// outside [0, b); -32 < y < b.
__device__ __forceinline__ uint32_t shard_bits(const uint32_t* row, long long b, long long y) {
  const long long nw = (b + 31) >> 5;
  if (y >= 0) {
    const long long i = y >> 5;
    const uint32_t hi = __ldg(row + i);
    const uint32_t lo = i + 1 < nw ? __ldg(row + i + 1) : 0u;
    const uint32_t v = __funnelshift_l(lo, hi, (unsigned)(y & 31));
    const long long rem = b - y;
    return rem >= 32 ? v : v & (0xFFFFFFFFu << (32 - rem));
  }
  const int lead = (int)-y;  // the word's bits before the shard starts
  const uint32_t v = __ldg(row) >> lead;
  const long long end = lead + b;  // where the shard ends in the word
  return end >= 32 ? v : v & (0xFFFFFFFFu << (32 - end));
}

// The first shard d with off[d + 1] > bit (n where there is none).
__device__ __forceinline__ int shard_at(const StitchArgs& a, long long bit) {
  int lo = 0, hi = a.n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a.off[mid + 1] > bit) hi = mid;
    else lo = mid + 1;
  }
  return lo;
}

// Payload word u: bits [32u, 32u + 32), from every shard that covers them;
// 0 outside the payload.
__device__ uint32_t payload_word(const StitchArgs& a, const uint32_t* words, long long k, long long u) {
  if (u < 0) return 0u;
  const long long lo = u << 5;
  uint32_t v = 0u;
  for (int d = shard_at(a, lo); d < a.n && a.off[d] < lo + 32; ++d) {
    const long long b = a.off[d + 1] - a.off[d];
    if (b > 0) v |= shard_bits(words + (long long)d * k, b, lo - a.off[d]);
  }
  return v;
}

__device__ __forceinline__ uint32_t byte_of(uint32_t w, int m) { return (w >> (24 - 8 * m)) & 0xFFu; }

__global__ void __launch_bounds__(kThreads)
    stitch_kernel(const __grid_constant__ StitchArgs a, const uint32_t* __restrict__ words, long long k,
                  unsigned char* __restrict__ out, long long len) {
  const long long at = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kChunk;
  if (at >= len) return;
  const long long total = a.off[a.n];
  const long long x0 = (at - a.hlen) * 8;  // the chunk's first payload bit (< 0 over the header)
  uint32_t w[4];
  const int d = x0 >= 0 && x0 < total ? shard_at(a, x0) : a.n;
  const bool inside = d < a.n && x0 + 8 * kChunk <= a.off[d + 1];
  if (inside) {
    const uint32_t* row = words + (long long)d * k;
    const long long y = x0 - a.off[d];
    const long long i = y >> 5;
    const long long nw = (a.off[d + 1] - a.off[d] + 31) >> 5;
    uint32_t s[5];
#pragma unroll
    for (int j = 0; j < 5; ++j) s[j] = i + j < nw ? __ldg(row + i + j) : 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = __funnelshift_l(s[j + 1], s[j], (unsigned)(y & 31));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long x = x0 + 32 * j;  // a multiple of 8; floor division below
      const long long u = x >> 5;
      w[j] = __funnelshift_l(payload_word(a, words, k, u + 1), payload_word(a, words, k, u), (unsigned)(x & 31));
    }
    // the header's bytes, and the trailer's second B (its first is the
    // payload's partial byte, and its zeros are the payload's bits past the
    // total, which no shard holds)
    const long long nb = total >> 3;
    for (int m = 0; m < kChunk; ++m) {
      const long long i = at + m;
      uint32_t v;
      if (i < a.hlen) v = a.header[i];
      else if (i - a.hlen == nb + 1) v = byte_of(payload_word(a, words, k, nb >> 2), (int)(nb & 3));
      else continue;
      const int j = m >> 2, sh = 24 - 8 * (m & 3);
      w[j] = (w[j] & ~(0xFFu << sh)) | (v << sh);
    }
  }
  if (at + kChunk <= len && aligned16(out)) {
    uint4 q;
    q.x = __byte_perm(w[0], 0u, 0x0123);
    q.y = __byte_perm(w[1], 0u, 0x0123);
    q.z = __byte_perm(w[2], 0u, 0x0123);
    q.w = __byte_perm(w[3], 0u, 0x0123);
    *reinterpret_cast<uint4*>(out + at) = q;
  } else {
    for (int m = 0; m < kChunk && at + m < len; ++m) out[at + m] = (unsigned char)byte_of(w[m >> 2], m & 3);
  }
}

}  // namespace

extern "C" {

// words (n, k) uint32, row d shard d's words; off (n + 1) int64 on the host,
// the exclusive scan of the shards' bit totals; header hlen bytes on the host;
// out len = hlen + off[n] / 8 + 5 bytes on the card.
int nt_stitch_file(const void* words, long long k, const void* off, int n, const void* header, int hlen,
                   void* out, long long len, int device, void* stream) {
  if (n < 1 || n > kMaxShards || hlen < 0 || hlen > kMaxHeader || k < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  StitchArgs a = {};
  std::memcpy(a.off, off, sizeof(long long) * (n + 1));
  std::memcpy(a.header, header, hlen);
  a.n = n;
  a.hlen = hlen;
  const long long blocks = ((len + kChunk - 1) / kChunk + kThreads - 1) / kThreads;
  if (blocks < 1 || blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  stitch_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      a, static_cast<const uint32_t*>(words), k, static_cast<unsigned char*>(out), len);
  return (int)cudaGetLastError();
}

}  // extern "C"
