// K0: 2-bit pack + usable-prefix lengths of raw reads (Hopper, sm_90a).
//
// Replaces no TPU kernel: the JAX package packs on the host
// (w2rap_contigger_tpu/ops/pallas_kmer.py: pack_and_glen_host, the C++
// pass native/pack_kernel.cc) and uploads the packed rows.  On a card the
// count uploads the raw codes and qualities instead, and K0 computes what
// native/pack_kernel.cc w2rap_pack_glen computes, bit for bit:
//  - packed row r: the codes & 3 in big-endian 2-bit groups of 16 a
//    word, wr = (L + 15) / 16 words, the tail word zero-padded;
//  - glen[r]: the end of the rightmost run of k bases with q >= min_qual
//    within the read's length (clamped to L), else 0
//    (count_good_lengths, BuildReadQGraph.cc:962-987).
//
// Bound on this card: bytes, 2 B a base read (code and quality) against
// 0.25 B a base and 4 B a read written: 37.1 MB and about 11.1 us at
// 3.35 TB/s for a 65,536-read chunk of 250 bases.  Design:
//  - A thread an output word (16 bases), a warp 32 / wr whole rows when
//    wr <= 32 (two rows of 250 bases), else one row in turns of 32 words.
//    Rows of 250 bytes are not 4-byte aligned, so a thread reads the 5
//    aligned words that cover its 16 bytes of codes, and of qualities,
//    and funnel-shifts them into place: a warp's loads cover its rows'
//    contiguous bytes.
//  - The pack is byte arithmetic on those words (4 codes a word into 8
//    bits with one byte permute), the good-quality mask one SIMD byte
//    compare (__vcmpgeu4) and one multiply a word: no loop over bases.
//  - glen: each thread finds the last bad base of its word; an inclusive
//    max scan over the warp's lanes (5 shuffles; the row's start counts as
//    bad) gives the good run that enters each word.  A word's candidate
//    is the end of its leading good run where that run plus the entering
//    one reaches k, or, for k <= 16, the last end of k good bases inside
//    the word (a shift-and of the mask); a max over the row's lanes
//    (__reduce_max_sync) is glen.  A 32-word turn of a longer row carries
//    the last bad base to the next.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int PACK_THREADS = 256;

// The 16 bytes at p, of any alignment, as 4 little-endian words: the 5
// aligned words that cover them (none at or past `end`), funnel-shifted.
__device__ __forceinline__ void load16(const uint8_t* p, const uint8_t* end,
                                       uint32_t (&v)[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const uint32_t sh = 8u * (uint32_t)(a & 3);
  uint32_t x[5];
#pragma unroll
  for (int i = 0; i < 5; ++i)
    x[i] = reinterpret_cast<const uint8_t*>(w + i) < end ? __ldg(w + i) : 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __funnelshift_r(x[i], x[i + 1], sh);
}

// 4 codes, bytes c0..c3 of x (c0 the first base), as 8 bits c0 c1 c2 c3
// from the top, each & 3.
__device__ __forceinline__ uint32_t pack4(uint32_t x) {
  uint32_t y = __byte_perm(x & 0x03030303u, 0u, 0x0123);  // c3 | c2 << 8 | ..
  y |= y >> 6;
  return (y & 0xFu) | ((y >> 12) & 0xF0u);
}

// Bit i set where byte i of q is >= min_qual (each byte of mq4).
__device__ __forceinline__ uint32_t good4(uint32_t q, uint32_t mq4) {
  return ((__vcmpgeu4(q, mq4) & 0x01010101u) * 0x10204080u) >> 28;
}

__global__ void __launch_bounds__(PACK_THREADS)
pack_kernel(const uint8_t* __restrict__ bases, const uint8_t* __restrict__ quals,
            const int32_t* __restrict__ lengths, int64_t n, int L, int wr, int k,
            int min_qual, uint32_t* __restrict__ packed, int32_t* __restrict__ glen) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * PACK_THREADS + threadIdx.x) >> 5;
  // the warp's rows: rpw rows of wr lanes each, or one row in turns
  const int rpw = wr <= 32 ? 32 / wr : 1;
  const int turns = wr <= 32 ? 1 : (wr + 31) / 32;
  const int ri = wr <= 32 ? lane / wr : 0;  // the lane's row in the warp
  const int64_t r = warp * rpw + ri;
  const bool row_ok = ri < rpw && r < n;
  const uint32_t row_mask = wr >= 32 ? FULL
                            : row_ok ? ((1u << wr) - 1u) << (ri * wr) : 1u << lane;
  const int len = row_ok ? min(lengths[r], L) : 0;
  const uint8_t* const end = bases + n * L;
  const uint8_t* const qend = quals + n * L;
  const uint32_t mq4 = (uint32_t)min(max(min_qual, 0), 255) * 0x01010101u;
  // positions: 16 a lane from the warp's first row, its turns in order
  const int row0 = 16 * ri * wr;  // the lane's row's first position
  int carry = -1;                  // the last bad position of earlier turns
  int best = 0;                    // the row's largest k-run end so far
  for (int t = 0; t < turns; ++t) {
    const int w = wr <= 32 ? lane - ri * wr : 32 * t + lane;  // word of the row
    const bool ok = row_ok && w < wr;
    const int base = 16 * (wr <= 32 ? lane : 32 * t + lane);
    uint32_t word = 0u, good = 0u;
    if (ok) {
      const int64_t off = r * L + 16 * w;
      uint32_t c[4], q[4];
      load16(bases + off, end, c);
      load16(quals + off, qend, q);
      word = pack4(c[0]) << 24 | pack4(c[1]) << 16 | pack4(c[2]) << 8 | pack4(c[3]);
      good = good4(q[0], mq4) | good4(q[1], mq4) << 4 | good4(q[2], mq4) << 8 |
             good4(q[3], mq4) << 12;
      if (min_qual <= 0) good = 0xFFFFu;
      if (min_qual > 255) good = 0u;
      const int in_len = min(max(len - 16 * w, 0), 16);  // bases before len
      good &= (1u << in_len) - 1u;
      const int in_row = min(L - 16 * w, 16);  // bases before L (>= 1)
      word &= FULL << (2 * (16 - in_row));
      packed[r * wr + w] = word;
    }
    // the last bad position of this lane's word, then of every lane up to it
    const uint32_t bad = ~good & 0xFFFFu;
    int last = ok && bad ? base + 31 - __clz(bad) : -1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(FULL, last, d);
      if (lane >= d) last = max(last, up);
    }
    int before = __shfl_up_sync(FULL, last, 1);
    before = max(max(lane > 0 ? before : -1, carry), row0 - 1);
    carry = max(carry, __shfl_sync(FULL, last, 31));
    int cand = 0;
    if (ok) {
      const int run_in = base - 1 - before;  // good bases just before the word
      const int lead = bad ? __ffs(bad) - 1 : 16;
      if (run_in + lead >= k) cand = base + lead - row0;
      if (k <= 16) {
        uint32_t m = good;  // positions ending k good bases inside the word
        int have = 1;
        while (2 * have <= k) {
          m &= m << have;
          have *= 2;
        }
        if (have < k) m &= m << (k - have);
        if (m) cand = max(cand, base + 32 - __clz(m) - row0);
      }
    }
    best = max(best, __reduce_max_sync(row_mask, cand));
  }
  if (row_ok && lane == ri * wr) glen[r] = best;
}

}  // namespace

// bases, quals: (n, L) u8 row-major; lengths: (n,) i32; packed: (n, wr)
// u32 with wr = (L + 15) / 16; glen: (n,) i32.  Returns
// cudaGetLastError() after launch.
extern "C" int w2rap_pack(const void* bases, const void* quals, const void* lengths,
                          int64_t n, int64_t L, int64_t wr, int k, int min_qual,
                          void* packed, void* glen, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (L < 0 || L > (1 << 26) || wr != (L + 15) / 16) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  if (wr == 0) return (int)cudaMemsetAsync(glen, 0, (size_t)n * 4, s);
  const int64_t rpw = wr <= 32 ? 32 / wr : 1;
  const int64_t blocks = ((n + rpw - 1) / rpw + PACK_THREADS / 32 - 1) / (PACK_THREADS / 32);
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  pack_kernel<<<(unsigned)blocks, PACK_THREADS, 0, s>>>(
      static_cast<const uint8_t*>(bases), static_cast<const uint8_t*>(quals),
      static_cast<const int32_t*>(lengths), n, (int)L, (int)wr, k, min_qual,
      static_cast<uint32_t*>(packed), static_cast<int32_t*>(glen));
  return (int)cudaGetLastError();
}

// buf[4] <- registers a thread, local (spilled) bytes a thread, static
// shared bytes, most threads a block of pack_kernel.
extern "C" int w2rap_pack_attrs(int* buf) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, pack_kernel);
  if (err != cudaSuccess) return (int)err;
  buf[0] = a.numRegs;
  buf[1] = (int)a.localSizeBytes;
  buf[2] = (int)a.sharedSizeBytes;
  buf[3] = a.maxThreadsPerBlock;
  return (int)cudaSuccess;
}
