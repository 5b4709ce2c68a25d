// K1: kmerize + canonicalize packed reads (Hopper, sm_90a).
//
// Replaces the TPU kernel w2rap_contigger_tpu/ops/pallas_kmer.py:
// _kmerize_kernel (:64), launched by kmerize_packed_pallas (:240).
//
// One thread per (read, window).  Window p of read r covers bases
// [p, p+k); word j is the funnel shift of packed words q+j and q+j+1
// (q = p/16) left by 2*(p%16), the last word masked by the pad bits
// (pallas_kmer.py:74-88).  pred/succ bases and has_pred/has_succ follow
// pallas_kmer.py:95-111; the canonical form is the lexicographic min of
// fwd and rc, with rc_context on the rc (:113-116).  Windows at or past
// n_kmers = (glen > k ? glen-k+1 : 0) become all-ones sentinels, ctx 0.
//
// Output: W+1 planes of n_reads*P u32 (plane stride `stride`), row
// r*P + p: W canonical word planes, then the context plane.
//
// Bound on this card: the output write, 4*(W+1) bytes per window (20 B
// at W=4) against ~4*ceil(L/16)/P bytes of input per window, which the
// 16..W+1 threads sharing a packed word read from L1.  The design keeps
// every store coalesced (consecutive threads write consecutive rows of
// each plane) and keeps the W words, their rc and the compare in
// registers (W is a template parameter, 1..17).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int KMERIZE_THREADS = 256;

__device__ __forceinline__ uint32_t revpair32(uint32_t w) {
  w = ((w & 0x33333333u) << 2) | ((w >> 2) & 0x33333333u);
  w = ((w & 0x0F0F0F0Fu) << 4) | ((w >> 4) & 0x0F0F0F0Fu);
  w = ((w & 0x00FF00FFu) << 8) | ((w >> 8) & 0x00FF00FFu);
  return (w << 16) | (w >> 16);
}

__device__ __forceinline__ uint32_t rc_bits4(uint32_t b) {
  return ((b & 1u) << 3) | ((b & 2u) << 1) | ((b & 4u) >> 1) | ((b & 8u) >> 3);
}

template <int W>
__global__ void __launch_bounds__(KMERIZE_THREADS)
kmerize_kernel(const uint32_t* __restrict__ packed, int64_t n_reads,
               int64_t wr, const int32_t* __restrict__ glen, int k, int P,
               uint32_t* __restrict__ out, int64_t stride) {
  const int64_t t = (int64_t)blockIdx.x * KMERIZE_THREADS + threadIdx.x;
  if (t >= n_reads * (int64_t)P) return;
  const int64_t r = t / P;
  const int p = (int)(t - r * P);
  const uint32_t* row = packed + r * wr;
  const int g = glen[r];
  const int n_kmers = g > k ? g - k + 1 : 0;

  if (p >= n_kmers) {
#pragma unroll
    for (int j = 0; j < W; ++j) out[j * stride + t] = FULL;
    out[W * stride + t] = 0u;
    return;
  }

  // forward words: funnel shifts of adjacent packed words
  const int q = p >> 4;
  const int sh = 2 * (p & 15);
  uint32_t fw[W];
  uint32_t cur = q < wr ? row[q] : 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const uint32_t nxt = (q + j + 1) < wr ? row[q + j + 1] : 0u;
    fw[j] = __funnelshift_l(nxt, cur, sh);
    cur = nxt;
  }
  const int pad = 2 * (16 * W - k);
  if (pad) fw[W - 1] &= (FULL >> pad) << pad;

  // context byte: pred base at p-1 (p > 0), succ base at p+k (< glen)
  uint32_t ctx = 0u;
  if (p > 0) {
    const int pp = p - 1;
    const uint32_t b = (row[pp >> 4] >> (30 - 2 * (pp & 15))) & 3u;
    ctx |= (1u << b) << 4;
  }
  const int ps = p + k;
  if (ps < g && (ps >> 4) < wr) {
    const uint32_t b = (row[ps >> 4] >> (30 - 2 * (ps & 15))) & 3u;
    ctx |= 1u << b;
  }

  // reverse complement: reverse the 2-bit groups of the complemented
  // words in reverse word order, then shift the pad back to the bottom
  uint32_t rc[W];
#pragma unroll
  for (int j = 0; j < W; ++j) rc[j] = revpair32(~fw[W - 1 - j]);
  if (pad) {
#pragma unroll
    for (int j = 0; j < W - 1; ++j) rc[j] = __funnelshift_l(rc[j + 1], rc[j], pad);
    rc[W - 1] <<= pad;
  }

  // is_rev iff rc < fwd lexicographically (palindromes stay forward)
  bool decided = false, is_rev = false;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (!decided && rc[j] != fw[j]) {
      is_rev = rc[j] < fw[j];
      decided = true;
    }
  }
#pragma unroll
  for (int j = 0; j < W; ++j) out[j * stride + t] = is_rev ? rc[j] : fw[j];
  if (is_rev) ctx = (rc_bits4(ctx & 0xFu) << 4) | rc_bits4((ctx >> 4) & 0xFu);
  out[W * stride + t] = ctx;
}

template <int W>
cudaError_t launch_kmerize(const uint32_t* packed, int64_t n_reads, int64_t wr,
                           const int32_t* glen, int k, int P, uint32_t* out,
                           int64_t stride, cudaStream_t stream) {
  const int64_t total = n_reads * (int64_t)P;
  const int64_t blocks = (total + KMERIZE_THREADS - 1) / KMERIZE_THREADS;
  kmerize_kernel<W><<<(unsigned)blocks, KMERIZE_THREADS, 0, stream>>>(
      packed, n_reads, wr, glen, k, P, out, stride);
  return cudaGetLastError();
}

}  // namespace

// packed: (n_reads, wr) u32 rows; glen: (n_reads,) i32; out: (W+1, stride)
// u32 with stride >= n_reads*P.  Returns cudaGetLastError() after launch.
extern "C" int w2rap_kmerize(const void* packed, int64_t n_reads, int64_t wr,
                             const void* glen, int k, int P, void* out,
                             int64_t stride, void* stream) {
  if (n_reads <= 0 || P <= 0) return (int)cudaSuccess;
  const auto* pk = static_cast<const uint32_t*>(packed);
  const auto* gl = static_cast<const int32_t*>(glen);
  auto* o = static_cast<uint32_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch ((k + 15) / 16) {
#define W2RAP_CASE(W) \
  case W:             \
    return (int)launch_kmerize<W>(pk, n_reads, wr, gl, k, P, o, stride, s);
    W2RAP_CASE(1) W2RAP_CASE(2) W2RAP_CASE(3) W2RAP_CASE(4) W2RAP_CASE(5)
    W2RAP_CASE(6) W2RAP_CASE(7) W2RAP_CASE(8) W2RAP_CASE(9) W2RAP_CASE(10)
    W2RAP_CASE(11) W2RAP_CASE(12) W2RAP_CASE(13) W2RAP_CASE(14)
    W2RAP_CASE(15) W2RAP_CASE(16) W2RAP_CASE(17)
#undef W2RAP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
