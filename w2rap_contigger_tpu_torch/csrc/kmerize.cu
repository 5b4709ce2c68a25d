// K1: kmerize + canonicalize packed reads (Hopper, sm_90a).
//
// Replaces the TPU kernel w2rap_contigger_tpu/ops/pallas_kmer.py:
// _kmerize_kernel (:64), launched by kmerize_packed_pallas (:240).
//
// Window p of read r covers bases [p, p+k); word j is the funnel shift of
// packed words q+j and q+j+1 (q = p/16) left by 2*(p%16), the last word
// masked by the pad bits (pallas_kmer.py:74-88).  pred/succ bases and
// has_pred/has_succ follow pallas_kmer.py:95-111; the canonical form is
// the lexicographic min of fwd and rc, with rc_context on the rc
// (:113-116), palindromes forward.  Windows at or past
// n_kmers = (glen > k ? glen-k+1 : 0) become all-ones sentinels, ctx 0.
//
// Output: W+1 planes of n_reads*P u32 (plane stride `stride`), row
// r*P + p: W canonical word planes, then the context plane.
//
// Bound on this card: the output write, 4*(W+1) bytes a window (20 B at
// W=4, 250 MB for a 65,536-read chunk at L=250, k=60) against 64 B of
// packed input a read.  Design:
//  - A block takes an aligned range of RB = KMERIZE_THREADS*V output rows
//    (fewer where the reads it spans would not fit SMEM_BYTES) and
//    stages the packed rows of the reads that range spans, with one
//    coalesced load, and beside each the row's reverse complement
//    (revpair32 of the complemented words in reverse order): the rc of
//    window p is then the same funnel shift of the rc row at base
//    16*wr - p - k, so no thread reverses a window.  Each staged row ends
//    in a zero word, so no shift reads past it.  Index arithmetic inside
//    the block is 32-bit; one division a thread finds its first read.
//  - A thread makes V = 4 consecutive rows.  It first decides each row's
//    strand, comparing the fwd and rc words from word 0 until they
//    differ (almost always at word 0), then walks the planes: for each
//    word j it funnel-shifts the chosen strand's next staged word (one
//    shared load and one shift a word a row) and writes the V rows of
//    plane j with one 16-byte streaming store.  Registers do not grow
//    with W (no array of W words is held), so every W from 1 to 40 runs
//    without a spill.
//  - A warp writes 512 contiguous bytes of each plane at a time, and the
//    ranges are aligned, so every 32-byte sector is written whole by one
//    store (a block a tile of reads would leave them 16 bytes off the
//    sectors whenever the tile's rows are not a multiple of 8).  The
//    stores are streaming (evict-first).  scripts/kmerize_ab.py times
//    both choices against the kernel: its offset16 and plain_stores
//    variants.  Where the planes are not 16-byte aligned (stride % 4 != 0)
//    or the last range ends inside a thread's V rows, the thread stores
//    word by word.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int KMERIZE_THREADS = 256;  // most threads a block
constexpr int V = 4;                  // consecutive rows a thread
constexpr int SMEM_BYTES = 48 * 1024;  // a block's staged rows, at most

__device__ __forceinline__ uint32_t revpair32(uint32_t w) {
  w = ((w & 0x33333333u) << 2) | ((w >> 2) & 0x33333333u);
  w = ((w & 0x0F0F0F0Fu) << 4) | ((w >> 4) & 0x0F0F0F0Fu);
  w = ((w & 0x00FF00FFu) << 8) | ((w >> 8) & 0x00FF00FFu);
  return (w << 16) | (w >> 16);
}

__device__ __forceinline__ uint32_t window_word(const uint32_t* s, int off, int j, int sh) {
  return __funnelshift_l(s[off + j + 1], s[off + j], sh);
}

__device__ __forceinline__ uint32_t base_at(const uint32_t* s, int rb, int x) {
  return (s[rb + (x >> 4)] >> (30 - 2 * (x & 15))) & 3u;
}

// A streaming store (evict-first): the planes are written once, and the
// next kernel reads them from device memory.
template <class T>
__device__ __forceinline__ void put(T* p, T v) {
  __stcs(p, v);
}

// Word j of the V rows' chosen strands, masked, all ones where invalid;
// cur holds each row's word j on entry and word j+1 on exit.
__device__ __forceinline__ void plane_words(uint32_t (&w)[V], uint32_t (&cur)[V],
                                            const uint32_t* s, const int (&off)[V],
                                            const int (&sh)[V], int j, uint32_t mask,
                                            uint32_t valid) {
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const uint32_t nxt = s[off[v] + j + 1];
    w[v] = (valid >> v) & 1u ? __funnelshift_l(nxt, cur[v], sh[v]) & mask : FULL;
    cur[v] = nxt;
  }
}

// The chosen strands' W words of V rows, plane by plane, then their ctx,
// each plane's V rows in one 16-byte store.
template <int W>
__device__ __forceinline__ void write_planes(uint32_t* dst, int64_t stride,
                                             const uint32_t* s, const int (&off)[V],
                                             const int (&sh)[V], uint32_t valid,
                                             uint32_t last_mask, const uint32_t (&ctx)[V]) {
  uint32_t cur[V], w[V];
#pragma unroll
  for (int v = 0; v < V; ++v) cur[v] = s[off[v]];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    plane_words(w, cur, s, off, sh, j, j == W - 1 ? last_mask : FULL, valid);
    put(reinterpret_cast<uint4*>(dst + j * stride), make_uint4(w[0], w[1], w[2], w[3]));
  }
  put(reinterpret_cast<uint4*>(dst + W * stride), make_uint4(ctx[0], ctx[1], ctx[2], ctx[3]));
}

// The same word by word, for the first `left` rows: where the planes are
// not 16-byte aligned, or the rows end inside a thread's V.  A loop, not
// unrolled: each instance unrolls its W planes once, in write_planes.
__device__ __forceinline__ void write_rows(uint32_t* dst, int64_t stride, int W,
                                           const uint32_t* s, const int (&off)[V],
                                           const int (&sh)[V], uint32_t valid,
                                           uint32_t last_mask, const uint32_t (&ctx)[V],
                                           int left) {
  uint32_t cur[V], w[V];
#pragma unroll
  for (int v = 0; v < V; ++v) cur[v] = s[off[v]];
#pragma unroll 1
  for (int j = 0; j <= W; ++j) {
    if (j < W)
      plane_words(w, cur, s, off, sh, j, j == W - 1 ? last_mask : FULL, valid);
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (v < left) put(dst + j * stride + v, j < W ? w[v] : ctx[v]);
  }
}

template <int W>
__global__ void __launch_bounds__(KMERIZE_THREADS)
kmerize_kernel(const uint32_t* __restrict__ packed, int n_reads, int wr,
               const int32_t* __restrict__ glen, int k, int P, int RB, int R,
               uint32_t* __restrict__ out, int64_t stride, bool vec) {
  extern __shared__ uint32_t smem[];
  const int S = wr + 1;          // a staged row: wr words, then a zero word
  uint32_t* sf = smem;           // R forward rows
  uint32_t* sr = smem + R * S;   // R reverse-complement rows
  int* sg = reinterpret_cast<int*>(smem + 2 * R * S);  // R usable lengths

  // this block's rows [g0, g0 + rows) span reads r0 .. r0 + nr - 1 (nr <= R)
  const int64_t g0 = (int64_t)blockIdx.x * RB;
  const int64_t left_rows = (int64_t)n_reads * P - g0;
  const int rows = left_rows < RB ? (int)left_rows : RB;
  const int r0 = (int)(g0 / P);
  const int p0 = (int)(g0 - (int64_t)r0 * P);
  const int nr = (p0 + rows - 1) / P + 1;
  const uint32_t* src = packed + (int64_t)r0 * wr;
  for (int i = threadIdx.x; i < nr * wr; i += blockDim.x) {
    const int r = i / wr, j = i - r * wr;
    const uint32_t w = src[i];
    sf[r * S + j] = w;
    sr[r * S + wr - 1 - j] = revpair32(~w);
  }
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    sf[r * S + wr] = 0u;
    sr[r * S + wr] = 0u;
    sg[r] = r < nr ? glen[r0 + r] : 0;  // reads past the last: no window
  }
  __syncthreads();

  const int pad = 2 * (16 * W - k);
  const uint32_t last_mask = (FULL >> pad) << pad;
  const int rc0 = 16 * wr - k;  // rc row base of window 0
  uint32_t* const block_out = out + g0;

  for (int i = threadIdx.x * V; i < rows; i += blockDim.x * V) {
    int r = (p0 + i) / P, p = p0 + i - r * P;
    int off[V], sh[V], offr[V], shr[V];
    uint32_t ctx[V];
    uint32_t rev = 0u, valid = 0u;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      // row g0+i+v: read r0+r, window p (r < R, since i+v < RB and
      // (p0 + RB - 1) / P + 1 <= R; reads past the last have glen 0)
      const int g = sg[r];
      const int rb = r * S;
      const int qr = rc0 - p;
      off[v] = rb + (p >> 4);
      sh[v] = 2 * (p & 15);
      offr[v] = R * S + rb + (qr >> 4);
      shr[v] = 2 * (qr & 15);
      const bool ok = p < (g > k ? g - k + 1 : 0);
      // context: pred base at p-1 (p > 0), succ base at p+k (< glen);
      // the rc strand's are the complements of succ and pred
      const bool hp = ok && p > 0, hs = ok && p + k < g;
      const uint32_t pb = hp ? base_at(sf, rb, p - 1) : 0u;
      const uint32_t sb = hs ? base_at(sf, rb, p + k) : 0u;
      ctx[v] = (hp ? (1u << pb) << 4 : 0u) | (hs ? 1u << sb : 0u);
      // the rc form's ctx goes in the top half until the strand is known
      ctx[v] |= ((hs ? (1u << (3u - sb)) << 4 : 0u) | (hp ? 1u << (3u - pb) : 0u)) << 16;
      valid |= (uint32_t)ok << v;
      if (++p == P) {
        p = 0;
        ++r;
      }
    }
    // strand: is_rev iff rc < fwd lexicographically, word 0 first
    uint32_t undecided = valid;
    for (int j = 0; j < W && undecided; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (!((undecided >> v) & 1u)) continue;
        uint32_t f = window_word(smem, off[v], j, sh[v]);
        uint32_t c = window_word(smem, offr[v], j, shr[v]);
        if (j == W - 1) {
          f &= last_mask;
          c &= last_mask;
        }
        if (f != c) {
          undecided &= ~(1u << v);
          rev |= (uint32_t)(c < f) << v;
        }
      }
    }
    // the chosen strand
#pragma unroll
    for (int v = 0; v < V; ++v) {
      if ((rev >> v) & 1u) {
        off[v] = offr[v];
        sh[v] = shr[v];
      }
      ctx[v] = (valid >> v) & 1u ? ((rev >> v) & 1u ? ctx[v] >> 16 : ctx[v] & 0xFFu) : 0u;
    }
    const int left = rows - i;
    if (vec && left >= V)
      write_planes<W>(block_out + i, stride, smem, off, sh, valid, last_mask, ctx);
    else
      write_rows(block_out + i, stride, W, smem, off, sh, valid, last_mask, ctx, left);
  }
}

// Reads a range of RB rows can span.
int span_reads(int RB, int P) { return (RB - 1) / P + 2; }

// Rows a block: KMERIZE_THREADS*V, halved while the reads they span do
// not fit SMEM_BYTES (down to a warp's 32*V); 0 if even that does not.
int block_rows(int P, int wr) {
  const int row_bytes = 4 * (2 * (wr + 1) + 1);
  for (int RB = KMERIZE_THREADS * V; RB >= 32 * V; RB /= 2)
    if ((int64_t)span_reads(RB, P) * row_bytes <= SMEM_BYTES) return RB;
  return 0;
}

template <int W>
cudaError_t launch_kmerize(const uint32_t* packed, int64_t n_reads, int64_t wr,
                           const int32_t* glen, int k, int P, uint32_t* out,
                           int64_t stride, cudaStream_t stream) {
  const int RB = block_rows(P, (int)wr);
  const int64_t total = n_reads * (int64_t)P;
  const int64_t blocks = RB ? (total + RB - 1) / RB : 0;
  if (RB == 0 || n_reads > 0x7FFFFFFF || blocks > 0x7FFFFFFF) return cudaErrorInvalidValue;
  const int R = span_reads(RB, P);
  const size_t smem = (size_t)R * (2 * (wr + 1) + 1) * 4;
  const bool vec = stride % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  kmerize_kernel<W><<<(unsigned)blocks, RB / V, smem, stream>>>(
      packed, (int)n_reads, (int)wr, glen, k, P, RB, R, out, stride, vec);
  return cudaGetLastError();
}

template <int W>
cudaError_t attrs_of(int* buf) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, kmerize_kernel<W>);
  if (err != cudaSuccess) return err;
  buf[0] = a.numRegs;
  buf[1] = (int)a.localSizeBytes;
  buf[2] = (int)a.sharedSizeBytes;
  buf[3] = a.maxThreadsPerBlock;
  return cudaSuccess;
}

}  // namespace

#define W2RAP_EACH_W(X)                                                       \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) \
  X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24) X(25) X(26)   \
  X(27) X(28) X(29) X(30) X(31) X(32) X(33) X(34) X(35) X(36) X(37) X(38)   \
  X(39) X(40)

// packed: (n_reads, wr) u32 rows; glen: (n_reads,) i32; out: (W+1, stride)
// u32 with stride >= n_reads*P; W = ceil(k/16) in 1..40.  Returns
// cudaGetLastError() after launch.
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
    W2RAP_EACH_W(W2RAP_CASE)
#undef W2RAP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// buf[4] <- registers a thread, local (spilled) bytes a thread, static
// shared bytes, most threads a block of kmerize_kernel<W>.
extern "C" int w2rap_kmerize_attrs(int W, int* buf) {
  switch (W) {
#define W2RAP_CASE(W) \
  case W:             \
    return (int)attrs_of<W>(buf);
    W2RAP_EACH_W(W2RAP_CASE)
#undef W2RAP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
