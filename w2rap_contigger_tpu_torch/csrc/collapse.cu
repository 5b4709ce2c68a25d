// K2: collapse a sorted kmer stream into per-tile compacted rows (Hopper).
//
// Replaces the TPU kernel w2rap_contigger_tpu/ops/pallas_collapse.py:
// _collapse_kernel (:83), launched by _collapse_planes (:205) under
// collapse_compact (:230).
//
// Input: W word planes + one payload plane ((ctx << 8) | cnt), n rows
// each, sorted so equal kmers are adjacent; all-ones rows (across all W
// words) are sentinels.  Output, per tile of `tile` rows (one block per
// tile): the tile's kept rows compacted to its front, in order, the
// rest of the tile filled with sentinels (payload 0); the tile's kept
// count; and, added atomically into low_bins[1..min_count-1], the
// number of dropped (count < min_count) segments at each count.  A
// segment belongs to the tile of its last row.
//
// Bound on this card: device memory, the W+1 planes read once and the
// W+1 output planes (kept rows and fill) written once.
//
// Design: the tile's segmented scan in registers, as the TPU kernel scans
// its tile in VMEM (pallas_collapse.py:104-131).
//   * Thread t owns V = 16 consecutive rows.  For each plane in turn it
//     loads its V words as 16-byte vectors and folds them into two V-bit
//     masks: "differs from the previous row" and "all ones so far"; the
//     previous row of its first row comes by a shuffle (one load at a
//     warp's first lane).  Registers do not grow with W (W up to 40).
//   * The payload (cnt saturating at 255, ctx OR-ed; an associative and
//     commutative operator, so any order gives the sequential answer)
//     is scanned by segments: sequentially over a thread's rows, across
//     the warp by shuffles that carry the head flag, across the block
//     through shared memory.
//   * CUDA blocks run in no order, so nothing is carried between tiles
//     (the TPU grid carries its last row in SMEM).  The tile's first
//     segment, when it began in an earlier tile and ends in this one,
//     is completed by the whole block walking backward from the tile's
//     first row, 4096 rows a step, until the segment's start, row 0, or
//     saturation (255, 0xFF).  A tile in which it does not end walks not.
//   * Ordered compaction: a block scan of each thread's kept rows puts
//     their tile offsets and payloads in shared memory; then, plane by
//     plane, the block writes the tile's whole output range as 16-byte
//     vectors, kept words read again (from L2, where the tile was just
//     read) and fill after them.  Low-bin counts go to shared memory and
//     are added once per block.
// Any W >= 1; tile a multiple of 256 up to 4096 (one pass of the block).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int COLLAPSE_THREADS = 256;
// rows a thread: V = 8 at 512 threads was 3-7% slower at W = 13 and 17,
// and 2% faster at W = 4, on an H100 80GB HBM3 at 700 W
// (scripts/sort_kernel_ab.py; PERF.md)
constexpr int V = 16;
constexpr int MAX_TILE = COLLAPSE_THREADS * V;
constexpr int WARPS = COLLAPSE_THREADS / 32;
constexpr int LOW_BINS = 128;
constexpr uint32_t SATURATED = 0xFFFFu;  // ctx 0xFF, cnt 255

// (ctx << 8) | cnt of two payloads: ctx OR-ed, cnt added, saturating
__device__ __forceinline__ uint32_t comb(uint32_t a, uint32_t b) {
  return ((a | b) & 0xFF00u) | min((a & 0xFFu) + (b & 0xFFu), 255u);
}

// segmented scan element: f = a segment starts in it, v = the payload
// after its last start (all of it when f is 0)
__device__ __forceinline__ void seg_comb(uint32_t& f, uint32_t& v,
                                         uint32_t pf, uint32_t pv) {
  // (pf, pv) precedes (f, v)
  if (!f) v = comb(pv, v);
  f |= pf;
}

// a thread's V words of one plane: 16-byte vectors when aligned and
// whole, else scalar loads of the rows below `end`
__device__ __forceinline__ void load_rows(const uint32_t* __restrict__ p,
                                          int64_t row0, int64_t end, bool vec,
                                          uint32_t (&w)[V]) {
  if (vec && row0 + V <= end) {
#pragma unroll
    for (int q = 0; q < V / 4; ++q) {
      const uint4 x = reinterpret_cast<const uint4*>(p + row0)[q];
      w[4 * q] = x.x;
      w[4 * q + 1] = x.y;
      w[4 * q + 2] = x.z;
      w[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) w[v] = row0 + v < end ? p[row0 + v] : 0u;
  }
}

__global__ void __launch_bounds__(COLLAPSE_THREADS)
collapse_kernel(const uint32_t* __restrict__ in, int64_t n, int W,
                int min_count, int tile, bool vec, uint32_t* __restrict__ out,
                int32_t* __restrict__ tile_counts,
                int32_t* __restrict__ low_bins) {
  __shared__ uint16_t s_row[MAX_TILE];  // kept rows' tile offsets, in order
  __shared__ uint16_t s_pay[MAX_TILE];  // and their payloads
  __shared__ uint32_t s_head[COLLAPSE_THREADS];  // start bit of a thread's first row
  __shared__ uint32_t s_wf[WARPS], s_wv[WARPS];
  __shared__ int s_wk[WARPS];
  __shared__ int s_low[LOW_BINS];
  __shared__ int s_first;  // tile offset of the first segment's end row, or -1
  __shared__ uint32_t s_first_val, s_walk_cnt, s_walk_ctx;
  __shared__ int s_stop;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile0 = (int64_t)blockIdx.x * tile;
  const int64_t tile_end = tile0 + tile < n ? tile0 + tile : n;
  const int64_t row0 = tile0 + (int64_t)tid * V;
  const int64_t left = tile_end - row0;
  const int nv = left <= 0 ? 0 : (left < V ? (int)left : V);
  const uint32_t valid = (1u << nv) - 1u;
  // the thread holding the tile's last row also compares the next tile's
  // first row with it
  const bool tail = nv > 0 && row0 + nv == tile_end && tile_end < n;

  if (tid < LOW_BINS) s_low[tid] = 0;
  if (tid == 0) s_first = -1;

  // masks: bit v of diff = row v differs from the row before it in some
  // plane; of ones = row v is all ones in every plane so far
  uint32_t diff = 0u, ones = valid, next_diff = 0u;
  uint32_t w[V];
  for (int j = 0; j < W; ++j) {
    const uint32_t* p = in + j * n;
    load_rows(p, row0, tile_end, vec, w);
    uint32_t prev = __shfl_up_sync(FULL, w[V - 1], 1);
    if (lane == 0 && row0 > 0 && nv > 0) prev = p[row0 - 1];
    uint32_t d = w[0] != prev ? 1u : 0u, o = w[0] == FULL ? 1u : 0u;
#pragma unroll
    for (int v = 1; v < V; ++v) {
      d |= (w[v] != w[v - 1] ? 1u : 0u) << v;
      o |= (w[v] == FULL ? 1u : 0u) << v;
    }
    diff |= d;
    ones &= o;
    if (tail) next_diff |= p[tile_end] != w[V - 1];  // a tail's nv is V
  }
  if (row0 == 0) diff |= 1u;  // the stream's first row starts a segment
  const uint32_t start = diff & valid;

  uint32_t pay[V];
  load_rows(in + W * n, row0, tile_end, vec, pay);
  s_head[tid] = start & 1u;
  __syncthreads();

  // end bit v: row v + 1 starts a segment, or row v is the stream's last
  uint32_t end = start >> 1;
  if (nv > 0) {
    const uint32_t last =
        row0 + nv == n ? 1u
                       : (tail ? next_diff
                               : (tid + 1 < COLLAPSE_THREADS ? s_head[tid + 1] : 0u));
    end = (end | (last << (nv - 1))) & valid;
  }

  // the thread's own scan, then the warp's and the block's
  uint32_t f = 0u, val = 0u;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    pay[v] &= 0xFFFFu;  // payload bits above 15 are not carried
    if ((valid >> v) & 1u) {
      if ((start >> v) & 1u) f = 1u, val = pay[v];
      else val = comb(val, pay[v]);
    }
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t pf = __shfl_up_sync(FULL, f, off);
    const uint32_t pv = __shfl_up_sync(FULL, val, off);
    if (lane >= off) seg_comb(f, val, pf, pv);
  }
  uint32_t cf = __shfl_up_sync(FULL, f, 1), cv = __shfl_up_sync(FULL, val, 1);
  if (lane == 0) cf = 0u, cv = 0u;
  if (lane == 31) s_wf[warp] = f, s_wv[warp] = val;
  __syncthreads();
  uint32_t bf = 0u, bv = 0u;  // the warps before this one
  for (int q = 0; q < warp; ++q) {
    uint32_t qf = s_wf[q], qv = s_wv[q];
    seg_comb(qf, qv, bf, bv);
    bf = qf, bv = qv;
  }
  seg_comb(cf, cv, bf, bv);

  // every row's scanned payload; rows that no start in this tile
  // precedes are the first segment's (the one that began before it)
  f = cf;
  val = cv;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if ((valid >> v) & 1u) {
      if ((start >> v) & 1u) f = 1u, val = pay[v];
      else val = comb(val, pay[v]);
      pay[v] = val;
      if (!f && ((end >> v) & 1u) && !((ones >> v) & 1u)) {
        s_first = tid * V + v;
        s_first_val = val;
      }
    }
  }
  __syncthreads();

  // the first segment ends here and began in an earlier tile: the block
  // walks back from tile0 - 1, V rows a thread a step, comparing each row
  // with row tile0 (the segment's key)
  uint32_t walk = 0u;
  if (s_first >= 0) {
    const uint32_t first_val = s_first_val;
    int64_t hi = tile0;
    for (;;) {
      const int64_t lo = hi - MAX_TILE > 0 ? hi - MAX_TILE : 0;
      if (tid == 0) s_stop = MAX_TILE, s_walk_cnt = 0u, s_walk_ctx = 0u;
      __syncthreads();
      // rows hi - 1 - (tid * V + v), descending with v
      uint32_t eq = 0u;
#pragma unroll
      for (int v = 0; v < V; ++v)
        eq |= (hi - 1 - (tid * V + v) >= lo ? 1u : 0u) << v;
      const uint32_t live = eq;
      for (int j = 0; j < W && eq; ++j) {
        const uint32_t* p = in + j * n;
        const uint32_t key = p[tile0];
#pragma unroll
        for (int v = 0; v < V; ++v)
          if ((eq >> v) & 1u && p[hi - 1 - (tid * V + v)] != key)
            eq &= ~(1u << v);
      }
      const uint32_t ne = live & ~eq;
      if (ne) atomicMin(&s_stop, tid * V + __ffs(ne) - 1);
      __syncthreads();
      const int stop = s_stop;
      uint32_t part = 0u;
#pragma unroll
      for (int v = 0; v < V; ++v)
        if ((eq >> v) & 1u && tid * V + v < stop)
          part = comb(part, in[W * n + hi - 1 - (tid * V + v)] & 0xFFFFu);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part = comb(part, __shfl_xor_sync(FULL, part, off));
      if (lane == 0 && part) {
        atomicAdd(&s_walk_cnt, part & 0xFFu);
        atomicOr(&s_walk_ctx, part & 0xFF00u);
      }
      __syncthreads();
      walk = comb(walk, s_walk_ctx | min(s_walk_cnt, 255u));
      __syncthreads();  // s_stop and the sums are read before the next step
      if (stop < MAX_TILE || lo == 0 || comb(walk, first_val) == SATURATED) break;
      hi = lo;
    }
  }

  // keep flags, low bins, and the ordered compaction
  uint32_t keep = 0u;
  const int first = s_first;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if (tid * V + v == first) pay[v] = comb(walk, pay[v]);
    const bool live = ((end & ~ones) >> v) & 1u;
    const uint32_t cnt = pay[v] & 0xFFu;
    const bool k = live && (min_count <= 1 || cnt >= (uint32_t)min_count);
    if (live && !k && cnt >= 1u) atomicAdd(&s_low[cnt], 1);
    keep |= (k ? 1u : 0u) << v;
  }
  int c = __popc(keep), incl = c;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int x = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += x;
  }
  if (lane == 31) s_wk[warp] = incl;
  __syncthreads();
  int pos = incl - c, kept = 0;
#pragma unroll
  for (int q = 0; q < WARPS; ++q) {
    pos += q < warp ? s_wk[q] : 0;
    kept += s_wk[q];
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    if ((keep >> v) & 1u) {
      s_row[pos] = (uint16_t)(tid * V + v);
      s_pay[pos] = (uint16_t)pay[v];
      ++pos;
    }
  }
  __syncthreads();

  // the tile's output range, plane by plane: kept rows, then fill
  const int len = (int)(tile_end - tile0);
  const int nvec = vec ? len / 4 : 0;
  for (int j = 0; j <= W; ++j) {
    const uint32_t* p = in + j * n + tile0;
    uint32_t* o = out + j * n + tile0;
    auto word = [&](int q) -> uint32_t {
      if (q >= kept) return j < W ? FULL : 0u;
      return j < W ? p[s_row[q]] : (uint32_t)s_pay[q];
    };
    for (int q4 = tid; q4 < nvec; q4 += COLLAPSE_THREADS) {
      const int q = 4 * q4;
      reinterpret_cast<uint4*>(o)[q4] =
          make_uint4(word(q), word(q + 1), word(q + 2), word(q + 3));
    }
    for (int q = 4 * nvec + tid; q < len; q += COLLAPSE_THREADS) o[q] = word(q);
  }
  if (tid == 0) tile_counts[blockIdx.x] = kept;
  if (tid < LOW_BINS && s_low[tid] != 0) atomicAdd(&low_bins[tid], s_low[tid]);
}

}  // namespace

// in/out: (W+1, n) u32 planes; tile_counts: (ceil(n/tile),) i32;
// low_bins: (128,) i32, zeroed by the caller.  min_count <= 128; tile a
// multiple of 256 up to 4096.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a tile the kernel does not take.
extern "C" int w2rap_collapse(const void* in, int64_t n, int W, int min_count,
                              int tile, void* out, void* tile_counts,
                              void* low_bins, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (tile <= 0 || tile % 256 || tile > MAX_TILE || W < 1)
    return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t n_tiles = (n + tile - 1) / tile;
  collapse_kernel<<<(unsigned)n_tiles, COLLAPSE_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), n, W, min_count, tile, vec,
      static_cast<uint32_t*>(out), static_cast<int32_t*>(tile_counts),
      static_cast<int32_t*>(low_bins));
  return (int)cudaGetLastError();
}

// attrs[0..3] = registers a thread, local (spilled) bytes a thread, static
// shared bytes, most threads a block, of K2's kernel.
extern "C" int w2rap_collapse_attrs(int* attrs) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, (const void*)collapse_kernel);
  if (err != cudaSuccess) return (int)err;
  attrs[0] = a.numRegs;
  attrs[1] = (int)a.localSizeBytes;
  attrs[2] = (int)a.sharedSizeBytes;
  attrs[3] = a.maxThreadsPerBlock;
  return (int)cudaSuccess;
}
