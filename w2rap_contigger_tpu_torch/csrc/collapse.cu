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
// number of dropped (count < min_count) segments at each count.
//
// The TPU kernel carries the previous tile's last row and scanned
// payload in SMEM because its grid runs in order (pallas_collapse.py:
// 89, 98-102, 148-151).  CUDA blocks run in no order, so nothing is
// carried: each segment is represented by its LAST row (found by
// comparing a row with the next one), and the thread holding that row
// reduces backward over the read-only input to the segment start.  A
// segment that crosses a tile boundary, or spans many tiles (a repeat
// kmer), is therefore reduced by exactly one thread, wherever it lies.
// The count saturates at 255 and the context ORs (pallas_collapse.py:
// 41-49); once both are saturated (255, 0xFF) the walk stops early.
//
// Bound on this card: device memory, (W+1)*4 bytes read about twice
// (the next-row compare and the backward walk hit L1/L2) and written
// once per row.  The walk makes the work of a segment serial in its
// length; total walk work is still one visit per row.  Compaction within
// a tile is a warp ballot + block scan per 256-row step, so the output
// order is the input order and every store of a step is contiguous.
// W is a runtime value (any W >= 1; K=60..640 gives 4..40).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr int COLLAPSE_THREADS = 256;
constexpr int LOW_BINS = 128;

__device__ __forceinline__ bool rows_equal(const uint32_t* __restrict__ in,
                                           int64_t n, int W, int64_t a,
                                           int64_t b) {
  for (int j = 0; j < W; ++j)
    if (in[j * n + a] != in[j * n + b]) return false;
  return true;
}

__global__ void __launch_bounds__(COLLAPSE_THREADS)
collapse_kernel(const uint32_t* __restrict__ in, int64_t n, int W,
                int min_count, int tile, uint32_t* __restrict__ out,
                int32_t* __restrict__ tile_counts,
                int32_t* __restrict__ low_bins) {
  __shared__ int warp_total[COLLAPSE_THREADS / 32];
  __shared__ int s_low[LOW_BINS];
  __shared__ int s_kept;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t tile0 = (int64_t)blockIdx.x * tile;
  const int64_t tile_end = tile0 + tile < n ? tile0 + tile : n;
  const uint32_t* pay_in = in + W * n;

  if (tid < LOW_BINS) s_low[tid] = 0;
  if (tid == 0) s_kept = 0;
  __syncthreads();

  for (int64_t base = tile0; base < tile_end; base += COLLAPSE_THREADS) {
    const int64_t i = base + tid;
    bool keep = false;
    uint32_t pay = 0u;
    if (i < tile_end && (i == n - 1 || !rows_equal(in, n, W, i, i + 1))) {
      bool sentinel = true;
      for (int j = 0; j < W; ++j) sentinel &= in[j * n + i] == FULL;
      if (!sentinel) {
        // reduce backward from the segment's last row to its first
        uint32_t cnt = pay_in[i] & 0xFFu;
        uint32_t ctx = (pay_in[i] >> 8) & 0xFFu;
        int64_t s = i;
        while (s > 0 && !(cnt == 255u && ctx == 0xFFu) &&
               rows_equal(in, n, W, s - 1, i)) {
          --s;
          const uint32_t p = pay_in[s];
          cnt = min(cnt + (p & 0xFFu), 255u);
          ctx |= (p >> 8) & 0xFFu;
        }
        pay = (ctx << 8) | cnt;
        keep = min_count <= 1 || cnt >= (uint32_t)min_count;
        if (!keep && cnt >= 1u) atomicAdd(&s_low[cnt], 1);
      }
    }

    // ordered compaction of this step's kept rows to the tile front
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, keep);
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, step_total = 0;
#pragma unroll
    for (int w = 0; w < COLLAPSE_THREADS / 32; ++w) {
      const int c = warp_total[w];
      before += w < warp ? c : 0;
      step_total += c;
    }
    if (keep) {
      const int64_t dst =
          tile0 + s_kept + before + __popc(ballot & ((1u << lane) - 1u));
      for (int j = 0; j < W; ++j) out[j * n + dst] = in[j * n + i];
      out[W * n + dst] = pay;
    }
    __syncthreads();
    if (tid == 0) s_kept += step_total;
    __syncthreads();
  }

  const int kept = s_kept;
  for (int64_t e = tile0 + kept + tid; e < tile_end; e += COLLAPSE_THREADS) {
    for (int j = 0; j < W; ++j) out[j * n + e] = FULL;
    out[W * n + e] = 0u;
  }
  if (tid == 0) tile_counts[blockIdx.x] = kept;
  if (tid < LOW_BINS && s_low[tid] != 0) atomicAdd(&low_bins[tid], s_low[tid]);
}

}  // namespace

// in/out: (W+1, n) u32 planes; tile_counts: (ceil(n/tile),) i32;
// low_bins: (128,) i32, zeroed by the caller.  min_count <= 128 and
// tile % 256 == 0 (checked by the caller).  Returns cudaGetLastError().
extern "C" int w2rap_collapse(const void* in, int64_t n, int W, int min_count,
                              int tile, void* out, void* tile_counts,
                              void* low_bins, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int64_t n_tiles = (n + tile - 1) / tile;
  collapse_kernel<<<(unsigned)n_tiles, COLLAPSE_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), n, W, min_count, tile,
      static_cast<uint32_t*>(out), static_cast<int32_t*>(tile_counts),
      static_cast<int32_t*>(low_bins));
  return (int)cudaGetLastError();
}
