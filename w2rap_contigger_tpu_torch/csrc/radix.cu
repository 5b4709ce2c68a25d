// K4a, K4b, K4d: partition (sample) sort of a kmer stream (Hopper, sm_90a).
//
// Replaces the TPU kernels of w2rap_contigger_tpu/ops/pallas_radix.py,
// launched by _partition_sort_planes (:330-457):
//
//   K4a _tile_sort_ascending_kernel (:152, launched :350)
//       -> tile_sort_kernel: one block sorts one tile of T rows with the
//          key-index network of keyindex_net.cuh;
//   K4b _partition_kernel (:221, launched :386)
//       -> partition_kernel: one block cuts one sorted tile into its
//          per-bin slots;
//   K4c _tile_sort_dyn_kernel (:108, launched :422)
//       -> region_merge.cu: one block merges the sorted runs of one chunk
//          of a bin region;
//   K4d _descend_kernel (:162, launched :443) with the XLA
//       _cross_stage_region (:188)
//       -> merge_pass_kernel: one merge-path level over every region.
//
// The TPU kernels move all 4-18 u32 planes through every compare-exchange
// of a bitonic network in VMEM tiles.  Here the planes are read once to
// build a record per row and gathered once at the end: a record is
// (hi, lo, idx) (records.cuh) over the first cmp_keys (<= 4) key words and
// the row's index.  Since idx is unique, every sort below is a stable sort
// on the key words, and the output is a pure function of the input
// (sentinel fill records, (~0, ~0, ~0), are identical, so their order
// does not matter).
//
// Phases (ops/radix.py composes them and builds the splitters in torch):
//   1. tile_sort_kernel: tile t (rows [t*T, (t+1)*T)) -> records sorted:
//      the tile's cmp_keys planes in shared memory (128 KB at T = 8192
//      and cmp_keys 4, + 32 KB of index buffers), (tile row, word 0)
//      pairs through the network, each record written once.
//   2. partition_kernel: s_b = #records < splitter_b by binary search in
//      the sorted tile, s_0 = 0, s_B = #non-sentinel rows (a sentinel row
//      is all ones in all num_keys words; such rows sort to the tile's
//      tail, and only the tail's words past cmp_keys are read from the
//      planes, none when cmp_keys == num_keys); rows [s_b, s_{b+1}) (at most
//      cap) go to slot (bin b, tile t) of cap records, the rest of the slot
//      is fill.  overflow += slots holding more than cap - 128 rows, plus
//      real rows whose cmp_keys words are all ones (pallas_radix.py:
//      252-275, 306-311): the flag is the TPU kernel's exactly.  Every slot
//      is therefore a sorted run: a tile's sorted rows, then fill.
//   3. region_merge.cu: every chunk of C records of a region (C / cap
//      slots) merged into one sorted run.
//   4. merge_pass_kernel, width C, 2C, ... below the region: each record
//      of a left run moves to (its index) + #records of the right run that
//      are smaller; each record of a right run to (its index) + #records
//      of the left run that are not larger (binary search, merge path).
//   The last phase that runs gathers the num_ops planes through idx
//   (fill records become all-ones key words and 0 payload words).
//
// Bound on this card: device memory.  The planes are read once by phase 1
// (the comparator words) and once by the gather (the rows taken); records
// (20 B) cross device memory once per phase and once per merge level;
// the output (num_ops u32 per slot, 2x the rows at CAP_FACTOR 2) is
// written once.  The design trades the TPU's
// O(log^2) plane movement for O(log) record movement; merge levels are
// the term that grows with the region size.

#include <cstdint>
#include <cuda_runtime.h>

#include "keyindex_net.cuh"
#include "records.cuh"

namespace {

constexpr int PART_THREADS = 256;
constexpr int MERGE_THREADS = 256;

// K4a: tile blockIdx.x of T rows -> its records, ascending: the direction
// from the tile row, ties broken by the later words and then by the tile
// row (the record order, idx = base + tile row).
template <int R>
__global__ void __launch_bounds__(NET_THREADS)
tile_sort_kernel(const uint32_t* __restrict__ planes, int64_t n, int cmp_keys,
                 int T, uint64_t* __restrict__ out_hi,
                 uint64_t* __restrict__ out_lo,
                 uint32_t* __restrict__ out_idx) {
  extern __shared__ __align__(16) uint32_t k4a_smem[];
  uint32_t* tile = k4a_smem;  // plane j of the tile at tile[j * T], swizzled
  uint16_t* xbuf = reinterpret_cast<uint16_t*>(k4a_smem + (int64_t)cmp_keys * T);
  const int64_t base = (int64_t)blockIdx.x * T;
  const int p = threadIdx.x * R;  // tile row of position r = 0
  load_tile<R>(planes, n, base, cmp_keys, T, tile);
  __syncthreads();
  const Net<R, true> net{tile, T, cmp_keys};
  uint32_t key[R], ix[R];
  net_init<R>(net, key, ix);
  net_run<R, false>(net, xbuf, key, ix, p, 0);

  // word j of position r (missing words 0); word 0 is key[r].  A thread's
  // R records are R consecutive positions; a u64 is (low word, high word).
  auto word = [&](int j, int r) -> uint32_t {
    return j < cmp_keys ? net.word(j, ix[r]) : 0u;
  };
  store_words<2 * R>(reinterpret_cast<uint32_t*>(out_hi + base + p),
                     [&](int i) { return i & 1 ? key[i / 2] : word(1, i / 2); });
  store_words<2 * R>(reinterpret_cast<uint32_t*>(out_lo + base + p),
                     [&](int i) { return word(i & 1 ? 2 : 3, i / 2); });
  store_words<R>(out_idx + base + p,
                 [&](int r) { return (uint32_t)base + (ix[r] & ROW); });
}

const void* tile_sort_fn(int R) {
  return R == 2    ? (const void*)tile_sort_kernel<2>
         : R == 4  ? (const void*)tile_sort_kernel<4>
         : R == 8  ? (const void*)tile_sort_kernel<8>
         : R == 16 ? (const void*)tile_sort_kernel<16>
                   : nullptr;
}

// K4b: cut one sorted tile into its n_bins slots of cap records.
__global__ void __launch_bounds__(PART_THREADS)
partition_kernel(const uint32_t* __restrict__ planes, int64_t n, int num_keys,
                 int cmp_keys, int T, int n_bins, int cap,
                 const uint64_t* __restrict__ sp_hi,
                 const uint64_t* __restrict__ sp_lo,
                 const uint64_t* __restrict__ s_hi,
                 const uint64_t* __restrict__ s_lo,
                 const uint32_t* __restrict__ s_idx,
                 uint64_t* __restrict__ r_hi, uint64_t* __restrict__ r_lo,
                 uint32_t* __restrict__ r_idx, int64_t region,
                 int* __restrict__ overflow) {
  extern __shared__ int starts[];  // n_bins + 1
  __shared__ int n_full, n_sent;
  const int tid = threadIdx.x;
  const int64_t t = blockIdx.x;
  const int64_t t0 = t * T;
  if (tid == 0) n_sent = 0;

  // s_{b+1} = #records < splitter_b, on the (hi, lo) key only; b = n_bins
  // - 1 searches the all-ones key instead: the rows all ones in their
  // cmp_keys words (missing words are 0 in every record) sort to the tail
  for (int b = tid; b < n_bins; b += blockDim.x) {
    uint64_t kh, kl;
    if (b < n_bins - 1) {
      kh = sp_hi[b];
      kl = sp_lo[b];
    } else {
      kh = cmp_keys >= 2 ? MAX64 : MAX64 << 32;
      kl = cmp_keys >= 4 ? MAX64 : (cmp_keys == 3 ? MAX64 << 32 : 0ull);
    }
    int lo_i = 0, hi_i = T;
    while (lo_i < hi_i) {
      const int mid = (lo_i + hi_i) >> 1;
      const uint64_t h = s_hi[t0 + mid];
      if (h < kh || (h == kh && s_lo[t0 + mid] < kl))
        lo_i = mid + 1;
      else
        hi_i = mid;
    }
    if (b < n_bins - 1)
      starts[b + 1] = lo_i;
    else
      n_full = T - lo_i;
  }
  __syncthreads();

  // a sentinel row is all ones in all num_keys words: with cmp_keys ==
  // num_keys every tail row is one, else the tail rows' later key words
  // are read (the only plane reads here); the other tail rows are
  // "ambiguous" real rows that tie with the sentinels
  if (cmp_keys < num_keys) {
    int sent_c = 0;
    for (int i = T - n_full + tid; i < T; i += blockDim.x) {
      const int64_t row = s_idx[t0 + i];
      bool sent = true;
      for (int j = cmp_keys; j < num_keys && sent; ++j)
        sent &= planes[j * n + row] == FULL;
      sent_c += sent;
    }
    for (int off = 16; off > 0; off >>= 1)
      sent_c += __shfl_down_sync(0xFFFFFFFFu, sent_c, off);
    if ((tid & 31) == 0 && sent_c) atomicAdd(&n_sent, sent_c);
  } else if (tid == 0) {
    n_sent = n_full;
  }
  __syncthreads();
  if (tid == 0) {
    starts[0] = 0;
    starts[n_bins] = T - n_sent;
    int ov = n_full - n_sent;
    for (int b = 0; b < n_bins; ++b)
      ov += starts[b + 1] - starts[b] > cap - 128 ? 1 : 0;
    if (ov) atomicAdd(overflow, ov);
  }
  __syncthreads();

  for (int b = 0; b < n_bins; ++b) {
    const int s_b = starts[b];
    const int take = max(0, min(starts[b + 1] - s_b, cap));
    const int64_t dst0 = (int64_t)b * region + t * cap;
    for (int j = tid; j < cap; j += blockDim.x) {
      if (j < take) {
        const int64_t src = t0 + s_b + j;
        r_hi[dst0 + j] = s_hi[src];
        r_lo[dst0 + j] = s_lo[src];
        r_idx[dst0 + j] = s_idx[src];
      } else {
        r_hi[dst0 + j] = MAX64;
        r_lo[dst0 + j] = MAX64;
        r_idx[dst0 + j] = FILL_IDX;
      }
    }
  }
}

// K4d: one merge level; runs of `width` records inside each region merge
// pairwise into runs of 2*width (the last run of a region may be short or
// have no partner).
__global__ void __launch_bounds__(MERGE_THREADS)
merge_pass_kernel(const uint64_t* __restrict__ s_hi,
                  const uint64_t* __restrict__ s_lo,
                  const uint32_t* __restrict__ s_idx,
                  uint64_t* __restrict__ d_hi, uint64_t* __restrict__ d_lo,
                  uint32_t* __restrict__ d_idx, int64_t total, int64_t region,
                  int64_t width, int final,
                  const uint32_t* __restrict__ planes, int64_t n, int num_ops,
                  int num_keys, uint32_t* __restrict__ out) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= total) return;
  const int64_t rbase = (p / region) * region;
  const int64_t o = p - rbase;
  const int64_t run = o / width;
  const int64_t pstart = (run ^ 1) * width;
  const int64_t room = region - pstart;
  const int64_t plen = room <= 0 ? 0 : (room < width ? room : width);
  const uint64_t xh = s_hi[p], xl = s_lo[p];
  const uint32_t xi = s_idx[p];
  int64_t dst = p;
  if (plen > 0) {
    const bool left_run = (run & 1) == 0;
    const int64_t base = rbase + pstart;
    int64_t lo_i = 0, hi_i = plen;
    while (lo_i < hi_i) {
      const int64_t mid = (lo_i + hi_i) >> 1;
      const uint64_t yh = s_hi[base + mid], yl = s_lo[base + mid];
      const uint32_t yi = s_idx[base + mid];
      // left run: count partners < x; right run: count partners <= x
      const bool right = left_run ? rec_less(yh, yl, yi, xh, xl, xi)
                                  : !rec_less(xh, xl, xi, yh, yl, yi);
      if (right)
        lo_i = mid + 1;
      else
        hi_i = mid;
    }
    dst = rbase + (run & ~(int64_t)1) * width + (o - run * width) + lo_i;
  }
  if (final) {
    write_row(planes, n, num_ops, num_keys, out, total, dst, xi);
  } else {
    d_hi[dst] = xh;
    d_lo[dst] = xl;
    d_idx[dst] = xi;
  }
}

}  // namespace

// planes: (>= cmp_keys, n) u32, 16-byte aligned; T a power of two
// dividing n, R (2, 4, 8 or 16) rows a thread, threads * R == T,
// bytes = cmp_keys * T * 4 + 4 * T of shared memory (ops/bitonic.py
// tile_geometry).  hi/lo/idx: (n,) records out, 16-byte aligned.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a geometry the
// kernel does not take.
extern "C" int w2rap_radix_tile_sort(const void* planes, int64_t n,
                                     int cmp_keys, int T, int R, int threads,
                                     int bytes, void* hi, void* lo, void* idx,
                                     void* stream) {
  return net_launch(tile_sort_fn(R), n, T, R, threads, bytes,
                    (int64_t)cmp_keys * T * 4 + 4 * (int64_t)T, stream,
                    static_cast<const uint32_t*>(planes), n, cmp_keys, T,
                    static_cast<uint64_t*>(hi), static_cast<uint64_t*>(lo),
                    static_cast<uint32_t*>(idx));
}

// attrs[0..3] = registers a thread, local (spilled) bytes a thread, static
// shared bytes, most threads a block, of K4a's kernel for R (2, 4, 8 or
// 16; cudaErrorInvalidValue for any other).
extern "C" int w2rap_radix_tile_sort_attrs(int R, int* attrs) {
  return net_attrs(tile_sort_fn(R), attrs);
}

// sp_hi/sp_lo: (n_bins-1,) splitter keys; s_*: the sorted tiles' records;
// r_*: (n_bins * region,) slot records out, region = (n/T) * cap;
// overflow: one int, zeroed by the caller.  Returns cudaGetLastError().
extern "C" int w2rap_radix_partition(
    const void* planes, int64_t n, int num_keys, int cmp_keys, int T,
    int n_bins, int cap, const void* sp_hi, const void* sp_lo,
    const void* s_hi, const void* s_lo, const void* s_idx, void* r_hi,
    void* r_lo, void* r_idx, int64_t region, void* overflow, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  partition_kernel<<<(unsigned)(n / T), PART_THREADS,
                     (n_bins + 1) * sizeof(int),
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), n, num_keys, cmp_keys, T, n_bins,
      cap, static_cast<const uint64_t*>(sp_hi),
      static_cast<const uint64_t*>(sp_lo),
      static_cast<const uint64_t*>(s_hi), static_cast<const uint64_t*>(s_lo),
      static_cast<const uint32_t*>(s_idx), static_cast<uint64_t*>(r_hi),
      static_cast<uint64_t*>(r_lo), static_cast<uint32_t*>(r_idx), region,
      static_cast<int*>(overflow));
  return (int)cudaGetLastError();
}

// s_* -> d_* (or, final, the gathered planes into out), one merge level
// of runs of `width` records in every region.  Returns cudaGetLastError().
extern "C" int w2rap_radix_merge_pass(const void* s_hi, const void* s_lo,
                                      const void* s_idx, void* d_hi,
                                      void* d_lo, void* d_idx, int64_t total,
                                      int64_t region, int64_t width, int final,
                                      const void* planes, int64_t n,
                                      int num_ops, int num_keys, void* out,
                                      void* stream) {
  if (total <= 0) return (int)cudaSuccess;
  const int64_t blocks = (total + MERGE_THREADS - 1) / MERGE_THREADS;
  merge_pass_kernel<<<(unsigned)blocks, MERGE_THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(s_hi), static_cast<const uint64_t*>(s_lo),
      static_cast<const uint32_t*>(s_idx), static_cast<uint64_t*>(d_hi),
      static_cast<uint64_t*>(d_lo), static_cast<uint32_t*>(d_idx), total,
      region, width, final, static_cast<const uint32_t*>(planes), n, num_ops,
      num_keys, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
