// K4a, K4b, K4d: partition (sample) sort of a kmer stream (Hopper, sm_90a).
//
// Replaces the TPU kernels of w2rap_contigger_tpu/ops/pallas_radix.py,
// launched by _partition_sort_planes (:330-457):
//
//   K4a _tile_sort_ascending_kernel (:152, launched :350)
//       -> tile_sort_kernel: one block sorts one tile of T rows with the
//          key-index network of keyindex_net.cuh;
//   K4b _partition_kernel (:221, launched :386)
//       -> partition_kernel: one block cuts one bin of one sorted tile
//          into its slot;
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
//   2. partition_kernel, one block a (tile t, bin b): s_b = #records <
//      splitter_{b-1} and s_{b+1} by two warp searches (32 probes a step)
//      in the sorted tile, s_0 = 0, s_B = #non-sentinel rows (a sentinel
//      row is all ones in all num_keys words; such rows sort to the
//      tile's tail, and only the tail's words past cmp_keys are read from
//      the planes, by the last bin's block, none when cmp_keys ==
//      num_keys); rows [s_b, s_{b+1}) (at most cap) go to slot (bin b,
//      tile t) of cap records, the rest of the slot is fill, stored as
//      16-byte vectors.  overflow += slots holding more than cap - 128
//      rows, plus real rows whose cmp_keys words are all ones
//      (pallas_radix.py: 252-275, 306-311): the flag is the TPU kernel's
//      exactly.  Every slot is therefore a sorted run: a tile's sorted
//      rows, then fill.  The first form (one block a tile, 16 bins' copies
//      in turn after 13-step binary searches in 16 threads) had one
//      partial wave of long blocks at step 3's shape, 562 tiles: 44% of
//      its bound.
//   3. region_merge.cu: every chunk of C records of a region (C / cap
//      slots) merged into one sorted run.
//   4. merge_pass_kernel, width C, 2C, ... below the region: runs 2p and
//      2p+1 of every region merge into one (merge path by the block).  A
//      block owns B = 2048 consecutive outputs of one pair; two warps find
//      its two co-ranks in device memory (32 probes a step), the block
//      stages its slices of the two runs in shared memory with 16-byte
//      cp.async copies, each thread co-ranks and merges its P = 8
//      outputs in registers (a <= b takes the left record), and the block
//      stores its outputs from a swizzled staging buffer as 16-byte
//      vectors.
//   The last phase that runs gathers the num_ops planes through idx
//   (fill records become all-ones key words and 0 payload words).
//
// Bound on this card: device memory.  The planes are read once by phase 1
// (the comparator words) and once by the gather (the rows taken); records
// (20 B) cross device memory once per phase and once per merge level;
// the output (num_ops u32 per slot, 2x the rows at CAP_FACTOR 2) is
// written once.  The design trades the TPU's
// O(log^2) plane movement for O(log) record movement; merge levels are
// the term that grows with the region size.  A merge level's search is
// one per block (about 205k a level at step 2's shape), not one per
// record: the one-thread-a-record form waited on 13-24 dependent loads a
// record and scattered its stores, 3.5x its bound.

#include <cstdint>
#include <cuda_runtime.h>

#include "keyindex_net.cuh"
#include "records.cuh"

namespace {

constexpr int PART_THREADS = 256;
constexpr int PART_V = 4;  // K4b: slot records a thread stores a step
static_assert(PART_V == 4, "K4b stores 2 x 16 B of hi and of lo, 16 B of idx");
constexpr int MERGE_THREADS = 256;
// K4d: records a thread merges a level (64 registers); P = 16 (120
// registers) was 4-9% slower at the first level of step 2's and step 3's
// sorts on an H100 80GB HBM3 at 700 W (scripts/sort_kernel_ab.py; PERF.md)
constexpr int MERGE_P = 8;

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

// K4b: block (t, b) cuts bin b of sorted tile t into its slot of cap
// records (blocks of one tile are neighbours in launch order, so the
// tile's probed records are shared in L2).
//
// Count of the tile's records below the key (kh, kl), on (hi, lo) only:
// one warp, 32 probes a step (lane l tests record lo + l*s; "below"
// holds on a prefix of the lanes, and the ballot's count keeps the one
// gap of s that holds the answer): 3 steps at T = 8192, each one round
// trip for both words.
__device__ int count_below_warp(const uint64_t* __restrict__ hi,
                                const uint64_t* __restrict__ lo, int64_t t0,
                                int T, uint64_t kh, uint64_t kl, int lane) {
  int l = 0, h = T;
  while (l < h) {
    const int s = (h - l + 31) >> 5;
    const int p = l + lane * s;
    bool below = false;
    if (p < h) {
      const uint64_t ph = hi[t0 + p], pl = lo[t0 + p];
      below = ph < kh || (ph == kh && pl < kl);
    }
    const int c = __popc(__ballot_sync(0xFFFFFFFFu, below));
    const int nh = l + c * s;
    l = c ? l + (c - 1) * s + 1 : l;
    h = nh < h ? nh : h;
  }
  return l;
}

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
  __shared__ int edge[2];
  __shared__ int n_sent;
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t t = blockIdx.x / n_bins;
  const int b = blockIdx.x % n_bins;
  const int64_t t0 = t * T;
  const bool last = b == n_bins - 1;
  if (tid == 0) n_sent = 0;

  // warp 0: the bin's first row, #records < splitter b - 1 (0 for bin
  // 0); warp 1: its end, #records < splitter b, or for the last bin
  // #records < the all-ones key (missing words are 0 in every record):
  // the rows all ones in their cmp_keys words sort to the tile's tail
  const int which = tid >> 5;
  if (which < 2) {
    const int sb = b - 1 + which;
    int v = 0;
    if (sb >= 0) {
      uint64_t kh, kl;
      if (sb < n_bins - 1) {
        kh = sp_hi[sb];
        kl = sp_lo[sb];
      } else {
        kh = cmp_keys >= 2 ? MAX64 : MAX64 << 32;
        kl = cmp_keys >= 4 ? MAX64 : (cmp_keys == 3 ? MAX64 << 32 : 0ull);
      }
      v = count_below_warp(s_hi, s_lo, t0, T, kh, kl, lane);
    }
    if (lane == 0) edge[which] = v;
  }
  __syncthreads();
  const int start = edge[0];
  int end = edge[1];
  int ov = 0;

  // the last bin ends at the tile's sentinels: a sentinel row is all
  // ones in all num_keys words, so with cmp_keys == num_keys every tail
  // row is one; else the tail rows' later key words are read (the only
  // plane reads here, every word of a row issued at once) and the other
  // tail rows are "ambiguous" real rows that tie with the sentinels
  if (last) {
    const int n_full = T - end;
    if (cmp_keys < num_keys) {
      int sent_c = 0;
      for (int i = end + tid; i < T; i += blockDim.x) {
        const int64_t row = s_idx[t0 + i];
        bool sent = true;
#pragma unroll 4
        for (int j = cmp_keys; j < num_keys; ++j)
          sent &= planes[j * n + row] == FULL;
        sent_c += sent;
      }
      for (int off = 16; off > 0; off >>= 1)
        sent_c += __shfl_down_sync(0xFFFFFFFFu, sent_c, off);
      if (lane == 0 && sent_c) atomicAdd(&n_sent, sent_c);
      __syncthreads();
      end = T - n_sent;
    } else {
      end = T - n_full;
    }
    ov = n_full - (T - end);
  }
  ov += end - start > cap - 128 ? 1 : 0;
  if (tid == 0 && ov) atomicAdd(overflow, ov);

  // the slot: the bin's rows (at most cap), then fill, as 16-byte
  // vectors, so that every store of a warp writes 512 contiguous bytes:
  // of the 4 * blockDim.x slot records of a step, thread t stores hi and
  // lo of records 2t, 2t + 1 and 2t + 2 * blockDim.x, + 1, and idx of
  // records 4t .. 4t + 3 (the slot starts at a multiple of cap, a
  // multiple of 4); the reads, at the bin's start, are coalesced scalars
  const int take = max(0, min(end - start, cap));
  const int64_t src0 = t0 + start;
  const int64_t dst0 = (int64_t)b * region + t * cap;
  for (int j0 = 0; j0 < cap; j0 += blockDim.x * PART_V) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int a = j0 + 2 * tid + q * 2 * blockDim.x;
      if (a < cap) {
        const bool i0 = a < take, i1 = a + 1 < take;
        *reinterpret_cast<ulonglong2*>(r_hi + dst0 + a) = make_ulonglong2(
            i0 ? s_hi[src0 + a] : MAX64, i1 ? s_hi[src0 + a + 1] : MAX64);
        *reinterpret_cast<ulonglong2*>(r_lo + dst0 + a) = make_ulonglong2(
            i0 ? s_lo[src0 + a] : MAX64, i1 ? s_lo[src0 + a + 1] : MAX64);
      }
    }
    const int e = j0 + PART_V * tid;
    if (e < cap) {
      uint32_t x[PART_V];
#pragma unroll
      for (int u = 0; u < PART_V; ++u)
        x[u] = e + u < take ? s_idx[src0 + e + u] : FILL_IDX;
      *reinterpret_cast<uint4*>(r_idx + dst0 + e) = make_uint4(x[0], x[1], x[2], x[3]);
    }
  }
}

// K4d: one merge level; runs of `width` records inside each region merge
// pairwise into runs of 2*width (the last run of a region may be short or
// have no partner).  Block geometry (ops/radix.py merge_pass_geometry):
// B = threads * MERGE_P outputs a block, threads = min(MERGE_THREADS,
// 2 * width / MERGE_P), so that B divides 2 * width and a block's outputs
// [o0, o1) (region-relative, o1 <= o0 + B) lie in one pair.

// staged records past B: the two slices' alignment heads and the tails
// of their 16-byte covers
constexpr int MERGE_PAD = 16;

__host__ __device__ constexpr int merge_stage(int B) { return B + MERGE_PAD; }

// the output staging swizzle (region_merge.cu's): a thread's P
// consecutive positions fall on distinct banks across a warp
__device__ __forceinline__ int mswz(int k) { return k ^ ((k >> 4) & 15); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// Stage elements [g0, g0 + len) of a global array to shared elements
// [s0, s0 + len) with 16-byte cp.async copies of the aligned chunks that
// cover them; s0 == g0 (mod 4) keeps a chunk a chunk in shared memory
// for 8- and 4-byte elements.  The cover's extra elements (at most 3 on
// either side) land in the pads beside the slice; they never leave the
// array, whose base and end are 16-byte aligned.
template <typename E>
__device__ __forceinline__ void stage_slice(const E* __restrict__ g,
                                            int64_t g0, int len, E* s,
                                            int s0) {
  constexpr int PER = 16 / sizeof(E);
  if (len <= 0) return;
  const int64_t c0 = g0 / PER, c1 = (g0 + len + PER - 1) / PER;
  char* sb = reinterpret_cast<char*>(s + (s0 - (int)(g0 - c0 * PER)));
  const char* gb = reinterpret_cast<const char*>(g + c0 * PER);
  for (int64_t c = threadIdx.x; c < c1 - c0; c += blockDim.x)
    cp_async16(sb + c * 16, gb + c * 16);
}

// Co-rank of d outputs of the merge of A = [a, a + la) and B = [b, b +
// lb): how many of the first d come from A, with a <= b taking a.  One
// warp, 32 probes a step: lane l tests split lo + l*s (A[p] <= B[d-1-p]
// holds below the co-rank and fails from it on), and the ballot's count
// keeps the one gap of s that holds it: ceil(log33(width)) steps (3 at
// width 8192, 5 at 2^24), each one round trip for all six loads.
__device__ int64_t corank_warp(const uint64_t* __restrict__ hi,
                               const uint64_t* __restrict__ lo,
                               const uint32_t* __restrict__ idx, int64_t a,
                               int64_t la, int64_t b, int64_t lb, int64_t d,
                               int lane) {
  int64_t l = d > lb ? d - lb : 0, h = d < la ? d : la;
  while (l < h) {
    const int64_t s = (h - l + 31) / 32;
    const int64_t p = l + lane * s;
    bool le = false;
    if (p < h) {
      const int64_t q = b + d - 1 - p;
      const uint64_t ah = hi[a + p], al = lo[a + p], bh = hi[q], bl = lo[q];
      const uint32_t ai = idx[a + p], bi = idx[q];
      le = !rec_less(bh, bl, bi, ah, al, ai);
    }
    const int t = __popc(__ballot_sync(0xFFFFFFFFu, le));
    const int64_t nh = l + t * s;
    l = t ? l + (t - 1) * s + 1 : l;
    h = nh < h ? nh : h;
  }
  return l;
}

__global__ void __launch_bounds__(MERGE_THREADS)
merge_pass_kernel(const uint64_t* __restrict__ s_hi,
                  const uint64_t* __restrict__ s_lo,
                  const uint32_t* __restrict__ s_idx,
                  uint64_t* __restrict__ d_hi, uint64_t* __restrict__ d_lo,
                  uint32_t* __restrict__ d_idx, int64_t total, int64_t region,
                  int64_t width, int final,
                  const uint32_t* __restrict__ planes, int64_t n, int num_ops,
                  int num_keys, uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char k4d_smem[];
  __shared__ int64_t s_co[2];
  const int tid = threadIdx.x;
  const int B = blockDim.x * MERGE_P;
  const int S = merge_stage(B);
  uint64_t* sh = reinterpret_cast<uint64_t*>(k4d_smem);
  uint64_t* sl = sh + S;
  uint32_t* si = reinterpret_cast<uint32_t*>(sl + S);

  // this block's outputs [o0, o1) of region r, in the pair starting at ps
  const int64_t bpr = (region + B - 1) / B;
  const int64_t rbase = (int64_t)(blockIdx.x / bpr) * region;
  const int64_t o0 = (int64_t)(blockIdx.x % bpr) * B;
  const int64_t o1 = o0 + B < region ? o0 + B : region;
  const int64_t ps = o0 / (2 * width) * (2 * width);
  const int64_t la = width < region - ps ? width : region - ps;
  const int64_t room = region - ps - width;
  const int64_t lb = room <= 0 ? 0 : (room < width ? room : width);
  const int64_t a = rbase + ps, b = a + width;
  const int64_t d0 = o0 - ps, d1 = o1 - ps;

  // the block's two co-ranks, one warp each (one warp both at 32 threads)
  for (int which = tid >> 5; which < 2; which += blockDim.x >> 5) {
    const int64_t c =
        corank_warp(s_hi, s_lo, s_idx, a, la, b, lb, which ? d1 : d0, tid & 31);
    if ((tid & 31) == 0) s_co[which] = c;
  }
  __syncthreads();
  const int64_t i0 = s_co[0], i1 = s_co[1];
  const int na = (int)(i1 - i0);
  const int nb = (int)((d1 - i1) - (d0 - i0));
  const int cnt = (int)(d1 - d0);

  // slices A[i0, i1) at sa and B[d0 - i0, d1 - i1) at sb, each placed
  // at its global index mod 4 so that its 16-byte chunks stay chunks
  const int64_t ga = a + i0, gb = b + (d0 - i0);
  const int sa = (int)(ga & 3);
  const int sb = ((sa + na + 3) & ~3) + (int)(gb & 3);
  stage_slice(s_hi, ga, na, sh, sa);
  stage_slice(s_lo, ga, na, sl, sa);
  stage_slice(s_idx, ga, na, si, sa);
  stage_slice(s_hi, gb, nb, sh, sb);
  stage_slice(s_lo, gb, nb, sl, sb);
  stage_slice(s_idx, gb, nb, si, sb);
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // thread t: outputs e .. e + P - 1 of the block, co-ranked in the
  // slices, merged into registers (a <= b takes a; an exhausted side
  // reads as a fill record, which only ever ties with fill)
  const int e = tid * MERGE_P;
  uint64_t oh[MERGE_P], ol[MERGE_P];
  uint32_t oi[MERGE_P];
  if (e < cnt) {
    int l = e > nb ? e - nb : 0, h = e < na ? e : na;
    while (l < h) {
      const int mid = (l + h) >> 1;
      const int p = sa + mid, q = sb + e - 1 - mid;
      if (!rec_less(sh[q], sl[q], si[q], sh[p], sl[p], si[p]))
        l = mid + 1;
      else
        h = mid;
    }
    int i = l, j = e - l;
    uint64_t ah = MAX64, al = MAX64, bh = MAX64, bl = MAX64;
    uint32_t ai = FILL_IDX, bi = FILL_IDX;
    if (i < na) ah = sh[sa + i], al = sl[sa + i], ai = si[sa + i];
    if (j < nb) bh = sh[sb + j], bl = sl[sb + j], bi = si[sb + j];
#pragma unroll
    for (int u = 0; u < MERGE_P; ++u) {
      const bool take_a = !rec_less(bh, bl, bi, ah, al, ai);
      oh[u] = take_a ? ah : bh;
      ol[u] = take_a ? al : bl;
      oi[u] = take_a ? ai : bi;
      if (u + 1 < MERGE_P) {
        if (take_a) {
          ++i;
          ah = MAX64, al = MAX64, ai = FILL_IDX;
          if (i < na) ah = sh[sa + i], al = sl[sa + i], ai = si[sa + i];
        } else {
          ++j;
          bh = MAX64, bl = MAX64, bi = FILL_IDX;
          if (j < nb) bh = sh[sb + j], bl = sl[sb + j], bi = si[sb + j];
        }
      }
    }
  }
  __syncthreads();
  if (e < cnt) {
#pragma unroll
    for (int u = 0; u < MERGE_P; ++u) {
      const int k = mswz(e + u);
      if (e + u < cnt) {
        if (!final) sh[k] = oh[u], sl[k] = ol[u];
        si[k] = oi[u];
      }
    }
  }
  __syncthreads();

  // the block's outputs as 16-byte vectors (records: 2 of hi or lo, 4 of
  // idx; final: 4 rows of each plane, gathered through idx); scalar when
  // the destination is not 16-byte aligned, and for a ragged tail
  const int64_t dst0 = rbase + o0;
  const bool vec = ((dst0 | (final ? total : 0)) & 3) == 0;
  const int nv = vec ? cnt / 4 : 0;
  if (!final) {
    for (int c = tid; c < 2 * nv; c += blockDim.x) {
      const int k = 2 * c;
      reinterpret_cast<ulonglong2*>(d_hi + dst0)[c] =
          make_ulonglong2(sh[mswz(k)], sh[mswz(k + 1)]);
      reinterpret_cast<ulonglong2*>(d_lo + dst0)[c] =
          make_ulonglong2(sl[mswz(k)], sl[mswz(k + 1)]);
    }
    for (int c = tid; c < nv; c += blockDim.x) {
      const int k = 4 * c;
      reinterpret_cast<uint4*>(d_idx + dst0)[c] =
          make_uint4(si[mswz(k)], si[mswz(k + 1)], si[mswz(k + 2)],
                     si[mswz(k + 3)]);
    }
    for (int k = 4 * nv + tid; k < cnt; k += blockDim.x) {
      const int q = mswz(k);
      d_hi[dst0 + k] = sh[q];
      d_lo[dst0 + k] = sl[q];
      d_idx[dst0 + k] = si[q];
    }
  } else {
    for (int jp = 0; jp < num_ops; ++jp) {
      const uint32_t* pl = planes + jp * n;
      uint32_t* o = out + jp * total + dst0;
      const uint32_t fill = jp < num_keys ? FULL : 0u;
      auto row = [&](int k) {
        const uint32_t x = si[mswz(k)];
        return x != FILL_IDX ? pl[x] : fill;
      };
#pragma unroll 2
      for (int c = tid; c < nv; c += blockDim.x) {
        const int k = 4 * c;
        reinterpret_cast<uint4*>(o)[c] =
            make_uint4(row(k), row(k + 1), row(k + 2), row(k + 3));
      }
      for (int k = 4 * nv + tid; k < cnt; k += blockDim.x) o[k] = row(k);
    }
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
// r_*: (n_bins * region,) slot records out, region = (n/T) * cap, 16-byte
// aligned; cap a multiple of 4; overflow: one int, zeroed by the caller.
// One block a (tile, bin).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int w2rap_radix_partition(
    const void* planes, int64_t n, int num_keys, int cmp_keys, int T,
    int n_bins, int cap, const void* sp_hi, const void* sp_lo,
    const void* s_hi, const void* s_lo, const void* s_idx, void* r_hi,
    void* r_lo, void* r_idx, int64_t region, void* overflow, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (cap % PART_V || n % T || n_bins < 1 || misaligned(r_hi) ||
      misaligned(r_lo) || misaligned(r_idx))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (n / T) * n_bins;
  partition_kernel<<<(unsigned)blocks, PART_THREADS, 0,
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

// attrs[0..3] = registers a thread, local (spilled) bytes a thread, static
// shared bytes, most threads a block, of K4b's kernel.
extern "C" int w2rap_radix_partition_attrs(int* attrs) {
  return net_attrs((const void*)partition_kernel, attrs);
}

// s_* -> d_* (or, final, the gathered planes into out), one merge level
// of runs of `width` records (a power of two >= 16 * MERGE_P) in every
// region of `region` records; every pointer 16-byte aligned.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel
// does not take.
extern "C" int w2rap_radix_merge_pass(const void* s_hi, const void* s_lo,
                                      const void* s_idx, void* d_hi,
                                      void* d_lo, void* d_idx, int64_t total,
                                      int64_t region, int64_t width, int final,
                                      const void* planes, int64_t n,
                                      int num_ops, int num_keys, void* out,
                                      void* stream) {
  if (total <= 0) return (int)cudaSuccess;
  auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  if (width & (width - 1) || 2 * width < 32 * MERGE_P || region <= 0 ||
      total % region || misaligned(s_hi) || misaligned(s_lo) ||
      misaligned(s_idx) ||
      (final ? misaligned(planes) || misaligned(out)
             : misaligned(d_hi) || misaligned(d_lo) || misaligned(d_idx)))
    return (int)cudaErrorInvalidValue;
  const int threads =
      2 * width / MERGE_P < MERGE_THREADS ? (int)(2 * width / MERGE_P)
                                          : MERGE_THREADS;
  const int B = threads * MERGE_P;
  const int bytes = merge_stage(B) * RECORD_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      merge_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (total / region) * ((region + B - 1) / B);
  merge_pass_kernel<<<(unsigned)blocks, threads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(s_hi), static_cast<const uint64_t*>(s_lo),
      static_cast<const uint32_t*>(s_idx), static_cast<uint64_t*>(d_hi),
      static_cast<uint64_t*>(d_lo), static_cast<uint32_t*>(d_idx), total,
      region, width, final, static_cast<const uint32_t*>(planes), n, num_ops,
      num_keys, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// attrs[0..3] = registers a thread, local (spilled) bytes a thread, static
// shared bytes, most threads a block, of K4d's kernel.
extern "C" int w2rap_radix_merge_pass_attrs(int* attrs) {
  return net_attrs((const void*)merge_pass_kernel, attrs);
}
