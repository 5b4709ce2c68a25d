// K4c: merge of the sorted runs of every chunk of a bin region
// (Hopper, sm_90a).
//
// Replaces the TPU kernel K4c, _tile_sort_dyn_kernel of
// w2rap_contigger_tpu/ops/pallas_radix.py (:108, launched by
// _partition_sort_planes :422), which sorts each chunk of a region with a
// full bitonic network in VMEM.
//
// Contract.  The records (records.cuh) are regions of `region` records
// back to back; chunk c of a region is its records [c*C, c*C + C) (the
// last chunk may be shorter).  Every chunk consists of sorted runs of
// `run` records (a power of two; run == C when the chunk is one run):
// K4b's slots, each one tile's sorted rows followed by fill records.  The
// kernel returns every chunk sorted, as records or, `final`, as the
// output planes gathered through idx: what a full sort of each chunk
// returns, since records are unique but for fill records, which are
// identical.
//
// Design.  One block per chunk.  The chunk's records go to shared memory
// (SoA hi/lo/idx, 20 B a record, 160 KB at C = 8192), padded with fill to
// m, the power of two >= C; each run's count of real (non-fill) records
// is found once (a run's fill is its tail).  Then log2(m / run) merge
// levels: at width w, runs 2p and 2p+1 become one run of 2w.  Thread t
// owns the P = 8 output positions t*P .. t*P + P - 1 of one pair: it finds its
// co-rank (how many of the pair's first d = t*P mod 2w outputs come from
// the left run) by binary search over the two runs' real records, merges
// its P outputs into registers, waits on __syncthreads, and writes them
// back in place, so no second buffer is needed.  Tie rule: a <= b takes
// the left run's record first.  Real records are unique and fill records
// are never compared: the positions past a pair's real records are fill.
// Shared memory is swizzled (position k lives at k ^ ((k >> 4) & 15)) so
// that the P consecutive positions each thread writes back fall on
// distinct banks across a warp.
//
// Bound on this card: device memory, each record read and written once
// (40 B), or the gathered planes when `final`.  The shared-memory work is
// log2(m / run) levels of one binary search (log2(w) + 1 steps), P reads
// and P writes per thread: 3 levels at step 2's and step 3's shapes,
// where the bitonic network it replaces ran 91 compare-exchange stages.

#include <cstdint>
#include <cuda_runtime.h>

#include "records.cuh"

namespace {

constexpr int MAX_M = 8192;  // records a chunk holds in shared memory (160 KB)
constexpr int MAX_RUNS = 64;  // sorted runs a chunk may hold
// records a thread merges a level: 57 registers at 1024 threads; P = 16
// (122 registers, 512 threads) was slower at both shapes (PERF.md, PR 4)
constexpr int P = 8;

__device__ __forceinline__ int sw(int k) { return k ^ ((k >> 4) & 15); }

struct Chunk {
  uint64_t* hi;
  uint64_t* lo;
  uint32_t* idx;
};

struct Rec {
  uint64_t h, l;
  uint32_t i;
};

__device__ __forceinline__ Rec rec_at(const Chunk& s, int k) {
  const int q = sw(k);
  return {s.hi[q], s.lo[q], s.idx[q]};
}

__device__ __forceinline__ Rec fill_rec() { return {MAX64, MAX64, FILL_IDX}; }

// record a <= record b: hi decides but for ties, so lo and idx are read
// only then
__device__ __forceinline__ bool le_at(const Chunk& s, int a, int b) {
  const int qa = sw(a), qb = sw(b);
  const uint64_t ah = s.hi[qa], bh = s.hi[qb];
  if (ah != bh) return ah < bh;
  const uint64_t al = s.lo[qa], bl = s.lo[qb];
  if (al != bl) return al < bl;
  return s.idx[qa] <= s.idx[qb];
}

__global__ void __launch_bounds__(MAX_M / P)
region_merge_kernel(const uint64_t* __restrict__ r_hi,
                    const uint64_t* __restrict__ r_lo,
                    const uint32_t* __restrict__ r_idx,
                    uint64_t* __restrict__ d_hi, uint64_t* __restrict__ d_lo,
                    uint32_t* __restrict__ d_idx, int64_t region, int C,
                    int chunks_per_region, int run, int m, int final,
                    const uint32_t* __restrict__ planes, int64_t n,
                    int num_ops, int num_keys, uint32_t* __restrict__ out,
                    int64_t total) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_real[MAX_RUNS];
  Chunk s;
  s.hi = reinterpret_cast<uint64_t*>(smem);
  s.lo = s.hi + m;
  s.idx = reinterpret_cast<uint32_t*>(s.lo + m);
  const int tid = threadIdx.x;
  const int64_t r = blockIdx.x / chunks_per_region;
  const int64_t c = blockIdx.x % chunks_per_region;
  const int64_t start = r * region + c * C;
  const int64_t left = region - c * C;
  const int len = left < C ? (int)left : C;
  const int runs = m / run;

#pragma unroll 4
  for (int i = tid; i < m; i += blockDim.x) {
    const int q = sw(i);
    if (i < len) {
      s.hi[q] = r_hi[start + i];
      s.lo[q] = r_lo[start + i];
      s.idx[q] = r_idx[start + i];
    } else {
      s.hi[q] = MAX64;
      s.lo[q] = MAX64;
      s.idx[q] = FILL_IDX;
    }
  }
  for (int q = tid; q < runs; q += blockDim.x) n_real[q] = 0;
  __syncthreads();
  // a run's real records end where its fill tail starts (runs past len
  // are all fill and keep 0)
  if (runs > 1) {
    for (int i = tid; i < len; i += blockDim.x) {
      if (s.idx[sw(i)] != FILL_IDX &&
          ((i + 1) % run == 0 || s.idx[sw(i + 1)] == FILL_IDX))
        n_real[i / run] = i % run + 1;
    }
  }
  __syncthreads();

  const int k0 = tid * P;
  for (int w = run; w < m; w <<= 1) {
    const int pair = k0 / (2 * w);
    const int d = k0 - pair * 2 * w;
    const int a0 = pair * 2 * w, b0 = a0 + w;
    const int na = n_real[2 * pair], nb = n_real[2 * pair + 1];
    // co-rank: i of the first d outputs come from the left run; past the
    // real records every output is fill
    int i = na, j = nb;
    if (d < na + nb) {
      int lo = d > nb ? d - nb : 0, hi = d < na ? d : na;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (le_at(s, a0 + mid, b0 + d - 1 - mid))
          lo = mid + 1;
        else
          hi = mid;
      }
      i = lo;
      j = d - lo;
    }
    Rec a = i < na ? rec_at(s, a0 + i) : fill_rec();
    Rec b = j < nb ? rec_at(s, b0 + j) : fill_rec();
    uint64_t oh[P], ol[P];
    uint32_t oi[P];
#pragma unroll
    for (int u = 0; u < P; ++u) {
      // a <= b takes a (a fill head never goes before a real one)
      const bool take_a = !rec_less(b.h, b.l, b.i, a.h, a.l, a.i);
      oh[u] = take_a ? a.h : b.h;
      ol[u] = take_a ? a.l : b.l;
      oi[u] = take_a ? a.i : b.i;
      if (u + 1 < P) {
        if (take_a) {
          ++i;
          a = i < na ? rec_at(s, a0 + i) : fill_rec();
        } else {
          ++j;
          b = j < nb ? rec_at(s, b0 + j) : fill_rec();
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int q = sw(k0 + u);
      s.hi[q] = oh[u];
      s.lo[q] = ol[u];
      s.idx[q] = oi[u];
    }
    if (d == 0) n_real[pair] = na + nb;
    __syncthreads();
  }

  for (int i = tid; i < len; i += blockDim.x) {
    const int q = sw(i);
    if (final) {
      write_row(planes, n, num_ops, num_keys, out, total, start + i, s.idx[q]);
    } else {
      d_hi[start + i] = s.hi[q];
      d_lo[start + i] = s.lo[q];
      d_idx[start + i] = s.idx[q];
    }
  }
}

int launch(const void* r_hi, const void* r_lo, const void* r_idx, void* d_hi,
           void* d_lo, void* d_idx, int64_t total, int64_t region, int C,
           int run, int m, int threads, int final, const void* planes,
           int64_t n, int num_ops, int num_keys, void* out, void* stream) {
  const int bytes = m * RECORD_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      region_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t cpr = (region + C - 1) / C;
  region_merge_kernel<<<(unsigned)((total / region) * cpr), threads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(r_hi), static_cast<const uint64_t*>(r_lo),
      static_cast<const uint32_t*>(r_idx), static_cast<uint64_t*>(d_hi),
      static_cast<uint64_t*>(d_lo), static_cast<uint32_t*>(d_idx), region, C,
      (int)cpr, run, m, final, static_cast<const uint32_t*>(planes), n,
      num_ops, num_keys, static_cast<uint32_t*>(out), total);
  return (int)cudaGetLastError();
}

}  // namespace

// r_* -> d_*: (total,) records, total a multiple of region; chunks of C
// records, each sorted runs of `run`; m = the power of two >= C,
// threads * P == m.  final: gather (num_ops, total) u32 planes into out
// instead of writing records.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a geometry the kernel does not take.
extern "C" int w2rap_radix_region_sort(const void* r_hi, const void* r_lo,
                                       const void* r_idx, void* d_hi,
                                       void* d_lo, void* d_idx, int64_t total,
                                       int64_t region, int C, int run, int m,
                                       int threads, int final,
                                       const void* planes, int64_t n,
                                       int num_ops, int num_keys, void* out,
                                       void* stream) {
  if (total <= 0) return (int)cudaSuccess;
  if (run <= 0 || m < C || m % run || m / run > MAX_RUNS ||
      threads * P != m || m > MAX_M)
    return (int)cudaErrorInvalidValue;
  return launch(r_hi, r_lo, r_idx, d_hi, d_lo, d_idx, total, region, C, run,
                m, threads, final, planes, n, num_ops, num_keys, out, stream);
}

// attrs[0..3] = registers a thread, local (spilled) bytes a thread, static
// shared bytes, most threads a block.
extern "C" int w2rap_radix_region_sort_attrs(int* attrs) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, (const void*)region_merge_kernel);
  if (err != cudaSuccess) return (int)err;
  attrs[0] = a.numRegs;
  attrs[1] = (int)a.localSizeBytes;
  attrs[2] = (int)a.sharedSizeBytes;
  attrs[3] = a.maxThreadsPerBlock;
  return (int)cudaSuccess;
}
