// K3b and the cross stage: bitonic sort of a kmer stream (Hopper, sm_90a).
//
// Replaces the TPU kernels of w2rap_contigger_tpu/ops/pallas_sort.py,
// launched by _sort_planes (:206-255):
//
//   K3a _tile_sort_kernel (:140, launched :220)
//       -> bitonic_tile.cu: levels 2..T of the network on one tile;
//   XLA _cross_stage (:183, called :249)
//       -> cross_stage_kernel: one compare-exchange pass at a stride >= T,
//          one thread per pair;
//   K3b _tile_merge_kernel (:163, launched :236, once per level :252)
//       -> key_index_merge_kernel: strides T/2..1 of one merge level on
//          one tile (5 of 13 stages through shared memory at T = 8192).
//   K3a and K3b are the key-index network of keyindex_net.cuh.
//
// The network is the canonical one, so its output does not depend on T:
// for size = 2, 4, ..., n and stride s = size/2, ..., 1, the pair (i, i+s)
// with i & s == 0 is compare-exchanged, and swapped iff (row i > row i+s)
// XOR ((i & size) != 0).  Rows compare lexicographically on the first
// num_keys u32 words, unsigned; the other planes ride along.  Equal keys
// therefore swap in a descending block, exactly as in the TPU kernels
// (_cmp_swap :89-108): the order of tied rows is a fixed function of the
// input, and kernel, plain version and TPU kernel agree bit for bit.
//
// Layout: (num_ops, n) u32 planes, row r of plane j at j * n + r, n a power
// of two.  Indices are 64-bit: the network's i & size is taken on the
// global row index, which passes 2^31 at 16 Mbp.  Every kernel sorts in
// place: each thread (cross stage) or block (tiles) writes only the rows it
// read.
//
// Bound on this card: device memory.  A tile pass or a cross pass reads and
// writes every plane once (a cross pass writes only swapped pairs); the
// sort is 1 tile pass, log2(n/T) merge passes and log2(n/T) (log2(n/T) +
// 1) / 2 cross passes; fusing several cross strides into one pass is the
// next step.

#include <cstdint>
#include <cuda_runtime.h>

#include "keyindex_net.cuh"

namespace {

constexpr int CROSS_THREADS = 256;
constexpr int SWAP_BATCH = 4;  // planes a cross-pass thread swaps at once
constexpr int CROSS_MIN_BLOCKS = 8;  // caps the cross pass at 32 registers

// K3b: strides T/2..1 of the merge level `size` (> T) on tile blockIdx.x.
// Since size > T and the tile's first row is a multiple of T, the
// direction is one for the whole tile, (base & size) != 0.
template <int R>
__global__ void __launch_bounds__(NET_THREADS)
key_index_merge_kernel(uint32_t* planes, int64_t n, int num_ops, int num_keys,
                       int T, int64_t size) {
  sort_planes_tile<R, true>(planes, n, num_ops, num_keys, T, size);
}

const void* merge_fn(int R) {
  return R == 2    ? (const void*)key_index_merge_kernel<2>
         : R == 4  ? (const void*)key_index_merge_kernel<4>
         : R == 8  ? (const void*)key_index_merge_kernel<8>
         : R == 16 ? (const void*)key_index_merge_kernel<16>
                   : nullptr;
}

// One compare-exchange pass at `stride` of level `size`, pair p of n/2:
// the key words are read up to the first that differs, and the rest of
// the rows only when the pair swaps.  Of the forms timed by
// scripts/cross_stage_ab.py this one is the fastest: a batch of 4 planes
// at full occupancy (a batch of 8 took 79 registers and ran slower).
__global__ void __launch_bounds__(CROSS_THREADS, CROSS_MIN_BLOCKS)
cross_stage_kernel(uint32_t* planes, int64_t n, int num_ops, int num_keys,
                   int64_t stride, int64_t size) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (n >> 1)) return;
  const int64_t a = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
  const int64_t b = a + stride;
  const bool desc = (a & size) != 0;
  bool gt = false;
  for (int j = 0; j < num_keys; ++j) {
    const uint32_t x = planes[j * n + a], y = planes[j * n + b];
    if (x != y) {
      gt = x > y;
      break;
    }
  }
  if (gt == desc) return;
  // SWAP_BATCH planes' loads before their stores: the compiler cannot
  // move a load above a store to the same buffer, so one plane at a time
  // would wait a memory round trip per plane
  for (int j0 = 0; j0 < num_ops; j0 += SWAP_BATCH) {
    uint32_t x[SWAP_BATCH], y[SWAP_BATCH];
#pragma unroll
    for (int u = 0; u < SWAP_BATCH; ++u) {
      if (j0 + u < num_ops) {
        x[u] = planes[(j0 + u) * n + a];
        y[u] = planes[(j0 + u) * n + b];
      }
    }
#pragma unroll
    for (int u = 0; u < SWAP_BATCH; ++u) {
      if (j0 + u < num_ops) {
        planes[(j0 + u) * n + a] = y[u];
        planes[(j0 + u) * n + b] = x[u];
      }
    }
  }
}

}  // namespace

// One merge level `size` (a power of two > T, int64: it passes 2^31 at
// 16 Mbp), strides T/2..1, in place; the geometry as K3a's
// (w2rap_bitonic_tile_sort).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a geometry the kernel does not take.
extern "C" int w2rap_bitonic_merge(void* planes, int64_t n, int num_ops,
                                   int num_keys, int T, int64_t size, int R,
                                   int threads, int bytes, void* stream) {
  if (size <= T) return (int)cudaErrorInvalidValue;
  return net_launch(merge_fn(R), n, T, R, threads, bytes,
                    (int64_t)num_ops * T * 4 + 4 * (int64_t)T, stream,
                    static_cast<uint32_t*>(planes), n, num_ops, num_keys, T,
                    size);
}

// attrs[0..3] as w2rap_bitonic_tile_sort_attrs, of K3b's kernel for R.
extern "C" int w2rap_bitonic_merge_attrs(int R, int* attrs) {
  return net_attrs(merge_fn(R), attrs);
}

// One pass at `stride` (a power of two < size) of level `size`.
extern "C" int w2rap_bitonic_cross_stage(void* planes, int64_t n, int num_ops,
                                         int num_keys, int64_t stride,
                                         int64_t size, void* stream) {
  if (n <= 1) return (int)cudaSuccess;
  const int64_t blocks = ((n >> 1) + CROSS_THREADS - 1) / CROSS_THREADS;
  cross_stage_kernel<<<(unsigned)blocks, CROSS_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(planes), n, num_ops, num_keys, stride, size);
  return (int)cudaGetLastError();
}
