// K3b and the cross stage: bitonic sort of a kmer stream (Hopper, sm_90a).
//
// Replaces the TPU kernels of w2rap_contigger_tpu/ops/pallas_sort.py,
// launched by _sort_planes (:206-255):
//
//   K3a _tile_sort_kernel (:140, launched :220)
//       -> bitonic_tile.cu: one block runs levels 2..T of the network on
//          one tile of T rows as a key-index network;
//   XLA _cross_stage (:183, called :249)
//       -> cross_stage_kernel: one compare-exchange pass at a stride >= T,
//          one thread per pair;
//   K3b _tile_merge_kernel (:163, launched :236, once per level :252)
//       -> merge_kernel: strides T/2..1 of one merge level on one tile in
//          shared memory.
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
// 1) / 2 cross passes.  merge_kernel runs the log2(T) in-tile stages of a
// merge level in shared memory, moving whole rows (T as large as 160 KB
// of rows allows); fusing several cross strides into one pass is the
// next step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_THREADS = 1024;
constexpr int CROSS_THREADS = 256;
constexpr int SWAP_BATCH = 4;  // planes a cross-pass thread swaps at once
constexpr int CROSS_MIN_BLOCKS = 8;  // caps the cross pass at 32 registers

// true iff row a > row b on the first num_keys words of a tile in shared
// memory (plane j of the tile at s[j * T])
__device__ __forceinline__ bool greater_smem(const uint32_t* s, int T,
                                             int num_keys, int a, int b) {
  for (int j = 0; j < num_keys; ++j) {
    const uint32_t x = s[j * T + a], y = s[j * T + b];
    if (x != y) return x > y;
  }
  return false;
}

// strides stride0, stride0/2, ..., 1 of level `size` on one tile whose
// first row has the global index base
__device__ void tile_strides(uint32_t* s, int T, int num_ops, int num_keys,
                             int64_t base, int64_t size, int stride0) {
  for (int stride = stride0; stride > 0; stride >>= 1) {
    __syncthreads();
    for (int p = threadIdx.x; p < (T >> 1); p += blockDim.x) {
      const int a = ((p & ~(stride - 1)) << 1) | (p & (stride - 1));
      const int b = a + stride;
      const bool desc = ((base + a) & size) != 0;
      if (greater_smem(s, T, num_keys, a, b) != desc) {
        for (int j = 0; j < num_ops; ++j) {
          const uint32_t t = s[j * T + a];
          s[j * T + a] = s[j * T + b];
          s[j * T + b] = t;
        }
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void load_tile(const uint32_t* planes, uint32_t* s,
                                          int64_t n, int num_ops, int T,
                                          int64_t base) {
  for (int q = threadIdx.x; q < num_ops * T; q += blockDim.x) {
    const int j = q / T, i = q - j * T;
    s[q] = planes[(int64_t)j * n + base + i];
  }
}

__device__ __forceinline__ void store_tile(const uint32_t* s, uint32_t* planes,
                                           int64_t n, int num_ops, int T,
                                           int64_t base) {
  for (int q = threadIdx.x; q < num_ops * T; q += blockDim.x) {
    const int j = q / T, i = q - j * T;
    planes[(int64_t)j * n + base + i] = s[q];
  }
}

// K3b: strides T/2..1 of the merge level `size` (> T) on tile blockIdx.x.
__global__ void __launch_bounds__(TILE_THREADS)
merge_kernel(uint32_t* planes, int64_t n, int num_ops, int num_keys, int T,
             int64_t size) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int64_t base = (int64_t)blockIdx.x * T;
  load_tile(planes, smem, n, num_ops, T, base);
  tile_strides(smem, T, num_ops, num_keys, base, size, T >> 1);
  store_tile(smem, planes, n, num_ops, T, base);
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

int tile_threads(int T) { return T / 2 < TILE_THREADS ? T / 2 : TILE_THREADS; }

}  // namespace

// One merge level `size` (a power of two > T), strides T/2..1.
extern "C" int w2rap_bitonic_merge(void* planes, int64_t n, int num_ops,
                                   int num_keys, int T, int64_t size,
                                   void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const int bytes = num_ops * T * (int)sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<(unsigned)(n / T), tile_threads(T), bytes,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(planes), n, num_ops, num_keys, T, size);
  return (int)cudaGetLastError();
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
