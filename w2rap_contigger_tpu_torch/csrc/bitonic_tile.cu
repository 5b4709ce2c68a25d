// K3a: levels 2..T of the bitonic network on every tile of T rows, as the
// key-index network of keyindex_net.cuh (Hopper, sm_90a).
//
// Replaces the TPU kernel K3a, _tile_sort_kernel of
// w2rap_contigger_tpu/ops/pallas_sort.py (:140, launched by _sort_planes
// :220), which moves every plane of a row through every compare-exchange.
// The direction of position i is taken from its global row, (base + i) &
// size, with JAX's tie rule (bitonic.cu).
//
// Bound on this card: device memory, every plane read and written once.
// 15 of its 91 stages take a barrier at T = 8192, R = 8 (15 of 66 at
// T = 2048, R = 2).  Planes must be 16-byte aligned.

#include <cstdint>
#include <cuda_runtime.h>

#include "keyindex_net.cuh"

namespace {

template <int R>
__global__ void __launch_bounds__(NET_THREADS)
key_index_tile_sort_kernel(uint32_t* planes, int64_t n, int num_ops,
                           int num_keys, int T) {
  sort_planes_tile<R, false>(planes, n, num_ops, num_keys, T, 0);
}

const void* tile_sort_fn(int R) {
  return R == 2    ? (const void*)key_index_tile_sort_kernel<2>
         : R == 4  ? (const void*)key_index_tile_sort_kernel<4>
         : R == 8  ? (const void*)key_index_tile_sort_kernel<8>
         : R == 16 ? (const void*)key_index_tile_sort_kernel<16>
                   : nullptr;
}

}  // namespace

// planes: (num_ops, n) u32 planes, each T-row tile sorted in place; T a
// power of two dividing n, R (2, 4, 8 or 16) rows a thread, threads * R == T,
// 32 <= threads <= 1024, bytes = num_ops * T * 4 + 4 * T of shared memory.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a geometry the
// kernel does not take.
extern "C" int w2rap_bitonic_tile_sort(void* planes, int64_t n, int num_ops,
                                       int num_keys, int T, int R, int threads,
                                       int bytes, void* stream) {
  return net_launch(tile_sort_fn(R), n, T, R, threads, bytes,
                    (int64_t)num_ops * T * 4 + 4 * (int64_t)T, stream,
                    static_cast<uint32_t*>(planes), n, num_ops, num_keys, T);
}

// attrs[0..3] = registers a thread, local (spilled) bytes a thread, static
// shared bytes, most threads a block, of the kernel for R (2, 4, 8 or 16;
// cudaErrorInvalidValue for any other).
extern "C" int w2rap_bitonic_tile_sort_attrs(int R, int* attrs) {
  return net_attrs(tile_sort_fn(R), attrs);
}
