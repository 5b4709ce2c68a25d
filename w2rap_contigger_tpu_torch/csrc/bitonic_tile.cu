// K3a: levels 2..T of the bitonic network on every tile of T rows, as a
// key-index network (Hopper, sm_90a).
//
// Replaces the TPU kernel K3a, _tile_sort_kernel of
// w2rap_contigger_tpu/ops/pallas_sort.py (:140, launched by _sort_planes
// :220), which moves every plane of a row through every compare-exchange.
//
// The network is bitonic.cu's (the canonical one): for size = 2, 4, ..., T
// and stride s = size/2, ..., 1, the pair (i, i+s) with i & s == 0 is
// swapped iff (row i > row i+s) XOR (((base + i) & size) != 0), rows
// compared lexicographically on their first num_keys u32 words, unsigned,
// and base the tile's first global row.  Only the comparisons decide the
// network, so only a key and an index move through it:
//
// * The tile's num_ops planes are loaded once, coalesced, into shared
//   memory and are read-only from then on.
// * Thread t holds R positions t*R .. t*R + R-1 in registers, each as
//   (local row index, the row's first key word).  Strides below R are
//   compare-exchanged in registers, strides R .. 16R between the lanes of
//   a warp by __shfl_xor_sync, and strides >= 32R by an exchange of
//   indices only through shared memory (thread t reads thread t ^ (s/R)'s
//   R indices, then re-reads their first key words from the tile; two
//   index buffers, so one __syncthreads a stage).
// * When the first key words tie, words 1..num_keys-1 are read from the
//   tile through the two indices, unless both rows are sentinels (all
//   ones in every key word; bit 15 of the 16-bit index, set once at the
//   load), which are equal: the padding of a stream to a power of two is
//   sentinels, 22-45% of the rows on the main path, and a chain of
//   num_keys dependent shared reads a tie would stall their warps.  Both
//   threads of a pair compute the same comparison of the lower row
//   against the upper one, so they agree.
// * At the end every plane is stored through the final indices, each
//   thread its R consecutive positions as 16 B vectors: each row moves
//   once.  The load is 16 B vectors too, 8 in flight a thread: one block
//   fills a SM's shared memory, so nothing hides a tile's load but the
//   bytes in flight.
//
// Nothing is held in a register array indexed by num_ops or num_keys, so
// any key width (up to W = 40 at K = 640) runs without spilling.  Shared
// memory: num_ops * T * 4 bytes of planes + 2 * 2 * T bytes of indices
// (192 KB at T = 8192 x 5 planes, 152 KB at 2048 x 18 planes).  R is
// the least of 2, 4, 8, 16 that keeps T / R <= 1024 threads
// (ops/bitonic.py tile_geometry): more threads hide more latency.  Planes
// must be 16-byte aligned (n a power of two >= 128 and an aligned base).
//
// Bound on this card: device memory, every plane read and written once.
// The design cuts the shared-memory traffic of the log2(T) (log2(T) + 1)
// / 2 stages from whole rows to 2-6 bytes a position, and the barriers
// from one a stage to one a stage with a stride >= 32R (15 of 91 at
// T = 8192, R = 8; 15 of 66 at T = 2048, R = 2).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int LOADS_IN_FLIGHT = 8;  // 16 B loads a thread issues before storing
constexpr unsigned WARP = 0xFFFFFFFFu;
constexpr uint32_t SENT = 0x8000u;  // index bit 15: the row is a sentinel
constexpr uint32_t ROW = 0x7FFFu;   // index bits 0..14: the tile row (T <= 16384)

// row a > row b on key words 1..num_keys-1 (word 0 tied); two sentinels
// (all ones in every key word) are equal without reading the tile.  Out of
// line: ties are rare but for sentinels, and the network's unrolled
// stages would otherwise hold dozens of copies of the loop.
__device__ __noinline__ bool later_greater(const uint32_t* tile, int T,
                                           int num_keys, uint32_t a,
                                           uint32_t b) {
  if (a & b & SENT) return false;
  a &= ROW;
  b &= ROW;
  for (int j = 1; j < num_keys; ++j) {
    const uint32_t x = tile[j * T + a], y = tile[j * T + b];
    if (x != y) return x > y;
  }
  return false;
}

// the index of tile row i, with SENT if its key words are all ones
__device__ __forceinline__ uint32_t row_index(const uint32_t* tile, int T,
                                              int num_keys, int i) {
  for (int j = 0; j < num_keys; ++j)
    if (tile[j * T + i] != 0xFFFFFFFFu) return (uint32_t)i;
  return (uint32_t)i | SENT;
}

// one side of a compare-exchange across threads: this thread's (key, ix)
// against its partner's (pk, pi).  The pair swaps iff (lower row > upper
// row) XOR desc; flip = upper XOR desc, upper meaning this thread holds
// the pair's upper position, so with unequal first words the swap is
// (key > pk) XOR flip on both sides.  A thread keeps its partner's row
// iff the pair swaps.
__device__ __forceinline__ void exchange(const uint32_t* tile, int T,
                                         int num_keys, uint32_t& key,
                                         uint32_t& ix, uint32_t pk,
                                         uint32_t pi, bool upper, bool flip) {
  bool sw;
  if (key != pk)
    sw = (key > pk) != flip;
  else  // lower > upper on the later words, XOR desc
    sw = later_greater(tile, T, num_keys, upper ? pi : ix, upper ? ix : pi) !=
         (flip != upper);
  if (sw) {
    key = pk;
    ix = pi;
  }
}

// thread t's R indices to buf[t*R ..], two to a u32
template <int R>
__device__ __forceinline__ void put_idx(uint16_t* buf, int t,
                                        const uint32_t (&ix)[R]) {
  uint32_t* dst = reinterpret_cast<uint32_t*>(buf + t * R);
  if constexpr (R == 2) {
    *dst = ix[0] | (ix[1] << 16);
  } else if constexpr (R == 4) {
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(ix[0] | (ix[1] << 16), ix[2] | (ix[3] << 16));
  } else {
#pragma unroll
    for (int q = 0; q < R / 8; ++q)
      reinterpret_cast<uint4*>(dst)[q] = make_uint4(
          ix[8 * q] | (ix[8 * q + 1] << 16), ix[8 * q + 2] | (ix[8 * q + 3] << 16),
          ix[8 * q + 4] | (ix[8 * q + 5] << 16),
          ix[8 * q + 6] | (ix[8 * q + 7] << 16));
  }
}

template <int R>
__device__ __forceinline__ void get_idx(const uint16_t* buf, int t,
                                        uint32_t (&ix)[R]) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(buf + t * R);
  uint32_t w[R / 2];
  if constexpr (R == 2) {
    w[0] = *src;
  } else if constexpr (R == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(src);
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < R / 8; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(src)[q];
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  }
#pragma unroll
  for (int q = 0; q < R / 2; ++q) {
    ix[2 * q] = w[q] & 0xFFFFu;
    ix[2 * q + 1] = w[q] >> 16;
  }
}

template <int R>
__global__ void __launch_bounds__(MAX_THREADS)
key_index_tile_sort_kernel(uint32_t* planes, int64_t n, int num_ops,
                           int num_keys, int T) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tile = smem;  // plane j of the tile at tile[j * T]
  uint16_t* xbuf = reinterpret_cast<uint16_t*>(smem + (int64_t)num_ops * T);
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * T;

  // the planes, 16 B a load and LOADS_IN_FLIGHT loads a thread before
  // their stores: with one block a SM, the tile's load is not hidden
  // behind another block's work, so it needs the bytes in flight
  const int lq = __ffs(T) - 3;  // log2(T / 4)
  const int nvec = num_ops << lq;
  uint4* tile4 = reinterpret_cast<uint4*>(tile);
  for (int q0 = t; q0 < nvec; q0 += LOADS_IN_FLIGHT * blockDim.x) {
    uint4 v[LOADS_IN_FLIGHT];
#pragma unroll
    for (int u = 0; u < LOADS_IN_FLIGHT; ++u) {
      const int q = q0 + u * blockDim.x;
      if (q < nvec)
        v[u] = reinterpret_cast<const uint4*>(planes + (int64_t)(q >> lq) * n +
                                              base)[q & ((1 << lq) - 1)];
    }
#pragma unroll
    for (int u = 0; u < LOADS_IN_FLIGHT; ++u) {
      const int q = q0 + u * blockDim.x;
      if (q < nvec) tile4[q] = v[u];
    }
  }
  __syncthreads();

  uint32_t key[R], ix[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ix[r] = row_index(tile, T, num_keys, t * R + r);
    key[r] = tile[t * R + r];
  }
  const int64_t g0 = base + (int64_t)t * R;  // global row of position r = 0
  int cur = 0;                               // index buffer of the next stage

  for (int size = 2; size <= T; size <<= 1) {
    // desc of position r is bit `size` of g0 + r: the same for all R
    // positions when size >= R (g0 is a multiple of R), r & size below
    const bool dsz = (g0 & size) != 0;
    int stride = size >> 1;
    // strides >= 32R: partner thread t ^ m in another warp
    for (; stride >= 32 * R; stride >>= 1) {
      const int m = stride / R;
      uint16_t* buf = xbuf + cur * T;
      cur ^= 1;
      put_idx<R>(buf, t, ix);
      __syncthreads();
      uint32_t pix[R];
      get_idx<R>(buf, t ^ m, pix);
      const bool upper = (t & m) != 0;
#pragma unroll
      for (int r = 0; r < R; ++r)
        exchange(tile, T, num_keys, key[r], ix[r], tile[pix[r] & ROW], pix[r],
                 upper, upper != dsz);
    }
    // strides R .. 16R: partner lane t ^ m of the same warp
    for (; stride >= R; stride >>= 1) {
      const int m = stride / R;
      const bool upper = (t & m) != 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const uint32_t pk = __shfl_xor_sync(WARP, key[r], m);
        const uint32_t pi = __shfl_xor_sync(WARP, ix[r], m);
        exchange(tile, T, num_keys, key[r], ix[r], pk, pi, upper, upper != dsz);
      }
    }
    // strides < R: both rows in this thread's registers
#pragma unroll
    for (int s = R / 2; s > 0; s >>= 1) {
      if (s > stride) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r & s) continue;
        const bool desc = size >= R ? dsz : (r & size) != 0;
        const bool gt = key[r] != key[r + s]
                            ? key[r] > key[r + s]
                            : later_greater(tile, T, num_keys, ix[r], ix[r + s]);
        if (gt != desc) {
          const uint32_t k = key[r], i = ix[r];
          key[r] = key[r + s];
          ix[r] = ix[r + s];
          key[r + s] = k;
          ix[r + s] = i;
        }
      }
    }
  }

  // every plane stored through the final indices: a thread's R positions
  // are R consecutive u32 of a plane, written as 16 B vectors (the tile
  // in shared memory is still the input, so no barrier is needed)
  for (int j = 0; j < num_ops; ++j) {
    const uint32_t* src = tile + j * T;
    uint32_t* row = planes + (int64_t)j * n + g0;
    if constexpr (R == 2) {
      *reinterpret_cast<uint2*>(row) = make_uint2(src[ix[0] & ROW], src[ix[1] & ROW]);
    } else {
#pragma unroll
      for (int q = 0; q < R / 4; ++q)
        reinterpret_cast<uint4*>(row)[q] =
            make_uint4(src[ix[4 * q] & ROW], src[ix[4 * q + 1] & ROW],
                       src[ix[4 * q + 2] & ROW], src[ix[4 * q + 3] & ROW]);
    }
  }
}

template <int R>
int launch(void* planes, int64_t n, int num_ops, int num_keys, int T,
           int threads, int bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      key_index_tile_sort_kernel<R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  key_index_tile_sort_kernel<R><<<(unsigned)(n / T), threads, bytes,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(planes), n, num_ops, num_keys, T);
  return (int)cudaGetLastError();
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
  if (n <= 0) return (int)cudaSuccess;
  if (threads * R != T || threads < 32 || threads > MAX_THREADS ||
      threads % 32 ||
      (int64_t)bytes != (int64_t)num_ops * T * 4 + 4 * (int64_t)T)
    return (int)cudaErrorInvalidValue;
  if (R == 2) return launch<2>(planes, n, num_ops, num_keys, T, threads, bytes, stream);
  if (R == 4) return launch<4>(planes, n, num_ops, num_keys, T, threads, bytes, stream);
  if (R == 8) return launch<8>(planes, n, num_ops, num_keys, T, threads, bytes, stream);
  if (R == 16) return launch<16>(planes, n, num_ops, num_keys, T, threads, bytes, stream);
  return (int)cudaErrorInvalidValue;
}

// attrs[0..3] = registers a thread, local (spilled) bytes a thread, static
// shared bytes, most threads a block, of the kernel for R (2, 4, 8 or 16;
// cudaErrorInvalidValue for any other).
extern "C" int w2rap_bitonic_tile_sort_attrs(int R, int* attrs) {
  const void* fn = R == 2    ? (const void*)key_index_tile_sort_kernel<2>
                   : R == 4  ? (const void*)key_index_tile_sort_kernel<4>
                   : R == 8  ? (const void*)key_index_tile_sort_kernel<8>
                   : R == 16 ? (const void*)key_index_tile_sort_kernel<16>
                             : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, fn);
  if (err != cudaSuccess) return (int)err;
  attrs[0] = a.numRegs;
  attrs[1] = (int)a.localSizeBytes;
  attrs[2] = (int)a.sharedSizeBytes;
  attrs[3] = a.maxThreadsPerBlock;
  return (int)cudaSuccess;
}
