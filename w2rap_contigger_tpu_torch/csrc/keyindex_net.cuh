// The key-index network shared by K3a, K3b and K4a (Hopper, sm_90a).
//
// The canonical bitonic network on a tile of T rows: at level `size` and
// stride s, the pair (i, i+s) with i & s == 0 swaps iff (row i > row i+s)
// XOR ((p + i) & size) != 0, rows compared on their first nwords u32
// words, unsigned, p the position the direction is taken from (the
// tile's global row for K3; 0 for K4a, whose every tile ends ascending).
// A tile sort runs levels 2..T, strides size/2..1; a merge level (K3b)
// one level size > T, strides T/2..1, one direction for the whole tile.
// Only the comparisons decide the network, so only keys and indices move:
//
// * The tile's planes are loaded once into shared memory, 16 B vectors
//   from device memory, LOADS_IN_FLIGHT a thread (one block fills a SM,
//   so nothing hides a tile's load but the bytes in flight), rows at
//   swizzled places (swz), and stay read-only.
// * Thread t holds positions t*R .. t*R + R-1 in registers as (16-bit
//   tile row, the row's first word).  Strides below R run in registers,
//   R .. 16R between the lanes of a warp (__shfl_xor_sync), >= 32R by an
//   exchange of indices through shared memory (thread t reads thread
//   t ^ (s/R)'s R indices and re-reads their first words from the tile;
//   two index buffers, so one __syncthreads a stage).
// * A tie on the first word reads words 1..nwords-1 through the indices
//   (inline: at 54 registers, the call's overhead cost more than the
//   code it saves).  Bit 15 of an index flags a row all ones in its nwords
//   words, so two such rows are settled without a read: equal under K3's
//   tie rule (the padding is 22-45% of the rows on the main path),
//   ordered by tile row under K4a's.  Both threads of a pair compare the
//   lower row against the upper one, so they agree.
// * The caller then writes the tile through the final indices, each
//   thread its R consecutive positions as 16 B vectors.
//
// No register array is indexed by the plane count, so any key width (up
// to W = 40 at K = 640) runs without spilling.  Shared memory: nplanes *
// T * 4 bytes of tile + 4 * T bytes of indices; R is the least of 2, 4,
// 8, 16 that keeps T / R <= 1024 threads (ops/bitonic.py tile_geometry).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NET_THREADS = 1024;   // the most threads a block
constexpr int LOADS_IN_FLIGHT = 8;  // 16 B loads a thread issues before storing
constexpr unsigned WARP = 0xFFFFFFFFu;
constexpr uint32_t SENT = 0x8000u;  // index bit 15: all ones in the nwords words
constexpr uint32_t ROW = 0x7FFFu;   // index bits 0..14: the tile row (T <= 16384)

// Where tile offset k (plane j's row i at j * T + i) lives in shared
// memory.  Thread t's positions are the R consecutive rows t*R .. t*R +
// R-1, so while the indices are still near their start (a tile already
// in order, as in late merge levels) the lanes of a warp reading their
// r-th row would hit 32 / R banks; XOR-ing bits 5.. into the low bits
// spreads them over all 32.  A bijection on every 32-row block, and
// swz(j * T + i) = j * T + swz(i), since T >= 32R.  At R = 2 (2-way) the
// XOR costs more than it saves, and the layout stays plain.
template <int R>
__device__ __forceinline__ int swz(int k) {
  if constexpr (R == 2)
    return k;
  else
    return k ^ ((k >> 5) & (R - 1));
}

// row a > row b on words 1..nwords-1 (word 0 tied).  Two flagged rows,
// and rows equal on every word, are equal (K3: BY_ROW false) or ordered
// by tile row (K4a: BY_ROW true, which makes every row unique).
template <int R, bool BY_ROW>
__device__ __forceinline__ bool later_greater(const uint32_t* tile, int T,
                                           int nwords, uint32_t a,
                                           uint32_t b) {
  if (!(a & b & SENT)) {
    const int ra = a & ROW, rb = b & ROW;
    for (int j = 1; j < nwords; ++j) {
      const uint32_t x = tile[swz<R>(j * T + ra)], y = tile[swz<R>(j * T + rb)];
      if (x != y) return x > y;
    }
  }
  return BY_ROW && (a & ROW) > (b & ROW);
}

// The tile as the network sees it: its words, and the comparator.
template <int R, bool BY_ROW>
struct Net {
  const uint32_t* tile;
  int T;
  int nwords;
  // word j of the row at index a (SENT ignored)
  __device__ __forceinline__ uint32_t word(int j, uint32_t a) const {
    return tile[swz<R>(j * T + (int)(a & ROW))];
  }
  __device__ __forceinline__ bool greater(uint32_t a, uint32_t b) const {
    return later_greater<R, BY_ROW>(tile, T, nwords, a, b);
  }
};

// planes [0, nplanes) of rows base .. base + T-1 (planes of n rows, 16 B
// aligned) into tile at their swizzled places; no barrier
template <int R>
__device__ __forceinline__ void load_tile(const uint32_t* planes, int64_t n,
                                          int64_t base, int nplanes, int T,
                                          uint32_t* tile) {
  const int lq = __ffs(T) - 3;  // log2(T / 4)
  const int nvec = nplanes << lq;
  for (int q0 = threadIdx.x; q0 < nvec; q0 += LOADS_IN_FLIGHT * blockDim.x) {
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
      const int k = 4 * (q0 + u * blockDim.x);  // tile offset of v[u].x
      if (k >= 4 * nvec) continue;
      if constexpr (R == 2) {
        reinterpret_cast<uint4*>(tile)[k / 4] = v[u];
      } else {
        tile[swz<R>(k)] = v[u].x;
        tile[swz<R>(k + 1)] = v[u].y;
        tile[swz<R>(k + 2)] = v[u].z;
        tile[swz<R>(k + 3)] = v[u].w;
      }
    }
  }
}

// thread t's R positions as (index with SENT, first word)
template <int R, class Cmp>
__device__ __forceinline__ void net_init(const Cmp& cmp, uint32_t (&key)[R],
                                         uint32_t (&ix)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint32_t i = threadIdx.x * R + r;
    ix[r] = i | SENT;
    for (int j = 0; j < cmp.nwords; ++j)
      if (cmp.word(j, i) != 0xFFFFFFFFu) {
        ix[r] = i;
        break;
      }
    key[r] = cmp.word(0, i);
  }
}

// one side of a compare-exchange across threads: this thread's (key, ix)
// against its partner's (pk, pi).  The pair swaps iff (lower row > upper
// row) XOR desc; with flip = upper XOR desc (upper: this thread holds the
// upper position) that is (key > pk) XOR flip when the first words differ.
template <class Cmp>
__device__ __forceinline__ void exchange(const Cmp& cmp, uint32_t& key,
                                         uint32_t& ix, uint32_t pk,
                                         uint32_t pi, bool upper, bool flip) {
  bool sw;
  if (key != pk)
    sw = (key > pk) != flip;
  else  // lower > upper on the later words, XOR desc
    sw = cmp.greater(upper ? pi : ix, upper ? ix : pi) != (flip != upper);
  if (sw) {
    key = pk;
    ix = pi;
  }
}

// N consecutive u32 at p (aligned to their size, up to 16 B), word i =
// f(i), as the widest vectors they fill: one u32, one uint2 or N/4 uint4
template <int N, class F>
__device__ __forceinline__ void store_words(uint32_t* p, F f) {
  if constexpr (N == 1) {
    *p = f(0);
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(f(0), f(1));
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<uint4*>(p)[q] =
          make_uint4(f(4 * q), f(4 * q + 1), f(4 * q + 2), f(4 * q + 3));
  }
}

// the same N words read back: f(i, word i)
template <int N, class F>
__device__ __forceinline__ void load_words(const uint32_t* p, F f) {
  if constexpr (N == 1) {
    f(0, *p);
  } else if constexpr (N == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    f(0, v.x);
    f(1, v.y);
  } else {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[q];
      f(4 * q, v.x);
      f(4 * q + 1, v.y);
      f(4 * q + 2, v.z);
      f(4 * q + 3, v.w);
    }
  }
}

// thread t's R indices to buf[t*R ..] and back, two to a u32
template <int R>
__device__ __forceinline__ void put_idx(uint16_t* buf, int t,
                                        const uint32_t (&ix)[R]) {
  store_words<R / 2>(reinterpret_cast<uint32_t*>(buf + t * R),
                     [&](int q) { return ix[2 * q] | (ix[2 * q + 1] << 16); });
}

template <int R>
__device__ __forceinline__ void get_idx(const uint16_t* buf, int t,
                                        uint32_t (&ix)[R]) {
  load_words<R / 2>(reinterpret_cast<const uint32_t*>(buf + t * R),
                    [&](int q, uint32_t w) {
                      ix[2 * q] = w & 0xFFFFu;
                      ix[2 * q + 1] = w >> 16;
                    });
}

// One level `size` of the network, strides `stride`, stride/2, ..., 1,
// on thread t's R positions.  g0: the position whose bits give the
// direction of r = 0 (a multiple of R).  cur: the index buffer of the
// next shared stage (xbuf[0, T) or xbuf[T, 2T)).
template <int R, class Cmp>
__device__ __forceinline__ void net_level(const Cmp& cmp, uint16_t* xbuf,
                                          int& cur, uint32_t (&key)[R],
                                          uint32_t (&ix)[R], int64_t g0,
                                          int64_t size, int stride) {
  const int t = threadIdx.x;
  const int T = cmp.T;
  // desc of position r is bit `size` of g0 + r: the same for all R
  // positions when size >= R, r & size below
  const bool dsz = (g0 & size) != 0;
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
      exchange(cmp, key[r], ix[r], cmp.word(0, pix[r]), pix[r], upper,
               upper != dsz);
  }
  // strides R .. 16R: partner lane t ^ m of the same warp
  for (; stride >= R; stride >>= 1) {
    const int m = stride / R;
    const bool upper = (t & m) != 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint32_t pk = __shfl_xor_sync(WARP, key[r], m);
      const uint32_t pi = __shfl_xor_sync(WARP, ix[r], m);
      exchange(cmp, key[r], ix[r], pk, pi, upper, upper != dsz);
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
      const bool gt = key[r] != key[r + s] ? key[r] > key[r + s]
                                           : cmp.greater(ix[r], ix[r + s]);
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

// The network on a tile loaded into shared memory: MERGE false, the
// levels 2..T (a tile sort); MERGE true, the one level `size` > T.
template <int R, bool MERGE, class Cmp>
__device__ __forceinline__ void net_run(const Cmp& cmp, uint16_t* xbuf,
                                        uint32_t (&key)[R], uint32_t (&ix)[R],
                                        int64_t g0, int64_t size) {
  int cur = 0;
  if constexpr (MERGE) {
    net_level<R>(cmp, xbuf, cur, key, ix, g0, size, cmp.T >> 1);
  } else {
    for (int sz = 2; sz <= cmp.T; sz <<= 1)
      net_level<R>(cmp, xbuf, cur, key, ix, g0, sz, sz >> 1);
  }
}

// K3a (MERGE false) and K3b (MERGE true, level `size`) on tile
// blockIdx.x of (num_ops, n) planes, in place: every plane loaded, the
// network on the first num_keys words, every plane stored once through
// the final indices (the tile in shared memory is still the input, so
// the store needs no barrier).
template <int R, bool MERGE>
__device__ __forceinline__ void sort_planes_tile(uint32_t* planes, int64_t n,
                                                 int num_ops, int num_keys,
                                                 int T, int64_t size) {
  extern __shared__ __align__(16) uint32_t net_smem[];
  uint32_t* tile = net_smem;
  uint16_t* xbuf = reinterpret_cast<uint16_t*>(net_smem + (int64_t)num_ops * T);
  const int64_t g0 = (int64_t)blockIdx.x * T + (int64_t)threadIdx.x * R;
  load_tile<R>(planes, n, (int64_t)blockIdx.x * T, num_ops, T, tile);
  __syncthreads();
  const Net<R, false> net{tile, T, num_keys};
  uint32_t key[R], ix[R];
  net_init<R>(net, key, ix);
  net_run<R, MERGE>(net, xbuf, key, ix, g0, size);
  for (int j = 0; j < num_ops; ++j)
    store_words<R>(planes + (int64_t)j * n + g0,
                   [&](int r) { return net.word(j, ix[r]); });
}

// Launch a network kernel (fn: its instance for R, or nullptr) on n / T
// blocks of `threads`, with `bytes` of dynamic shared memory, which must
// equal want_bytes; args are the kernel's parameters, of its exact
// types.  Returns cudaGetLastError(), or cudaErrorInvalidValue for a
// geometry the network does not take.
template <class... A>
int net_launch(const void* fn, int64_t n, int T, int R, int threads, int bytes,
               int64_t want_bytes, void* stream, A... args) {
  if (n <= 0) return (int)cudaSuccess;
  if (fn == nullptr || threads * R != T || threads < 32 ||
      threads > NET_THREADS || threads % 32 || n % T ||
      (int64_t)bytes != want_bytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  void* argv[] = {&args...};
  err = cudaLaunchKernel(fn, dim3((unsigned)(n / T)), dim3(threads), argv,
                         (size_t)bytes, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// attrs[0..3] = registers a thread, local (spilled) bytes a thread, static
// shared bytes, most threads a block of fn (cudaErrorInvalidValue for
// nullptr: an R the kernel has no instance for).
int net_attrs(const void* fn, int* attrs) {
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

}  // namespace
