// Records of the partition sort (K4a-d), shared by radix.cu and
// region_merge.cu.
//
// A record is (hi, lo, idx): hi = w0 << 32 | w1 and lo = w2 << 32 | w3
// over the first cmp_keys (<= 4) key words of a row (missing words 0),
// and idx the row's index in the input.  Records compare lexicographically
// on (hi, lo, idx), unsigned.  A fill record is (~0, ~0, ~0): the largest
// record, since no row has the index ~0.

#pragma once

#include <cstdint>

namespace {

constexpr uint32_t FULL = 0xFFFFFFFFu;
constexpr uint64_t MAX64 = ~0ull;
constexpr uint32_t FILL_IDX = 0xFFFFFFFFu;
constexpr int RECORD_BYTES = 8 + 8 + 4;  // hi, lo, idx (ops/radix.py too)

__device__ __forceinline__ bool rec_less(uint64_t ah, uint64_t al, uint32_t ai,
                                         uint64_t bh, uint64_t bl,
                                         uint32_t bi) {
  if (ah != bh) return ah < bh;
  if (al != bl) return al < bl;
  return ai < bi;
}

// Gather one output row of every plane through a record's idx (fill
// records become all ones in key planes and 0 in payload planes).
__device__ __forceinline__ void write_row(const uint32_t* __restrict__ planes,
                                          int64_t n, int num_ops, int num_keys,
                                          uint32_t* __restrict__ out,
                                          int64_t total, int64_t dst,
                                          uint32_t idx) {
  for (int j = 0; j < num_ops; ++j)
    out[j * total + dst] = idx != FILL_IDX ? planes[j * n + (int64_t)idx]
                                           : (j < num_keys ? FULL : 0u);
}

}  // namespace
