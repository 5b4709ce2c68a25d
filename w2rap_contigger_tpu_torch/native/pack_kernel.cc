// Host-side read packing for the device counting pipeline.
//
// The TPU upload path ships 2-bit packed bases plus a per-read usable
// prefix length (glen) instead of byte codes + quals: 4x fewer base
// bytes and no qual-plane upload at all.  numpy does this packing via
// ~2GB of shift/or temporaries (measured 2.1s for 131072x250 reads on
// this host — it was the single largest cost of the warm counting
// path); this kernel is a single memory-bound pass (~60ms).
//
// glen reproduces count_good_lengths (reference
// src/paths/long/BuildReadQGraph.cc:962-987): a read is truncated at
// the end of its RIGHTMOST window of k consecutive bases with
// qual >= min_qual; reads without such a window contribute nothing.

#include <cstdint>
#include <cstring>

extern "C" {

// bases: (n, L) row-major 2-bit codes in bytes; quals: (n, L) phred;
// lengths: (n,); packed_out: (n, Wr) u32 big-endian 2-bit groups of 16;
// glen_out: (n,).
void w2rap_pack_glen(const uint8_t* bases, const uint8_t* quals,
                     const int32_t* lengths, int64_t n, int64_t L,
                     int64_t Wr, int32_t k, int32_t min_qual,
                     uint32_t* packed_out, int32_t* glen_out) {
    for (int64_t r = 0; r < n; ++r) {
        const uint8_t* b = bases + r * L;
        uint32_t* out = packed_out + r * Wr;
        int64_t full = L / 16;
        for (int64_t w = 0; w < full; ++w) {
            const uint8_t* p = b + w * 16;
            uint32_t acc = 0;
            for (int j = 0; j < 16; ++j)
                acc |= (uint32_t)(p[j] & 3) << (30 - 2 * j);
            out[w] = acc;
        }
        for (int64_t w = full; w < Wr; ++w) {
            uint32_t acc = 0;
            for (int j = 0; j < 16; ++j) {
                int64_t pos = w * 16 + j;
                if (pos < L) acc |= (uint32_t)(b[pos] & 3) << (30 - 2 * j);
            }
            out[w] = acc;
        }
        // rightmost k-run of good bases (backward scan, O(L))
        const uint8_t* q = quals + r * L;
        int64_t len = lengths[r];
        if (len > L) len = L;
        int32_t g = 0;
        int64_t next_bad = len;  // first bad index >= i
        for (int64_t i = len - 1; i >= 0; --i) {
            if (q[i] < min_qual) next_bad = i;
            else if (next_bad - i >= k) { g = (int32_t)(i + k); break; }
        }
        glen_out[r] = g;
    }
}

}  // extern "C"
