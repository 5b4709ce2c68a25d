// Native (host) leaf counting: step 5's blob-local counts
// (ops/kmer_engine.count_kmers_flat(host=True)).
//
// Counts a flat sequence pool with segment boundaries in a single C++
// pass — kmerize + canonicalize + sort + collapse: rolling multiword
// fwd/rc window, canonical min, index sort with word-wise unsigned
// lexicographic compare, then linear collapse (count saturates at 255,
// contexts OR).  Blob pools are a few thousand kmers, where a device
// round trip per op would cost more than the work.  Word layout:
// big-endian 2-bit groups of 16 per u32, pad bits zero; reference
// semantics: BuildReadQGraph.cc:962-1110.
//
// This is an original implementation; the reference's equivalents
// (KMer<K>/KMerNodeFreq + std::sort) were not consulted line-wise.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// canonical = lexicographic min(fwd, rc); context swaps to the rc
// form when the rc strand wins.  Returns the canonical word pointer.
static inline const uint32_t* canonical_ctx(const uint32_t* fwd,
                                            const uint32_t* rc, int W,
                                            uint8_t& cbyte) {
    const uint32_t* canon = fwd;
    bool is_rev = false;
    for (int j = 0; j < W; ++j) {
        if (fwd[j] < rc[j]) break;
        if (fwd[j] > rc[j]) { canon = rc; is_rev = true; break; }
    }
    if (is_rev) {
        uint8_t pred = cbyte >> 4, succ = cbyte & 0xF;
        auto rcb = [](uint8_t b) -> uint8_t {
            return (uint8_t)(((b & 1) << 3) | ((b & 2) << 1) |
                             ((b & 4) >> 1) | ((b & 8) >> 3));
        };
        cbyte = (uint8_t)((rcb(succ) << 4) | rcb(pred));
    }
    return canon;
}

struct Emit {
    std::vector<uint32_t>& words;  // rows * W
    std::vector<uint8_t>& ctx;
    int W;
    int k;

    inline void emit(const uint32_t* fwd, const uint32_t* rc, uint8_t cbyte) {
        const uint32_t* canon = canonical_ctx(fwd, rc, W, cbyte);
        words.insert(words.end(), canon, canon + W);
        ctx.push_back(cbyte);
    }
};

// Rolling multiword window over codes[p0, p1); emits every kmer with
// its context byte.  pred exists for p > ctx_lo, succ for p + k < ctx_hi.
template <typename E>
static void roll_segment(const uint8_t* codes, int64_t p0, int64_t p1,
                         int64_t ctx_lo, int64_t ctx_hi, int k, E& em) {
    if (p1 - p0 < k) return;
    const int W = em.W;
    std::vector<uint32_t> fwd(W, 0), rc(W, 0);
    // pad control for the last fwd word (bits below base k-1 stay 0)
    const int pad = 2 * (16 * W - k);
    // initial window [p0, p0+k)
    for (int i = 0; i < k; ++i) {
        uint32_t b = codes[p0 + i] & 3;
        fwd[i >> 4] |= b << (30 - 2 * (i & 15));
        uint32_t cb = 3 - b;  // complement
        int ri = k - 1 - i;   // reversed position
        rc[ri >> 4] |= cb << (30 - 2 * (ri & 15));
    }
    for (int64_t p = p0;; ++p) {
        uint8_t cbyte = 0;
        if (p > ctx_lo) cbyte |= (uint8_t)(1u << (codes[p - 1] & 3)) << 4;
        if (p + k < ctx_hi) cbyte |= (uint8_t)(1u << (codes[p + k] & 3));
        em.emit(fwd.data(), rc.data(), cbyte);
        if (p + k >= p1) break;
        uint32_t nb = codes[p + k] & 3;
        // fwd: shift left 2 across words, insert nb at position k-1
        for (int j = 0; j < W - 1; ++j)
            fwd[j] = (fwd[j] << 2) | (fwd[j + 1] >> 30);
        fwd[W - 1] <<= 2;
        int li = k - 1;
        fwd[li >> 4] |= nb << (30 - 2 * (li & 15));
        if (pad) fwd[W - 1] &= (0xFFFFFFFFu >> pad) << pad;
        // rc: shift right 2 across words, insert complement at pos 0
        for (int j = W - 1; j > 0; --j)
            rc[j] = (rc[j] >> 2) | (rc[j - 1] << 30);
        rc[0] = (rc[0] >> 2) | ((3 - nb) << 30);
        if (pad) rc[W - 1] &= (0xFFFFFFFFu >> pad) << pad;
    }
}

// Sort + collapse W-word rows.  One 16-bit MSD bucket scatter (digit =
// the top 16 bits of word 0), then each
// bucket — cache-resident at typical sizes — is copied to scratch,
// index-sorted, and collapsed.  Replaces a whole-array index sort whose
// comparator chased pointers across the full working set (~5x wall at
// north-star range sizes).
static int64_t sort_collapse(std::vector<uint32_t>& words,
                             std::vector<uint8_t>& ctx, int W,
                             uint32_t* out_words, uint8_t* out_ctx,
                             uint8_t* out_cnt) {
    const int64_t n = (int64_t)ctx.size();
    if (n == 0) return 0;
    const uint32_t* wp = words.data();
    const int dshift = 16;
    const int NB = 1 << 16;
    std::vector<int64_t> offs(NB + 1, 0);
    for (int64_t i = 0; i < n; ++i)
        offs[((wp[i * W] >> dshift) & 0xFFFFu) + 1]++;
    for (int b = 0; b < NB; ++b) offs[b + 1] += offs[b];
    // scatter rows into the caller's output buffers (n rows capacity)
    {
        std::vector<int64_t> cur(offs.begin(), offs.end() - 1);
        for (int64_t i = 0; i < n; ++i) {
            int64_t d = cur[(wp[i * W] >> dshift) & 0xFFFFu]++;
            std::memcpy(out_words + d * W, wp + i * W, (size_t)W * 4);
            out_ctx[d] = ctx[i];
        }
    }
    std::vector<uint32_t> sw;
    std::vector<uint8_t> sx;
    std::vector<int32_t> idx;
    int64_t m = -1;
    const uint32_t* prev = nullptr;
    for (int b = 0; b < NB; ++b) {
        const int64_t s = offs[b], e = offs[b + 1];
        const int64_t bn = e - s;
        if (bn == 0) continue;
        sw.assign(out_words + s * W, out_words + e * W);
        sx.assign(out_ctx + s, out_ctx + e);
        idx.resize(bn);
        for (int64_t i = 0; i < bn; ++i) idx[i] = (int32_t)i;
        const uint32_t* bw = sw.data();
        std::sort(idx.begin(), idx.end(), [bw, W](int32_t a, int32_t c) {
            const uint32_t* ra = bw + (int64_t)a * W;
            const uint32_t* rb = bw + (int64_t)c * W;
            for (int j = 0; j < W; ++j)
                if (ra[j] != rb[j]) return ra[j] < rb[j];
            return false;
        });
        for (int64_t t = 0; t < bn; ++t) {
            const uint32_t* r = bw + (int64_t)idx[t] * W;
            if (prev && std::memcmp(prev, r, (size_t)W * 4) == 0) {
                if (out_cnt[m] < 255) out_cnt[m]++;
                out_ctx[m] |= sx[idx[t]];
            } else {
                ++m;
                std::memcpy(out_words + m * W, r, (size_t)W * 4);
                out_cnt[m] = 1;
                out_ctx[m] = sx[idx[t]];
                prev = out_words + m * W;
            }
        }
    }
    return m + 1;
}

}  // namespace

extern "C" {

// Leaf count over a flat sequence pool with segment boundaries
// (step 3's BigK analogue): positions [seg[i], seg[i+1]) per segment.
int64_t w2rap_count_leaf_flat(const uint8_t* flat, const int64_t* seg,
                              int64_t n_seg, int32_t k, int32_t W,
                              uint32_t* out_words, uint8_t* out_ctx,
                              uint8_t* out_cnt) {
    std::vector<uint32_t> words;
    std::vector<uint8_t> ctx;
    Emit em{words, ctx, W, k};
    for (int64_t s = 0; s < n_seg; ++s) {
        int64_t a = seg[s], b = seg[s + 1];
        if (b - a >= k) roll_segment(flat, a, b, a, b, k, em);
    }
    return sort_collapse(words, ctx, W, out_words, out_ctx, out_cnt);
}

}  // extern "C"
