// Native (host) leaf counting for the CPU backend.
//
// The CPU-parity pipeline spent most of its step-2/3 wall inside XLA's
// CPU lax.sort (multi-operand merge sort at ~5 Mrows/s on this
// machine).  This kernel replaces one leaf of the counting tree —
// kmerize + canonicalize + sort + collapse for a chunk of reads (or a
// flat sequence pool) — with a single C++ pass: rolling multiword
// fwd/rc window, canonical min, index sort with word-wise unsigned
// lexicographic compare, then linear collapse (count saturates at 255,
// contexts OR).  Semantics mirror ops/kmer_engine.kmerize_chunk +
// sort_collapse_leaf exactly (word layout: big-endian 2-bit groups of
// 16 per u32, pad bits zero; reference semantics:
// BuildReadQGraph.cc:962-1110).
//
// This is an original implementation; the reference's equivalents
// (KMer<K>/KMerNodeFreq + std::sort) were not consulted line-wise.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
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
    uint32_t range_mask_bits;  // 0 = no range filter
    uint32_t range_index;

    inline void emit(const uint32_t* fwd, const uint32_t* rc, uint8_t cbyte) {
        const uint32_t* canon = canonical_ctx(fwd, rc, W, cbyte);
        if (range_mask_bits) {
            if ((canon[0] >> (32 - range_mask_bits)) != range_index) return;
        }
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
// bits [dshift, dshift+16) of word 0 counted from the LSB end, i.e. the
// highest-entropy bits below any constant range prefix), then each
// bucket — cache-resident at typical sizes — is copied to scratch,
// index-sorted, and collapsed.  Replaces a whole-array index sort whose
// comparator chased pointers across the full working set (~5x wall at
// north-star range sizes).
static int64_t sort_collapse(std::vector<uint32_t>& words,
                             std::vector<uint8_t>& ctx, int W,
                             uint32_t* out_words, uint8_t* out_ctx,
                             uint8_t* out_cnt, int range_bits = 0) {
    const int64_t n = (int64_t)ctx.size();
    if (n == 0) return 0;
    const uint32_t* wp = words.data();
    int dshift = 32 - range_bits - 16;
    if (dshift < 0) dshift = 0;
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

static int32_t good_len(const uint8_t* q, int64_t len, int k,
                        int min_qual) {
    int64_t next_bad = len;
    for (int64_t i = len - 1; i >= 0; --i) {
        if (q[i] < min_qual) next_bad = i;
        else if (next_bad - i >= k) return (int32_t)(i + k);
    }
    return 0;
}

}  // namespace

extern "C" {

// Leaf count over reads: kmerize (qual-gated) + canonicalize + sort +
// collapse.  out_* must hold n*(L-k+1) rows; returns unique row count.
int64_t w2rap_count_leaf(const uint8_t* bases, const uint8_t* quals,
                         const int32_t* lengths, int64_t n, int64_t L,
                         int32_t k, int32_t W, int32_t min_qual,
                         int32_t range_bits, uint32_t range_index,
                         uint32_t* out_words, uint8_t* out_ctx,
                         uint8_t* out_cnt) {
    std::vector<uint32_t> words;
    std::vector<uint8_t> ctx;
    words.reserve((size_t)n * (L - k + 1) * W / 4);
    ctx.reserve((size_t)n * (L - k + 1) / 4);
    Emit em{words, ctx, W, k, (uint32_t)range_bits, range_index};
    for (int64_t r = 0; r < n; ++r) {
        int64_t len = lengths[r];
        if (len > L) len = L;
        int32_t glen = good_len(quals + r * L, len, k, min_qual);
        if (glen <= k) continue;  // reference: only glen > k emits
        roll_segment(bases + r * L, 0, glen, 0, glen, k, em);
    }
    return sort_collapse(words, ctx, W, out_words, out_ctx, out_cnt,
                         range_bits);
}

// Disk-batched counting, pass 1 (the createDictOMPDiskBased analogue,
// reference BuildReadQGraph.cc:1120-1250): kmerize ONCE and append
// (W u32 words + ctx byte) rows to 2^range_bits per-range batch files
// "<tmp_dir>/kmer_batch_NNNN.bin" (range = top bits of word 0).
// nthreads workers kmerize disjoint read slices into per-thread
// per-range buffers flushed under a per-range file mutex — row order
// within a file is thread-interleaved, which the full per-range sort in
// pass 2 erases (dict bit-identical to single-thread; counts saturate
// and contexts OR, both order-free).  Returns 0 on success, -1 on IO
// failure.  Row counts per range are written to range_counts.
int64_t w2rap_spill_ranges(const uint8_t* bases, const uint8_t* quals,
                           const int32_t* lengths, int64_t n, int64_t L,
                           int32_t k, int32_t W, int32_t min_qual,
                           int32_t range_bits, const char* tmp_dir,
                           int64_t* range_counts, int32_t nthreads) {
    const int R = 1 << range_bits;
    std::vector<FILE*> files(R, nullptr);
    std::vector<std::mutex> fmtx(R);
    for (int r = 0; r < R; ++r) {
        char buf[64];
        snprintf(buf, sizeof buf, "/kmer_batch_%04d.bin", r);
        std::string name = std::string(tmp_dir) + buf;
        files[r] = fopen(name.c_str(), "wb");
        if (!files[r]) {
            for (int j = 0; j < r; ++j) fclose(files[j]);
            return -1;
        }
        range_counts[r] = 0;
    }
    if (nthreads < 1) nthreads = 1;
    const int T = nthreads;
    // per-(thread, range) buffer budget ~64MB total, floor 32KB each
    size_t bufsz = (size_t)64 << 20;
    bufsz /= (size_t)R * T;
    if (bufsz < (size_t)32 << 10) bufsz = (size_t)32 << 10;
    const size_t rowbytes = (size_t)W * 4 + 1;

    struct SpillEmit {
        std::vector<FILE*>* files;
        std::vector<std::mutex>* fmtx;
        std::vector<std::vector<uint8_t>> bufs;  // per range
        std::vector<int64_t> counts;             // per range
        int W, k, shift;
        size_t bufcap, rowbytes;
        bool fail = false;

        void flush(int r) {
            auto& b = bufs[r];
            if (b.empty()) return;
            std::lock_guard<std::mutex> g((*fmtx)[r]);
            if (fwrite(b.data(), 1, b.size(), (*files)[r]) != b.size())
                fail = true;
            b.clear();
        }
        inline void emit(const uint32_t* fwd, const uint32_t* rc,
                         uint8_t cbyte) {
            const uint32_t* canon = canonical_ctx(fwd, rc, W, cbyte);
            int r = (int)(canon[0] >> shift);
            auto& b = bufs[r];
            const uint8_t* p = (const uint8_t*)canon;
            b.insert(b.end(), p, p + (size_t)W * 4);
            b.push_back(cbyte);
            counts[r]++;
            if (b.size() + rowbytes > bufcap) flush(r);
        }
    };

    std::vector<SpillEmit> emits(T);
    for (int t = 0; t < T; ++t) {
        emits[t].files = &files;
        emits[t].fmtx = &fmtx;
        emits[t].bufs.resize(R);
        emits[t].counts.assign(R, 0);
        emits[t].W = W;
        emits[t].k = k;
        emits[t].shift = 32 - range_bits;
        emits[t].bufcap = bufsz;
        emits[t].rowbytes = rowbytes;
    }
    auto work = [&](int t) {
        SpillEmit& sp = emits[t];
        const int64_t lo = n * t / T, hi = n * (t + 1) / T;
        for (int64_t r = lo; r < hi; ++r) {
            int64_t len = lengths[r];
            if (len > L) len = L;
            int32_t glen = good_len(quals + r * L, len, k, min_qual);
            if (glen <= k) continue;
            roll_segment(bases + r * L, 0, glen, 0, glen, k, sp);
        }
        for (int r = 0; r < R; ++r) sp.flush(r);
    };
    if (T == 1) {
        work(0);
    } else {
        std::vector<std::thread> th;
        for (int t = 0; t < T; ++t) th.emplace_back(work, t);
        for (auto& x : th) x.join();
    }
    bool fail = false;
    for (int t = 0; t < T; ++t) {
        if (emits[t].fail) fail = true;
        for (int r = 0; r < R; ++r) range_counts[r] += emits[t].counts[r];
    }
    int rc_all = 0;
    for (int r = 0; r < R; ++r)
        if (fclose(files[r]) != 0) rc_all = -1;
    return (fail || rc_all) ? -1 : 0;
}

// Disk-batched counting, pass 2: read one range's batch file (one bulk
// fread), sort + collapse.  out_* must hold n_rows rows; returns unique
// count (or -1 on IO failure).
int64_t w2rap_collapse_batch(const char* path, int64_t n_rows, int32_t W,
                             uint32_t* out_words, uint8_t* out_ctx,
                             uint8_t* out_cnt, int32_t range_bits) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    const size_t rowbytes = (size_t)W * 4 + 1;
    std::vector<uint8_t> raw((size_t)n_rows * rowbytes);
    if (n_rows && fread(raw.data(), 1, raw.size(), f) != raw.size()) {
        fclose(f);
        return -1;
    }
    fclose(f);
    std::vector<uint32_t> words((size_t)n_rows * W);
    std::vector<uint8_t> ctx((size_t)n_rows);
    for (int64_t i = 0; i < n_rows; ++i) {
        std::memcpy(words.data() + i * W, raw.data() + i * rowbytes,
                    (size_t)W * 4);
        ctx[i] = raw[i * rowbytes + W * 4];
    }
    raw.clear();
    raw.shrink_to_fit();
    return sort_collapse(words, ctx, W, out_words, out_ctx, out_cnt,
                         range_bits);
}

// Leaf count over a flat sequence pool with segment boundaries
// (step 3's BigK analogue): positions [seg[i], seg[i+1]) per segment.
int64_t w2rap_count_leaf_flat(const uint8_t* flat, const int64_t* seg,
                              int64_t n_seg, int32_t k, int32_t W,
                              uint32_t* out_words, uint8_t* out_ctx,
                              uint8_t* out_cnt) {
    std::vector<uint32_t> words;
    std::vector<uint8_t> ctx;
    Emit em{words, ctx, W, k, 0, 0};
    for (int64_t s = 0; s < n_seg; ++s) {
        int64_t a = seg[s], b = seg[s + 1];
        if (b - a >= k) roll_segment(flat, a, b, a, b, k, em);
    }
    return sort_collapse(words, ctx, W, out_words, out_ctx, out_cnt);
}

}  // extern "C"
