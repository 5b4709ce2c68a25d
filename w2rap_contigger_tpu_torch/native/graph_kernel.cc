// Native (host) graph-construction lookups for the CPU backend.
//
// After counting and pathing went native, the CPU-parity wall moved to
// the dictionary-lookup storms of graph construction: adjacency
// pruning (8 neighbor searches per kmer — AdjProc,
// kmers/ReadPather.h:307-342) and unitig link building
// (upstream/downstreamExtensionPossible, BuildReadQGraph.cc:195-221),
// which ran as XLA programs over the quantum-padded table.  This
// kernel performs both with a 16-bit-prefix-accelerated binary search
// over the unpadded sorted table, threaded over rows.  Semantics
// mirror ops/bitkmer + graph/build._links_core exactly, so results are
// bit-identical to the device path (asserted in tests).
//
// This is an original implementation; the reference's equivalents were
// not consulted line-wise.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// The largest kmer this leaf holds: W = 40 words, k = 640 (the largest
// allowed -K).  Every stack array below has this size, and each entry
// refuses a larger W (returns -1) before it touches a row.
constexpr int MAX_W = 40;

static inline uint32_t revpair32(uint32_t x) {
    const uint32_t M2 = 0x33333333u, M4 = 0x0F0F0F0Fu, M8 = 0x00FF00FFu;
    x = ((x & M2) << 2) | ((x >> 2) & M2);
    x = ((x & M4) << 4) | ((x >> 4) & M4);
    x = ((x & M8) << 8) | ((x >> 8) & M8);
    x = (x << 16) | (x >> 16);
    return x;
}

// rc_words (ops/bitkmer.py:47): complement + reverse 2-bit groups
// across the whole string, then re-align to the top (pad bits low).
static inline void rc_words(const uint32_t* w, int W, int k,
                            uint32_t* out) {
    uint32_t rev[MAX_W];
    for (int j = 0; j < W; ++j) rev[j] = revpair32(~w[W - 1 - j]);
    int s = 2 * (16 * W - k);
    if (s == 0) {
        std::memcpy(out, rev, W * 4);
        return;
    }
    for (int j = 0; j < W - 1; ++j)
        out[j] = (rev[j] << s) | (rev[j + 1] >> (32 - s));
    out[W - 1] = rev[W - 1] << s;
}

static inline void to_successor(const uint32_t* w, int W, int k,
                                uint32_t code, uint32_t* out) {
    for (int j = 0; j < W - 1; ++j)
        out[j] = (w[j] << 2) | (w[j + 1] >> 30);
    out[W - 1] = w[W - 1] << 2;
    int shift_last = 30 - 2 * ((k - 1) % 16);
    out[(k - 1) >> 4] |= code << shift_last;
    int pad = 2 * (16 * W - k);
    if (pad) out[W - 1] &= (0xFFFFFFFFu >> pad) << pad;
}

static inline void to_predecessor(const uint32_t* w, int W, int k,
                                  uint32_t code, uint32_t* out) {
    for (int j = W - 1; j > 0; --j)
        out[j] = (w[j] >> 2) | ((w[j - 1] & 3u) << 30);
    out[0] = (w[0] >> 2) | (code << 30);
    int pad = 2 * (16 * W - k);
    if (pad) out[W - 1] &= (0xFFFFFFFFu >> pad) << pad;
}

// strict rc < fwd -> rc wins (ties keep fwd; bk.canonicalize)
static inline bool canon_pick(const uint32_t* fwd, const uint32_t* rc,
                              int W, const uint32_t** out) {
    for (int j = 0; j < W; ++j) {
        if (fwd[j] < rc[j]) { *out = fwd; return false; }
        if (fwd[j] > rc[j]) { *out = rc; return true; }
    }
    *out = fwd;
    return false;
}

static inline int64_t find_row(const uint32_t* table, int W, int64_t lo,
                               int64_t hi, const uint32_t* key) {
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        const uint32_t* r = table + mid * W;
        int c = 0;
        for (int j = 0; j < W; ++j) {
            if (r[j] != key[j]) { c = r[j] < key[j] ? -1 : 1; break; }
        }
        if (c < 0) lo = mid + 1;
        else if (c > 0) hi = mid;
        else return mid;
    }
    return -1;
}

static inline uint32_t rc_bits4(uint32_t b) {
    return ((b & 1) << 3) | ((b & 2) << 1) | ((b & 4) >> 1) |
           ((b & 8) >> 3);
}

static inline uint32_t rc_context(uint32_t ctx) {
    uint32_t pred = (ctx >> 4) & 0xF, succ = ctx & 0xF;
    return (rc_bits4(succ) << 4) | rc_bits4(pred);
}

static inline int popcount4(uint32_t b) {
    return (b & 1) + ((b >> 1) & 1) + ((b >> 2) & 1) + ((b >> 3) & 1);
}

static inline uint32_t single_base(uint32_t b) {
    return ((b >> 1) & 1) + ((b >> 2) & 1) * 2 + ((b >> 3) & 1) * 3;
}

static std::vector<int64_t> build_lut(const uint32_t* words, int W,
                                      int64_t m) {
    std::vector<int64_t> lut(65538);
    int64_t r = 0;
    for (int64_t b = 0; b <= 65536; ++b) {
        while (r < m && (int64_t)(words[r * W] >> 16) < b) ++r;
        lut[b] = r;
    }
    lut[65537] = m;
    return lut;
}

static inline int64_t lut_find(const uint32_t* words, int W,
                               const int64_t* lut, const uint32_t* key) {
    uint32_t b16 = key[0] >> 16;
    return find_row(words, W, lut[b16], lut[b16 + 1], key);
}

struct Ctx {
    const uint32_t* words;
    const uint32_t* ctx;
    const int64_t* lut;
    const uint8_t* pal;
    int k, W;
    int64_t m;
};

static void prune_block(const Ctx& c, int64_t r0, int64_t r1,
                        uint32_t* out_ctx) {
    const int W = c.W, k = c.k;
    uint32_t nb[MAX_W], rc[MAX_W];
    const uint32_t* canon;
    for (int64_t i = r0; i < r1; ++i) {
        const uint32_t* w = c.words + i * W;
        uint32_t ci = c.ctx[i];
        uint32_t out = 0;
        for (uint32_t code = 0; code < 4; ++code) {
            if ((ci >> code) & 1) {
                to_successor(w, W, k, code, nb);
                rc_words(nb, W, k, rc);
                canon_pick(nb, rc, W, &canon);
                if (lut_find(c.words, W, c.lut, canon) >= 0)
                    out |= 1u << code;
            }
            if ((ci >> (code + 4)) & 1) {
                to_predecessor(w, W, k, code, nb);
                rc_words(nb, W, k, rc);
                canon_pick(nb, rc, W, &canon);
                if (lut_find(c.words, W, c.lut, canon) >= 0)
                    out |= 1u << (code + 4);
            }
        }
        out_ctx[i] = out;
    }
}

static void links_block(const Ctx& c, int64_t n0, int64_t n1,
                        int32_t* out_next) {
    const int W = c.W, k = c.k;
    const int64_t m = c.m;
    uint32_t w_o[MAX_W], sw[MAX_W], rc[MAX_W];
    const uint32_t* canon;
    for (int64_t n = n0; n < n1; ++n) {
        int64_t kid = n % m;
        bool src_rev = n >= m;
        out_next[n] = -1;
        if (c.pal[kid]) continue;
        uint32_t ctx_o = src_rev ? rc_context(c.ctx[kid]) : c.ctx[kid];
        uint32_t sbits = ctx_o & 0xF;
        if (popcount4(sbits) != 1) continue;
        if (src_rev) rc_words(c.words + kid * W, W, k, w_o);
        else std::memcpy(w_o, c.words + kid * W, W * 4);
        to_successor(w_o, W, k, single_base(sbits), sw);
        rc_words(sw, W, k, rc);
        bool succ_isrev = canon_pick(sw, rc, W, &canon);
        int64_t vidx = lut_find(c.words, W, c.lut, canon);
        if (vidx < 0) continue;
        if (c.pal[vidx]) continue;
        uint32_t vctx = succ_isrev ? rc_context(c.ctx[vidx]) : c.ctx[vidx];
        if (popcount4((vctx >> 4) & 0xF) != 1) continue;
        if (vidx == kid && succ_isrev != src_rev) continue;  // hairpin
        out_next[n] = (int32_t)(vidx + (succ_isrev ? m : 0));
    }
}

template <typename F>
static void run_threads(int64_t n, int nt, F f) {
    if (nt <= 1 || n < 1024) {
        f(0, n);
        return;
    }
    std::vector<std::thread> ths;
    int64_t step = (n + nt - 1) / nt;
    for (int t = 0; t < nt; ++t) {
        int64_t a = t * step, b = std::min(n, a + step);
        if (a >= b) break;
        ths.emplace_back(f, a, b);
    }
    for (auto& th : ths) th.join();
}

}  // namespace

extern "C" {

// Adjacency pruning: out_ctx[i] keeps only the context bits whose
// neighbor kmer exists in the sorted table.  Returns 0, or -1 (nothing
// written) when W is outside 1..MAX_W.
int32_t w2rap_prune_ctx(const uint32_t* words, const uint32_t* ctx,
                        int64_t m, int32_t k, int32_t W, int32_t n_threads,
                        uint32_t* out_ctx) {
    if (W < 1 || W > MAX_W) return -1;
    auto lut = build_lut(words, W, m);
    Ctx c{words, ctx, lut.data(), nullptr, k, W, m};
    run_threads(m, n_threads, [&](int64_t a, int64_t b) {
        prune_block(c, a, b, out_ctx);
    });
    return 0;
}

// Unitig links: out_next[n] for oriented nodes n = kid + o*m (-1 when
// no link leaves n).  ctx must already be pruned.  Returns 0, or -1
// (nothing written) when W is outside 1..MAX_W.
int32_t w2rap_build_links(const uint32_t* words, const uint32_t* ctx,
                          int64_t m, int32_t k, int32_t W,
                          int32_t n_threads, int32_t* out_next) {
    if (W < 1 || W > MAX_W) return -1;
    auto lut = build_lut(words, W, m);
    std::vector<uint8_t> pal(m);
    run_threads(m, n_threads, [&](int64_t a, int64_t b) {
        uint32_t rc[MAX_W];
        for (int64_t i = a; i < b; ++i) {
            rc_words(words + i * W, W, k, rc);
            pal[i] = std::memcmp(rc, words + i * W, W * 4) == 0;
        }
    });
    Ctx c{words, ctx, lut.data(), pal.data(), k, W, m};
    run_threads(2 * m, n_threads, [&](int64_t a, int64_t b) {
        links_block(c, a, b, out_next);
    });
    return 0;
}

// List ranking over the oriented-node successor links: head = start of
// each node's prev-chain, rank = #prev steps to it, on_cycle for nodes
// on closed loops.  Sequential chain walks are O(N) where the numpy
// pointer-doubling mirror (graph/build._list_rank_host) pays
// O(N log N) gather passes.  prev[n] = rc(nxt[rc(n)]) by orientation
// symmetry; results match pointer doubling exactly on linear chains
// (cycle nodes only feed the on_cycle mask downstream).
void w2rap_list_rank(const int32_t* nxt, int64_t n2, int32_t* head,
                     int32_t* rank, uint8_t* on_cycle) {
    const int64_t M = n2 / 2;
    std::vector<int32_t> prev(n2), succ(n2, -1);
    for (int64_t n = 0; n < n2; ++n) {
        int64_t rc_n = n < M ? n + M : n - M;
        int32_t nr = nxt[rc_n];
        prev[n] = nr < 0 ? -1 : (nr < M ? (int32_t)(nr + M)
                                        : (int32_t)(nr - M));
    }
    for (int64_t n = 0; n < n2; ++n)
        if (prev[n] >= 0) succ[prev[n]] = (int32_t)n;
    std::vector<uint8_t> seen(n2, 0);
    for (int64_t h = 0; h < n2; ++h) {
        if (prev[h] >= 0) continue;  // not a chain head
        int32_t cur = (int32_t)h, r = 0;
        while (cur >= 0 && !seen[cur]) {
            seen[cur] = 1;
            head[cur] = (int32_t)h;
            rank[cur] = r++;
            on_cycle[cur] = 0;
            cur = succ[cur];
        }
    }
    // anything unvisited sits on a closed loop (or hangs off one via a
    // malformed multi-successor link — either way it never ranks on a
    // linear chain): mark on_cycle, self head
    for (int64_t n = 0; n < n2; ++n) {
        if (!seen[n]) {
            head[n] = (int32_t)n;
            rank[n] = 0;
            on_cycle[n] = 1;
        }
    }
}

}  // extern "C"
