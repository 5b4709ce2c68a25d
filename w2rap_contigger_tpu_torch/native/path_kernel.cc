// Native (host) read-pathing lookup for the CPU backend.
//
// The CPU-parity pipeline's largest remaining wall after counting went
// native was read pathing: XLA-CPU's batched binary search over the
// sorted dictionary at ~every read position.  This kernel performs the
// same per-position oriented-edge lookup in one C++ pass — rolling
// multiword fwd/rc window, canonical min, 16-bit-prefix-accelerated
// binary search, run-start detection — and emits exactly the compact
// (pos, edge, off, ekm, nruns) slot arrays that paths/pather.py's
// _lookup_compact_impl produces on device, so the shared numpy decode
// (_decode_compact -> _parts_to_paths) consumes either source
// unchanged and results are bit-identical (reference semantics:
// path_reads_OMP, BuildReadQGraph.cc:829-940).
//
// This is an original implementation; the reference's BRQ_Pather was
// not consulted line-wise.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// strict rc < fwd -> reverse orientation wins (ties keep fwd, matching
// ops/bitkmer.canonicalize)
static inline bool canon_is_rev(const uint32_t* fwd, const uint32_t* rc,
                                int W) {
    for (int j = 0; j < W; ++j) {
        if (fwd[j] < rc[j]) return false;
        if (fwd[j] > rc[j]) return true;
    }
    return false;
}

// binary search for row key[0..W) in the sorted (m, W) table restricted
// to [lo, hi); returns row index or -1
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

struct Shared {
    const uint8_t* bases;
    const int32_t* lengths;
    int64_t L;
    int k, W;
    const uint32_t* dict;
    int64_t m;
    const int32_t* kdef_edge;
    const int32_t* kdef_off;
    const uint8_t* kdef_rc;
    const int32_t* fwd_xlat;
    const int32_t* rev_xlat;
    const int32_t* ekm;
    const int64_t* lut;  // 65537 prefix starts over dict word0 >> 16
    // run-continuation predictor: row_of(e0, off) = eperm[erow[e0] + off]
    // (consecutive read positions almost always continue the current
    // edge, so one row compare replaces the binary search)
    const int32_t* eperm;
    const int64_t* erow;
    int S;
    int32_t* out_pos;
    int32_t* out_e;
    int32_t* out_off;
    int32_t* out_ekm;
    int32_t* out_nruns;
};

static void path_block(const Shared& sh, int64_t r0, int64_t r1,
                       int32_t* max_nruns) {
    const int k = sh.k, W = sh.W, S = sh.S;
    const int pad = 2 * (16 * W - k);
    std::vector<uint32_t> fwd(W), rc(W);
    int32_t local_max = 0;
    for (int64_t r = r0; r < r1; ++r) {
        int64_t len = sh.lengths[r];
        if (len > sh.L) len = sh.L;
        int32_t* opos = sh.out_pos + r * S;
        int32_t* oe = sh.out_e + r * S;
        int32_t* ooff = sh.out_off + r * S;
        int32_t* oekm = sh.out_ekm + r * S;
        int nr = 0;
        if (len >= k) {
            const uint8_t* codes = sh.bases + r * sh.L;
            std::fill(fwd.begin(), fwd.end(), 0u);
            std::fill(rc.begin(), rc.end(), 0u);
            for (int i = 0; i < k; ++i) {
                uint32_t b = codes[i] & 3;
                fwd[i >> 4] |= b << (30 - 2 * (i & 15));
                uint32_t cb = 3 - b;
                int ri = k - 1 - i;
                rc[ri >> 4] |= cb << (30 - 2 * (ri & 15));
            }
            int32_t prev_e = -3, prev_off = 0;
            int64_t pred_row = -1;  // expected dict row of the next pos
            for (int64_t p = 0;; ++p) {
                bool is_rev = canon_is_rev(fwd.data(), rc.data(), W);
                const uint32_t* canon = is_rev ? rc.data() : fwd.data();
                int64_t i = -1;
                if (pred_row >= 0) {
                    const uint32_t* pr = sh.dict + pred_row * W;
                    bool eq = true;
                    for (int j = 0; j < W; ++j)
                        if (pr[j] != canon[j]) { eq = false; break; }
                    if (eq) i = pred_row;
                }
                if (i < 0) {
                    uint32_t b16 = canon[0] >> 16;
                    i = find_row(sh.dict, W, sh.lut[b16],
                                 sh.lut[b16 + 1], canon);
                }
                int32_t e, o, km;
                if (i >= 0) {
                    int32_t e0 = sh.kdef_edge[i];
                    bool rcf = is_rev ^ (sh.kdef_rc[i] != 0);
                    e = rcf ? sh.rev_xlat[e0] : sh.fwd_xlat[e0];
                    km = sh.ekm[e0];
                    int32_t off0 = sh.kdef_off[i];
                    o = rcf ? km - 1 - off0 : off0;
                    // the next position, if it continues this edge, sits
                    // at oriented offset o+1, i.e. raw offset off0+1 when
                    // the walk follows the edge forward (rcf false) and
                    // off0-1 when it walks the rc strand (o == km-1-off0);
                    // a wrong guess just fails the row compare and falls
                    // back to the binary search (correctness unaffected)
                    int32_t noff = rcf ? off0 - 1 : off0 + 1;
                    pred_row = (noff >= 0 && noff < km)
                                   ? (int64_t)sh.eperm[sh.erow[e0] + noff]
                                   : -1;
                } else {
                    e = -1; o = 0; km = 0;
                    pred_row = -1;
                }
                bool new_run =
                    (e != prev_e) || (e >= 0 && o != prev_off + 1);
                if (new_run) {
                    if (nr < S) {
                        opos[nr] = (int32_t)p;
                        oe[nr] = e;
                        ooff[nr] = o;
                        oekm[nr] = km;
                    }
                    ++nr;
                }
                prev_e = e; prev_off = o;
                if (p + k >= len) break;
                uint32_t nb = codes[p + k] & 3;
                for (int j = 0; j < W - 1; ++j)
                    fwd[j] = (fwd[j] << 2) | (fwd[j + 1] >> 30);
                fwd[W - 1] <<= 2;
                int li = k - 1;
                fwd[li >> 4] |= nb << (30 - 2 * (li & 15));
                if (pad) fwd[W - 1] &= (0xFFFFFFFFu >> pad) << pad;
                for (int j = W - 1; j > 0; --j)
                    rc[j] = (rc[j] >> 2) | (rc[j - 1] << 30);
                rc[0] = (rc[0] >> 2) | ((3 - nb) << 30);
                if (pad) rc[W - 1] &= (0xFFFFFFFFu >> pad) << pad;
            }
        }
        sh.out_nruns[r] = nr;
        if (nr > local_max) local_max = nr;
    }
    *max_nruns = local_max;
}

}  // namespace

extern "C" {

// Per-position oriented-edge lookup + run-start compaction for n reads.
// out_pos/out_e/out_off/out_ekm are (n, S) int32 row-major; out_nruns
// (n,) int32.  A read with nruns > S has only its first S run starts
// recorded — the caller re-runs those reads with a larger S.  Returns
// the maximum nruns over all reads.
int32_t w2rap_path_leaf(const uint8_t* bases, const int32_t* lengths,
                        int64_t n, int64_t L, int32_t k, int32_t W,
                        const uint32_t* dict_words, int64_t m,
                        const int32_t* kdef_edge, const int32_t* kdef_off,
                        const uint8_t* kdef_rc, const int32_t* fwd_xlat,
                        const int32_t* rev_xlat, const int32_t* ekm,
                        int64_t n_edges0, int32_t S, int32_t n_threads,
                        int32_t* out_pos, int32_t* out_e,
                        int32_t* out_off, int32_t* out_ekm,
                        int32_t* out_nruns) {
    // 16-bit prefix ranges over the sorted table (word0 high half)
    std::vector<int64_t> lut(65538);
    {
        int64_t r = 0;
        for (int64_t b = 0; b <= 65536; ++b) {
            while (r < m && (int64_t)(dict_words[r * W] >> 16) < b) ++r;
            lut[b] = r;
        }
        lut[65537] = m;
    }
    // (edge, offset) -> dict row table for the run-continuation
    // predictor: bucket rows by canonical edge (counting sort; every
    // edge holds offsets 0..ekm-1 exactly once by unitig construction)
    std::vector<int64_t> erow(n_edges0 + 1, 0);
    std::vector<int32_t> eperm(m);
    {
        for (int64_t i = 0; i < m; ++i) erow[kdef_edge[i] + 1]++;
        for (int64_t e = 0; e < n_edges0; ++e) erow[e + 1] += erow[e];
        for (int64_t i = 0; i < m; ++i)
            eperm[erow[kdef_edge[i]] + kdef_off[i]] = (int32_t)i;
    }
    Shared sh{bases,    lengths,  L,        k,        W,
              dict_words, m,      kdef_edge, kdef_off, kdef_rc,
              fwd_xlat, rev_xlat, ekm,      lut.data(),
              eperm.data(), erow.data(), S,
              out_pos,  out_e,    out_off,  out_ekm,  out_nruns};
    int nt = n_threads > 0 ? n_threads : 1;
    if (nt > n) nt = n > 0 ? (int)n : 1;
    std::vector<int32_t> maxes(nt, 0);
    if (nt == 1) {
        path_block(sh, 0, n, &maxes[0]);
    } else {
        std::vector<std::thread> ths;
        int64_t step = (n + nt - 1) / nt;
        for (int t = 0; t < nt; ++t) {
            int64_t a = t * step, b = std::min(n, a + step);
            if (a >= b) break;
            ths.emplace_back(path_block, std::cref(sh), a, b, &maxes[t]);
        }
        for (auto& th : ths) th.join();
    }
    int32_t mx = 0;
    for (int t = 0; t < nt; ++t) mx = std::max(mx, maxes[t]);
    return mx;
}

// Flat-sequence pathing (step 3's place-walk translation,
// Repath.cc:140-196): per segment, the same rolling window + predictor
// + prefix binary search fills the (n_pos,) oriented-edge/offset planes
// that paths/flat_pather.path_flat_sequences decodes (positions outside
// any segment's kmer range stay -1; the decode never reads them).
int64_t w2rap_path_flat(const uint8_t* flat, const int64_t* seg,
                        int64_t n_seg, int32_t k, int32_t W,
                        const uint32_t* dict_words, int64_t m,
                        const int32_t* kdef_edge, const int32_t* kdef_off,
                        const uint8_t* kdef_rc, const int32_t* fwd_xlat,
                        const int32_t* rev_xlat, const int32_t* ekm,
                        int64_t n_edges0, int32_t n_threads,
                        int32_t* out_e, int32_t* out_off) {
    std::vector<int64_t> lut(65538);
    {
        int64_t r = 0;
        for (int64_t b = 0; b <= 65536; ++b) {
            while (r < m && (int64_t)(dict_words[r * W] >> 16) < b) ++r;
            lut[b] = r;
        }
        lut[65537] = m;
    }
    std::vector<int64_t> erow(n_edges0 + 1, 0);
    std::vector<int32_t> eperm(m);
    {
        for (int64_t i = 0; i < m; ++i) erow[kdef_edge[i] + 1]++;
        for (int64_t e = 0; e < n_edges0; ++e) erow[e + 1] += erow[e];
        for (int64_t i = 0; i < m; ++i)
            eperm[erow[kdef_edge[i]] + kdef_off[i]] = (int32_t)i;
    }
    const int pad = 2 * (16 * W - k);
    int nt = n_threads > 0 ? n_threads : 1;
    if (nt > n_seg) nt = n_seg > 0 ? (int)n_seg : 1;

    auto work = [&](int64_t s0, int64_t s1) {
        std::vector<uint32_t> fwd(W), rc(W);
        for (int64_t s = s0; s < s1; ++s) {
            const int64_t a = seg[s], b = seg[s + 1];
            if (b - a < k) continue;
            std::fill(fwd.begin(), fwd.end(), 0u);
            std::fill(rc.begin(), rc.end(), 0u);
            for (int i = 0; i < k; ++i) {
                uint32_t c = flat[a + i] & 3;
                fwd[i >> 4] |= c << (30 - 2 * (i & 15));
                uint32_t cb = 3 - c;
                int ri = k - 1 - i;
                rc[ri >> 4] |= cb << (30 - 2 * (ri & 15));
            }
            int64_t pred_row = -1;
            for (int64_t p = a;; ++p) {
                bool is_rev = canon_is_rev(fwd.data(), rc.data(), W);
                const uint32_t* canon = is_rev ? rc.data() : fwd.data();
                int64_t i = -1;
                if (pred_row >= 0) {
                    const uint32_t* pr = dict_words + pred_row * W;
                    bool eq = true;
                    for (int j = 0; j < W; ++j)
                        if (pr[j] != canon[j]) { eq = false; break; }
                    if (eq) i = pred_row;
                }
                if (i < 0) {
                    uint32_t b16 = canon[0] >> 16;
                    i = find_row(dict_words, W, lut[b16], lut[b16 + 1],
                                 canon);
                }
                if (i >= 0) {
                    int32_t e0 = kdef_edge[i];
                    bool rcf = is_rev ^ (kdef_rc[i] != 0);
                    int32_t km = ekm[e0];
                    int32_t off0 = kdef_off[i];
                    out_e[p] = rcf ? rev_xlat[e0] : fwd_xlat[e0];
                    out_off[p] = rcf ? km - 1 - off0 : off0;
                    int32_t noff = rcf ? off0 - 1 : off0 + 1;
                    pred_row = (noff >= 0 && noff < km)
                                   ? (int64_t)eperm[erow[e0] + noff]
                                   : -1;
                } else {
                    out_e[p] = -1;
                    out_off[p] = 0;
                    pred_row = -1;
                }
                if (p + k >= b) break;
                uint32_t nb = flat[p + k] & 3;
                for (int j = 0; j < W - 1; ++j)
                    fwd[j] = (fwd[j] << 2) | (fwd[j + 1] >> 30);
                fwd[W - 1] <<= 2;
                int li = k - 1;
                fwd[li >> 4] |= nb << (30 - 2 * (li & 15));
                if (pad) fwd[W - 1] &= (0xFFFFFFFFu >> pad) << pad;
                for (int j = W - 1; j > 0; --j)
                    rc[j] = (rc[j] >> 2) | (rc[j - 1] << 30);
                rc[0] = (rc[0] >> 2) | ((3 - nb) << 30);
                if (pad) rc[W - 1] &= (0xFFFFFFFFu >> pad) << pad;
            }
        }
    };
    if (nt <= 1) {
        work(0, n_seg);
    } else {
        std::vector<std::thread> ths;
        for (int t = 0; t < nt; ++t) {
            int64_t a = n_seg * t / nt, b2 = n_seg * (t + 1) / nt;
            if (a < b2) ths.emplace_back(work, a, b2);
        }
        for (auto& th : ths) th.join();
    }
    return 0;
}

}  // extern "C"
