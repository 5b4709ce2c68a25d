// Native data loader: fastq(.gz) parsing + base-code packing.
//
// The reference's step-1 read extraction is native C++ streaming IO
// (src/paths/long/large/ExtractReads.cc:45-688, gzip via popen'd zcat
// through src/FastIfstream.h:90). Here: an in-process zlib inflate +
// a single-pass fastq tokenizer that fills dense (N, Lmax) uint8
// base-code / quality tensors directly — the layout the TPU kernels
// consume (core/reads.py) — with no Python-object intermediates.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -shared -fPIC fastq_loader.cc -o libw2rapio.so -lz

#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

// base-code table: A/a->0 C/c->1 G/g->2 T/t->3, everything else (N) -> 0,
// mirroring the reference's N->A conversion (ExtractReads.cc:561-568)
struct CodeTab {
    uint8_t tab[256];
    CodeTab() {
        memset(tab, 0, sizeof(tab));
        tab[(unsigned)'C'] = tab[(unsigned)'c'] = 1;
        tab[(unsigned)'G'] = tab[(unsigned)'g'] = 2;
        tab[(unsigned)'T'] = tab[(unsigned)'t'] = 3;
    }
};
const CodeTab kCodes;

}  // namespace

extern "C" {

// Inflate a gzip byte buffer. Returns 0 on success. Two-call protocol:
// pass out=nullptr to get the decompressed size in *out_len.
int w2rap_gunzip(const uint8_t* data, uint64_t len, uint8_t* out,
                 uint64_t* out_len) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) return -1;
    zs.next_in = const_cast<Bytef*>(data);
    zs.avail_in = len;
    if (out == nullptr) {
        // size-only pass
        std::vector<uint8_t> buf(1 << 20);
        uint64_t total = 0;
        int rc;
        do {
            zs.next_out = buf.data();
            zs.avail_out = buf.size();
            rc = inflate(&zs, Z_NO_FLUSH);
            if (rc != Z_OK && rc != Z_STREAM_END) { inflateEnd(&zs); return -2; }
            total += buf.size() - zs.avail_out;
            if (rc == Z_STREAM_END && zs.avail_in > 0) {
                // concatenated gzip members
                if (inflateReset2(&zs, 16 + MAX_WBITS) != Z_OK) {
                    inflateEnd(&zs); return -3;
                }
                rc = Z_OK;
            }
        } while (rc != Z_STREAM_END || zs.avail_in > 0);
        *out_len = total;
        inflateEnd(&zs);
        return 0;
    }
    uint64_t cap = *out_len;
    uint64_t total = 0;
    int rc;
    do {
        zs.next_out = out + total;
        zs.avail_out = cap - total;
        rc = inflate(&zs, Z_NO_FLUSH);
        if (rc != Z_OK && rc != Z_STREAM_END) { inflateEnd(&zs); return -2; }
        total = cap - zs.avail_out - 0;
        total = (zs.next_out - out);
        if (rc == Z_STREAM_END && zs.avail_in > 0) {
            if (inflateReset2(&zs, 16 + MAX_WBITS) != Z_OK) {
                inflateEnd(&zs); return -3;
            }
            rc = Z_OK;
        }
    } while (rc != Z_STREAM_END || zs.avail_in > 0);
    *out_len = total;
    inflateEnd(&zs);
    return 0;
}

// Pass 1: scan a fastq buffer, return record count and max sequence
// length. Returns 0 on success, negative on malformed input.
int w2rap_fastq_scan(const uint8_t* data, uint64_t len, uint64_t* n_reads,
                     uint64_t* max_len) {
    uint64_t n = 0, lmax = 0;
    uint64_t i = 0;
    int line = 0;  // 0=name 1=seq 2=plus 3=qual
    while (i < len) {
        const uint8_t* nl =
            (const uint8_t*)memchr(data + i, '\n', len - i);
        uint64_t end = nl ? (uint64_t)(nl - data) : len;
        uint64_t ll = end - i;
        if (line == 0) {
            if (ll == 0) { i = end + 1; continue; }  // tolerate blank lines
            if (data[i] != '@') return -1;
        } else if (line == 1) {
            if (ll > lmax) lmax = ll;
        } else if (line == 3) {
            ++n;
        }
        line = (line + 1) & 3;
        i = end + 1;
    }
    *n_reads = n;
    *max_len = lmax;
    return 0;
}

// Pass 2: fill caller-allocated dense arrays.
//   bases  : (n_reads * max_len) uint8, zero-padded base codes
//   quals  : (n_reads * max_len) uint8, zero-padded phred (ASCII-33)
//   lengths: (n_reads) int32
// Returns number of records filled, or negative on malformed input.
int64_t w2rap_fastq_fill(const uint8_t* data, uint64_t len, uint64_t max_len,
                         uint8_t* bases, uint8_t* quals, int32_t* lengths) {
    uint64_t i = 0;
    int64_t r = 0;
    int line = 0;
    uint64_t seq_len = 0;
    while (i < len) {
        const uint8_t* nl =
            (const uint8_t*)memchr(data + i, '\n', len - i);
        uint64_t end = nl ? (uint64_t)(nl - data) : len;
        uint64_t ll = end - i;
        if (line == 0) {
            if (ll == 0) { i = end + 1; continue; }
            if (data[i] != '@') return -1;
        } else if (line == 1) {
            if (ll > max_len) return -2;
            seq_len = ll;
            uint8_t* brow = bases + (uint64_t)r * max_len;
            for (uint64_t k = 0; k < ll; ++k) brow[k] = kCodes.tab[data[i + k]];
        } else if (line == 3) {
            if (ll != seq_len) return -3;
            uint8_t* qrow = quals + (uint64_t)r * max_len;
            for (uint64_t k = 0; k < ll; ++k) {
                int q = (int)data[i + k] - 33;
                qrow[k] = (uint8_t)(q < 0 ? 0 : q);
            }
            lengths[r] = (int32_t)seq_len;
            ++r;
        }
        line = (line + 1) & 3;
        i = end + 1;
    }
    return r;
}

}  // extern "C"
