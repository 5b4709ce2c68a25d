"""FillPairs — frequency-trimmed pair filling.

Reference: src/paths/long/FillPairs.{h,cc}: reads are truncated at the
first K=60 kmer with multiplicity < min_freq (the first kmer being bad
truncates to zero, TrimReadsOld, FillPairs.cc:107-171); the trimmed
reads are pathed in their own K=60 graph and a pair whose two ends land
on a single unipath is replaced by the filled-in unipath sequence
between them (FillPairs.cc:175-300).

Used by CorrectionSuite (LoadCorrectCore.cc:171) with MIN_FREQ=5.
"""

from __future__ import annotations

import numpy as np

from ..graph import build as gb
from ..ops import kmer_engine as ke
from . import pather

FP_K = 60


def _count_rows_host(bases, lengths, k, min_freq):
    """Host flat counting over read rows (glen > k gating at min_qual=0
    == keep only rows longer than k), mirroring ke.count_kmers
    semantics without any jitted kernel — blob-scale inputs pay a fresh
    XLA compile per distinct shape otherwise."""
    n = bases.shape[0]
    keep_l = np.where(lengths > k, lengths.astype(np.int64), 0)
    seg = np.zeros(n + 1, dtype=np.int64)
    seg[1:] = np.cumsum(keep_l)
    flat = (
        np.concatenate([bases[i, : keep_l[i]] for i in range(n)])
        if n
        else np.zeros(0, np.uint8)
    )
    return ke.count_kmers_flat(flat, seg, k, min_freq=min_freq, host=True)


def trim_reads(reads, min_freq: int):
    """TrimReadsOld: per-read trim length by kmer multiplicity."""
    from ..graph.build import _rows_bytes, _search_host
    from ..ops import np_bitkmer as bk

    n, L = reads.bases.shape
    if L < FP_K:
        return reads.lengths.copy()
    # count with no qual gating
    d = _count_rows_host(reads.bases, reads.lengths, FP_K, min_freq)
    # per-position membership in the >=min_freq dictionary (host search)
    P = L - FP_K + 1
    win = np.lib.stride_tricks.sliding_window_view(
        reads.bases, FP_K, axis=1
    ).reshape(n * P, FP_K)
    words = bk.pack_codes(np.ascontiguousarray(win), FP_K)
    canon, _ = bk.canonicalize(words, FP_K)
    if d.size:
        _, found = _search_host(_rows_bytes(d.words), canon)
    else:
        found = np.zeros(n * P, dtype=bool)
    found = np.asarray(found).reshape(n, P)

    trim_to = reads.lengths.copy()
    pos = np.arange(P)[None, :]
    valid = pos <= (reads.lengths[:, None] - FP_K)
    bad = valid & ~found
    has_bad = bad.any(axis=1)
    first_bad = np.where(has_bad, np.argmax(bad, axis=1), -1)
    # first kmer bad -> 0; else keep through (first_bad + K - 1) bases
    trim = np.where(
        first_bad == 0, 0, first_bad + FP_K - 1
    ).astype(np.int32)
    trim_to = np.where(has_bad, trim, trim_to).astype(np.int32)
    # reads shorter than K are untouched (no kmers to judge)
    trim_to = np.where(reads.lengths < FP_K, reads.lengths, trim_to)
    return trim_to


def fill_pairs(reads, min_freq: int = 5):
    """Returns (filled: list of np arrays [empty when unfilled], n_filled).

    Pairs are interleaved (2i, 2i+1) per the PairsManager convention.
    """
    from ..core.reads import ReadSet

    trim_to = trim_reads(reads, min_freq)
    tb = reads.bases.copy()
    tq = np.full_like(reads.quals, 40)
    trimmed = ReadSet(tb, trim_to, tq)

    # graph of trimmed reads (all kmers, like LongReadsToPaths cov=50)
    d = _count_rows_host(trimmed.bases, trimmed.lengths, FP_K, 1)
    if d.size == 0:
        return [np.zeros(0, np.uint8) for _ in range(reads.n_reads)], 0
    gb.recompute_adjacencies(d)
    eb, es = gb.build_unitigs(d)
    hbv, fx, rx = gb.build_hbv_from_edges(eb, es, FP_K)
    paths = pather.path_reads(trimmed, d, hbv, fx, rx)

    inv = hbv.inv
    filled = [np.zeros(0, np.uint8) for _ in range(reads.n_reads)]
    n_filled = 0
    for pid in range(reads.n_reads // 2):
        id1, id2 = 2 * pid, 2 * pid + 1
        p1 = [int(x) for x in paths.path(id1)]
        p2 = [int(x) for x in paths.path(id2)]
        if len(p1) != 1 or len(p2) != 1:
            continue
        e1 = p1[0]
        e2 = int(inv[p2[0]])  # partner in fwd orientation
        if e1 != e2:
            continue
        o1 = int(paths.start[id1])
        # partner's start on the rc edge -> end position on fwd edge
        o2r = int(paths.start[id2])
        l2 = int(trim_to[id2])
        end_fwd = int(hbv.edge_len(e1)) - o2r
        if o1 < 0 or end_fwd <= o1 or end_fwd > hbv.edge_len(e1):
            continue
        seq = hbv.edge_seq(e1)[o1:end_fwd]
        if len(seq) == 0:
            continue
        filled[id1] = seq.copy()
        n_filled += 1
    return filled, n_filled
