"""PartnersToEnds — place unplaced partner reads of reads that end near
graph dead ends.

Reference: PartnersToEnds (src/paths/long/large/GapToyTools5.cc:1462)
and its helpers (findInterestingReadIds :1154, KmerLocs dictionary
:1222-1275, EdgeProc :1365-1455).  A read is interesting when its own
path is empty, its mate is placed, and the mate's last edge ends within
500 kmers of a forward dead end.  Interesting reads are kmerized at
K=28 (forward strand, no canonicalization); kmers hit by more than 80
read+edge locations are dropped; every edge kmer match proposes an
alignment offset, and a read is placed when exactly one (edge, offset)
candidate passes the quality gate: no mismatch at qual >= 30 anywhere in
the overlap and some 60-base window with <= 4 mismatches.

TPU-first shape: the reference's MapReduce + concurrent-HashSet
pipeline becomes one sort-join — read kmers and edge kmers are packed
into uint64 keys, sorted, and range-joined with searchsorted; only the
per-candidate quality gate (few candidates) runs as a host loop.
"""

from __future__ import annotations

import numpy as np

from .read_paths import ReadPathVec

KLEN = 28  # GapToyTools5.cc:1152
MAX_MULTIPLICITY = 80  # :1481
GOOD_DIST = 500  # :1163
WINDOW = 60  # :1367
MAX_MISMATCHES = 4  # :1368
TRUSTED_QUAL = 30  # :1369


def distances_to_end_capped(hbv, cap: int):
    """DistancesToEndArr (graph/Digraph.h:1237): D[v] = max total kmer
    length over forward paths from v, saturated at cap."""
    V = hbv.n_vertices
    kmers = hbv.edge_kmers()
    D = np.zeros(V, dtype=np.int64)
    for _ in range(100000):
        cand = np.zeros(V, dtype=np.int64)
        np.maximum.at(cand, hbv.to_left, kmers + D[hbv.to_right])
        cand = np.minimum(cand, cap)
        if np.array_equal(cand, D):
            break
        D = cand
    return D


def _pack_kmers(flat: np.ndarray, starts: np.ndarray, lens: np.ndarray):
    """All KLEN-mers of each ragged sequence: returns (kval uint64,
    seq_id, offset)."""
    counts = np.maximum(lens - KLEN + 1, 0)
    sid = np.repeat(np.arange(len(lens)), counts)
    total = int(counts.sum())
    pos = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    off = starts[sid] + pos
    v = np.zeros(total, dtype=np.uint64)
    for i in range(KLEN):
        v = (v << np.uint64(2)) | flat[off + i].astype(np.uint64)
    return v, sid, pos


def partners_to_ends(hbv, paths: ReadPathVec, reads):
    """Returns (paths2, n_placed)."""
    n = paths.n_reads
    if n == 0 or hbv.n_edges == 0:
        return paths, 0
    plen = paths.path_len()
    D = distances_to_end_capped(hbv, GOOD_DIST + 1)
    end_edge = D[hbv.to_right] <= GOOD_DIST

    mate = np.arange(n) ^ 1
    last_edge = np.full(n, -1, dtype=np.int64)
    nz = plen > 0
    last_edge[nz] = paths.edges[paths.offsets[1:][nz] - 1]
    rl = reads.lengths.astype(np.int64)
    interesting = (
        (plen == 0)
        & (plen[mate] > 0)
        & end_edge[np.clip(last_edge[mate], 0, None)]
        & (rl >= KLEN)
    )
    rids = np.flatnonzero(interesting)
    if len(rids) == 0:
        return paths, 0

    # read kmer table (forward strand)
    rb = reads.bases[rids]
    rflat = rb.reshape(-1)
    rstarts = np.arange(len(rids), dtype=np.int64) * rb.shape[1]
    rk, rsid, roff = _pack_kmers(rflat, rstarts, rl[rids])
    order = np.argsort(rk, kind="stable")
    rk, rsid, roff = rk[order], rsid[order], roff[order]
    # group multiplicities
    grp_start = np.concatenate([[True], rk[1:] != rk[:-1]])
    gid = np.cumsum(grp_start) - 1
    ngroups = int(gid[-1]) + 1 if len(gid) else 0
    gcount = np.bincount(gid, minlength=ngroups)

    # edge kmer table
    ek, esid, eoff = _pack_kmers(
        hbv.edge_bases, hbv.edge_start[:-1], hbv.edge_len()
    )
    eorder = np.argsort(ek, kind="stable")
    ek, esid, eoff = ek[eorder], esid[eorder], eoff[eorder]

    # edge-kmer multiplicity per read-kmer group
    gkeys = rk[grp_start]
    lo = np.searchsorted(ek, gkeys, "left")
    hi = np.searchsorted(ek, gkeys, "right")
    elocs = hi - lo
    keep_grp = (gcount <= MAX_MULTIPLICITY) & (
        gcount + elocs <= MAX_MULTIPLICITY
    )

    # join: one candidate per (read loc x edge loc) in surviving groups
    kept = np.flatnonzero(keep_grp & (elocs > 0))
    if len(kept) == 0:
        return paths, 0
    goff = np.zeros(ngroups + 1, dtype=np.int64)
    goff[1:] = np.cumsum(gcount)
    cand_r, cand_e, cand_o = [], [], []
    for gi in kept:
        rr = rsid[goff[gi] : goff[gi + 1]]
        ro = roff[goff[gi] : goff[gi + 1]]
        ee = esid[lo[gi] : hi[gi]]
        eo = eoff[lo[gi] : hi[gi]]
        cand_r.append(np.repeat(rr, len(ee)))
        cand_e.append(np.tile(ee, len(rr)))
        cand_o.append(np.repeat(ro, len(ee)) - np.tile(eo, len(rr)))
    cr = np.concatenate(cand_r)
    ce = np.concatenate(cand_e)
    co = np.concatenate(cand_o)
    trip = np.stack([cr, ce, co])
    _, ui = np.unique(trip, axis=1, return_index=True)
    cr, ce, co = cr[ui], ce[ui], co[ui]

    # quality gate per candidate
    elen = hbv.edge_len()
    good_read: dict[int, list] = {}
    for i in range(len(cr)):
        rid = int(rids[cr[i]])
        e = int(ce[i])
        offset = -int(co[i])  # read start on edge
        b = reads.bases[rid, : rl[rid]]
        q = reads.quals[rid, : rl[rid]]
        es = hbv.edge_seq(e)
        if offset >= 0:
            ov = min(len(b), len(es) - offset)
            rb_, eb_, q_ = b[:ov], es[offset : offset + ov], q[:ov]
        else:
            ov = min(len(b) + offset, len(es))
            rb_, eb_ = b[-offset : -offset + ov], es[:ov]
            q_ = q[-offset : -offset + ov]
        if ov < WINDOW:
            continue
        mism = rb_ != eb_
        if np.any(mism & (q_ >= TRUSTED_QUAL)):
            continue
        cs = np.concatenate([[0], np.cumsum(mism)])
        if (cs[WINDOW:] - cs[:-WINDOW]).min() <= MAX_MISMATCHES:
            good_read.setdefault(rid, []).append((e, offset))
    placed = {r: c[0] for r, c in good_read.items() if len(c) == 1}
    if not placed:
        return paths, 0

    new_lens = plen.copy()
    for r in placed:
        new_lens[r] = 1
    off2 = np.zeros(n + 1, dtype=np.int64)
    off2[1:] = np.cumsum(new_lens)
    flat = np.zeros(int(off2[-1]), dtype=np.int32)
    starts = paths.start.copy()
    if len(paths.edges):
        ridx = np.repeat(np.arange(n), plen)
        local = np.arange(len(paths.edges)) - np.repeat(paths.offsets[:-1], plen)
        flat[off2[ridx] + local] = paths.edges
    for r, (e, offset) in placed.items():
        flat[off2[r]] = e
        starts[r] = offset
    return ReadPathVec(off2, flat, starts), len(placed)
