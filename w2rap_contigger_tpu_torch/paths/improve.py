"""ImprovePaths — re-place read paths by 20-mer seeding + quality-sum
rescoring.

Reference: src/paths/long/large/ImprovePath.cc (ImprovePaths :570,
per-read ImprovePath :88-515).  Driver defaults (Simplify.cc:194-198,
w2rap-contigger.cc:491-492): IMPROVE_PATHS_LARGE=False, one pass with
L=20 seeds at read offsets {0,20,40,60}.

The heavy parts are vectorized: the L-mer table over edge kmer positions
(BuildLookup truncates each edge to ne-(K-L) bases so seeds never start
inside the duplicated K-1 vertex overlap, ImprovePath.cc:557-568), the
batched seed search, and the early "placement already agrees" test that
most reads hit (ImprovePath.cc:161-167).  Only reads that fail the fast
path run the per-read extension/scoring state machine.
"""

from __future__ import annotations

import numpy as np

from .read_paths import ReadPathVec

L_SEED = 20
RSTARTS = (0, 20, 40, 60)
MAX_LOCS1 = 10  # max seed locs (ImprovePath.cc:107)
MAX_LOCS2 = 100  # max extensions (:108)
WINDOW = 60  # junk-assessment window (:109)
MAX_MIS = 6  # max mismatches in window (:110)
MIN_GAIN = 5  # min q score improvement (:111)
FLANK = 10  # for raising q2 (:112)
MAX_OK = 150  # max quality score sum (:113)
MIN_BACK_OVER = 60  # to back up (:114)


def _pack_windows(mat: np.ndarray) -> np.ndarray:
    """Pack (N, L) base codes into (N,) uint64 keys."""
    v = np.zeros(mat.shape[0], dtype=np.uint64)
    for i in range(mat.shape[1]):
        v = (v << np.uint64(2)) | mat[:, i].astype(np.uint64)
    return v


def _build_table(hbv):
    """(sorted kval, edge, pos) over every edge kmer start position."""
    K = hbv.k
    lens = hbv.edge_len()
    counts = np.maximum(lens - K + 1, 0)
    counts = np.where(lens == 0, 0, counts)
    eidx = np.repeat(np.arange(hbv.n_edges), counts)
    total = int(counts.sum())
    pos = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(counts) - counts, counts
    )
    off = hbv.edge_start[:-1][eidx] + pos
    idx = off[:, None] + np.arange(L_SEED)[None, :]
    # when K < L the reference's BuildLookup resize pads edges with base
    # 0 ('A') past their end (ImprovePath.cc:563-567)
    edge_end = hbv.edge_start[1:][eidx][:, None]
    win = np.where(
        idx < edge_end,
        hbv.edge_bases[np.minimum(idx, len(hbv.edge_bases) - 1)],
        0,
    )
    kval = _pack_windows(win)
    order = np.lexsort((pos, eidx, kval))
    return kval[order], eidx[order].astype(np.int64), pos[order]


def _cat(hbv, edges):
    """hb.Cat: full first edge, then K-1-trimmed continuations."""
    k = hbv.k
    parts = [hbv.edge_seq(edges[0])]
    for e in edges[1:]:
        parts.append(hbv.edge_seq(e)[k - 1 :])
    return np.concatenate(parts) if len(parts) > 1 else parts[0]


def _improve_one(hbv, g, locs, p, offset, b, q):
    """ImprovePath for one read (ImprovePath.cc:88-515).

    locs: list of (edge, start) seeds (deduped, sorted); p: list path;
    offset: signed start.  Returns (new_path, new_offset) or None for
    no change.
    """
    K = hbv.k
    elen = g["elen"]
    ekmers = g["ekmers"]
    nb = len(b)

    # extend seeds rightward until the read is covered
    exts = []
    starts = []
    exts_len = []
    for e, start in locs:
        exts.append([e])
        exts_len.append(nb - (int(elen[e]) - start))
        starts.append(start)
    j = 0
    while j < len(exts):
        if j > MAX_LOCS2:
            return None
        if exts_len[j] <= 0:
            j += 1
            continue
        y = int(hbv.to_right[exts[j][-1]])
        outs = g["fe"][g["fo"][y] : g["fo"][y + 1]]
        if len(outs) == 0:
            return None  # dead end: the whole attempt is abandoned
        for n in outs:
            n = int(n)
            exts.append(exts[j] + [n])
            exts_len.append(exts_len[j] - int(ekmers[n]))
            starts.append(starts[j])
        j += 1
    keep = [i for i in range(len(exts)) if exts_len[i] <= 0]
    exts = [exts[i] for i in keep]
    starts = [starts[i] for i in keep]
    if not exts:
        return None

    # score full alignments by quality sums
    qsum = np.zeros(len(exts), dtype=np.int64)
    for i, (e, st) in enumerate(zip(exts, starts)):
        E = _cat(hbv, e)
        mism = b != E[st : st + nb]
        qsum[i] = int(q[mism].sum())
    order = np.argsort(qsum, kind="stable")
    qsum = qsum[order]
    exts = [exts[i] for i in order]
    starts = [starts[i] for i in order]

    # delete weak extensions
    for i in range(1, len(exts)):
        if qsum[i] - qsum[0] >= MIN_GAIN:
            qsum = qsum[:i]
            exts = exts[:i]
            starts = starts[:i]
            break

    # Q2 tiebreak (ImprovePath.cc:272-286)
    if len(exts) == 2 and qsum[1] - qsum[0] == 2:
        E1 = _cat(hbv, exts[0])
        E2 = _cat(hbv, exts[1])
        d1 = b == E1[starts[0] : starts[0] + nb]
        d2 = b != E2[starts[1] : starts[1] + nb]
        diffs = np.flatnonzero(d1 & d2)
        if len(diffs) == 1:
            d = int(diffs[0])
            if FLANK <= d < nb - FLANK:
                if (~d1[d - FLANK : d + FLANK + 1]).sum() == 0:
                    qsum = qsum[:1]
                    exts = exts[:1]
                    starts = starts[:1]

    pnew = (starts[0], list(exts[0]))
    if p == pnew[1] and offset == pnew[0]:
        return None

    # alignment goodness: a 60-base window with <= 6 mismatches
    E0 = _cat(hbv, exts[0])
    mis0 = (b != E0[starts[0] : starts[0] + nb]).astype(np.int64)
    good = False
    if nb >= WINDOW:
        cs = np.concatenate([[0], np.cumsum(mis0)])
        good = bool((cs[WINDOW:] - cs[:-WINDOW] <= MAX_MIS).any())
    if not good and len(p) == 0:
        return None

    # inconsistent extensions: give up
    for i in range(1, len(exts)):
        if starts[i] != starts[0] or exts[i][0] != exts[0][0]:
            return None

    # core extension: common prefix of all strong extensions
    m = len(exts)
    for i in range(1, len(exts)):
        if qsum[i] - qsum[0] >= MIN_GAIN:
            m = i
            break
    core = []
    for jj in range(len(exts[0])):
        if any(jj >= len(exts[l]) or exts[l][jj] != exts[0][jj] for l in range(1, m)):
            break
        core.append(exts[0][jj])
    pnew = (starts[0], list(core))
    start0 = starts[0]

    # back-extend the core through a solo in-edge (not stored in pnew)
    v = int(hbv.to_left[core[0]])
    ins = g["te"][g["to"][v] : g["to"][v + 1]]
    if len(ins) == 1:
        e = int(ins[0])
        st2 = start0 + int(ekmers[e])
        if st2 <= int(elen[e]) - MIN_BACK_OVER:
            core = [e] + core
            start0 = st2

    if core == p and start0 == offset:
        return None
    if qsum[0] > MAX_OK:
        return None
    if len(p) == 0:
        return pnew

    # compare the (back-extended) core to the existing alignment
    old_start = 0 if offset >= 0 else -offset
    E_old = _cat(hbv, p)
    old_qsum = 0
    old_stop = nb
    for mm in range(nb):
        pos = offset + mm
        if pos < 0:
            continue
        if pos == len(E_old):
            old_stop = mm
            break
        if b[mm] != E_old[pos]:
            old_qsum += int(q[mm])
    E_new = _cat(hbv, core)
    new_qsum = 0
    new_stop = nb
    for mm in range(nb):
        pos = start0 + mm
        if pos == len(E_new):
            new_stop = mm
            break
        if b[mm] != E_new[pos]:
            if old_start <= mm < old_stop:
                new_qsum += int(q[mm])
    new_start = 0
    if new_start > old_start or new_stop < old_stop:
        return None
    if new_start == old_start and new_stop == old_stop:
        return pnew if new_qsum < old_qsum else None
    return pnew if new_qsum <= old_qsum else None


def improve_paths(hbv, paths: ReadPathVec, reads):
    """One L=20 pass over all reads (ImprovePaths, ImprovePath.cc:570).

    Returns (paths2, n_changed)."""
    if hbv.n_edges == 0 or paths.n_reads == 0:
        return paths, 0
    K = hbv.k
    kval, kedge, kpos = _build_table(hbv)
    fo, fe, to, te = hbv.vertex_csr()
    g = {
        "fo": fo,
        "fe": fe,
        "to": to,
        "te": te,
        "elen": hbv.edge_len(),
        "ekmers": hbv.edge_kmers(),
    }
    n = paths.n_reads
    rl = reads.lengths.astype(np.int64)

    # batched seed search over the four read offsets
    loc_read: list = []
    loc_e: list = []
    loc_s: list = []
    for rstart in RSTARTS:
        ok = rl >= rstart + L_SEED
        rids = np.flatnonzero(ok)
        if len(rids) == 0:
            continue
        qk = _pack_windows(reads.bases[rids, rstart : rstart + L_SEED])
        lo = np.searchsorted(kval, qk, "left")
        hi = np.searchsorted(kval, qk, "right")
        cnt = hi - lo
        use = (cnt > 0) & (cnt <= MAX_LOCS1)
        urids = rids[use]
        ulo, ucnt = lo[use], cnt[use]
        flat_idx = np.repeat(ulo, ucnt) + (
            np.arange(int(ucnt.sum())) - np.repeat(np.cumsum(ucnt) - ucnt, ucnt)
        )
        es = kedge[flat_idx]
        ss = kpos[flat_idx] - rstart
        rr = np.repeat(urids, ucnt)
        pos_ok = ss >= 0
        loc_read.append(rr[pos_ok])
        loc_e.append(es[pos_ok])
        loc_s.append(ss[pos_ok])
        # negative starts: try in-edges of the seed edge's left vertex
        for i in np.flatnonzero(~pos_ok):
            w = int(hbv.to_left[es[i]])
            for f in te[to[w] : to[w + 1]]:
                f = int(f)
                pstart = int(ss[i]) + int(g["ekmers"][f])
                if pstart >= 0:
                    loc_read.append(np.array([rr[i]]))
                    loc_e.append(np.array([f]))
                    loc_s.append(np.array([pstart]))
    if not loc_read:
        return paths, 0
    lr = np.concatenate(loc_read)
    if len(lr) == 0:
        return paths, 0
    le = np.concatenate(loc_e).astype(np.int64)
    ls = np.concatenate(loc_s).astype(np.int64)
    # UniqueSort per read
    order = np.lexsort((ls, le, lr))
    lr, le, ls = lr[order], le[order], ls[order]
    uniq = np.ones(len(lr), dtype=bool)
    uniq[1:] = (lr[1:] != lr[:-1]) | (le[1:] != le[:-1]) | (ls[1:] != ls[:-1])
    lr, le, ls = lr[uniq], le[uniq], ls[uniq]
    roff = np.zeros(n + 1, dtype=np.int64)
    np.add.at(roff, lr + 1, 1)
    roff = np.cumsum(roff)

    # fast path: a single seed that matches the existing single-edge
    # placement and covers the read (ImprovePath.cc:161-167)
    plen = paths.path_len()
    nlocs = np.diff(roff)
    first_edge = np.full(n, -1, dtype=np.int64)
    nz = plen > 0
    first_edge[nz] = paths.edges[paths.offsets[:-1][nz]]
    solo = nlocs == 1
    si = roff[:-1].copy()
    fast_same = (
        solo
        & (plen == 1)
        & (le[np.minimum(si, len(le) - 1)] == first_edge)
        & (ls[np.minimum(si, len(ls) - 1)] == paths.start)
        & (
            g["elen"][np.clip(first_edge, 0, None)]
            - paths.start
            >= rl
        )
    ) if len(le) else np.zeros(n, dtype=bool)

    todo = np.flatnonzero((nlocs > 0) & ~fast_same)
    changed = {}
    new_starts = paths.start.astype(np.int64).copy()
    for r in todo:
        r = int(r)
        locs = list(zip(le[roff[r] : roff[r + 1]], ls[roff[r] : roff[r + 1]]))
        locs = [(int(e), int(s)) for e, s in locs]
        p = [int(e) for e in paths.path(r)]
        res = _improve_one(
            hbv,
            g,
            locs,
            p,
            int(paths.start[r]),
            reads.bases[r, : rl[r]],
            reads.quals[r, : rl[r]],
        )
        if res is not None:
            changed[r] = res[1]
            new_starts[r] = res[0]
    if not changed:
        return paths, 0
    new_lens = plen.copy()
    for r, p in changed.items():
        new_lens[r] = len(p)
    off = np.zeros(n + 1, dtype=np.int64)
    off[1:] = np.cumsum(new_lens)
    flat = np.zeros(int(off[-1]), dtype=np.int32)
    if len(paths.edges):
        rid = np.repeat(np.arange(n), plen)
        local = np.arange(len(paths.edges)) - np.repeat(paths.offsets[:-1], plen)
        unchanged = np.ones(n, dtype=bool)
        for r in changed:
            unchanged[r] = False
        msk = unchanged[rid]
        flat[(off[rid] + local)[msk]] = paths.edges[msk]
    for r, p in changed.items():
        flat[off[r] : off[r] + len(p)] = p
    return ReadPathVec(off, flat, new_starts.astype(np.int32)), len(changed)
