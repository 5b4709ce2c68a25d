"""Step 7 — MakeGaps: PE scaffolding within the graph.

Reference: MakeGaps (src/paths/long/large/MakeGaps.cc:20-509), driver
call w2rap-contigger.cc:570-603 with MIN_LINE=5000, MIN_LINK_COUNT=3.

Pipeline: line stats -> edge groups near sources/sinks ('tom' mapping,
max_hang=800) -> 'nears' from read pairs -> link counting with
graph-proximity exclusion -> acceptance filters (count, line length,
coverage +-20%, winner, bubble advance, 1-to-1, symmetry, overlinked)
-> graph edit inserting 0-length gap edges + path truncation.
"""

from __future__ import annotations

import numpy as np

from ..graph import ops
from ..graph.lines import get_line_lengths
from ..paths.read_paths import ReadPathVec

from ..config import DEFAULT as _H

MAX_HANG = _H.GAP_MAX_HANG
MAX_DEPTH = _H.GAP_MAX_DEPTH
MAX_INT = _H.GAP_MAX_INT
PASSES = _H.GAP_PASSES
MAX_COV_PC_OFF = _H.GAP_MAX_COV_PC_OFF
MAX_LINE_TO_IGNORE = _H.GAP_MAX_LINE_TO_IGNORE


def _line_npairs(hbv, paths, lines, tol):
    """GetLineNpairs equivalent: pairs touching each line.

    Vectorized: every (pair, line) incidence is a key pid*nl + line;
    np.unique collapses repeat touches within a pair, bincount tallies
    per line.  O(path positions), no per-read Python loop."""
    inv = hbv.inv
    nl = len(lines)
    if nl == 0 or paths.edges.size == 0:
        return np.zeros(nl, dtype=np.int64)
    read_of = np.repeat(
        np.arange(paths.n_reads, dtype=np.int64), paths.path_len()
    )
    npids = paths.n_reads // 2
    in_pair = read_of < 2 * npids
    pid = read_of[in_pair] >> 1
    e = paths.edges[in_pair]
    ls = np.concatenate([tol[e], tol[inv[e]]])
    pids = np.concatenate([pid, pid])
    m = ls >= 0
    key = pids[m] * np.int64(nl) + ls[m]
    uniq = np.unique(key)
    return np.bincount((uniq % nl).astype(np.int64), minlength=nl)


def _near_events(paths, inv, tom, tol, llens):
    """All 'near' events (e1, e2) across every read pair, vectorized.

    Per pair the reference builds, for two passes,
      pass 1: x = tom[p1], y = tom[inv[reversed(p2)]]
      pass 2: x = tom[p2], y = tom[inv[reversed(p1)]]
    then dedups consecutive values, keeps only edges on lines longer
    than MAX_LINE_TO_IGNORE, and emits (e1, e2) for every e1 in x NOT
    present anywhere in y, crossed with every e2 != e1 in y
    (MakeGaps.cc nears construction).  Consumers only need the event
    multiset, so this computes it with flat-array arithmetic: per-read
    dedup masks, a sorted-key membership test for the e1-in-y
    exclusion, and an offset-arithmetic ragged cross product.
    """
    off = paths.offsets
    e = paths.edges
    n_reads = paths.n_reads
    npids = n_reads // 2
    if e.size == 0 or npids == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    plen = np.diff(off)
    read_of = np.repeat(np.arange(n_reads, dtype=np.int64), plen)
    pos = np.arange(e.size, dtype=np.int64) - off[read_of]
    L = plen[read_of]
    tom_f = tom[e]  # forward-sequence values
    tom_r = tom[inv[e]]  # reversed-inv sequence, stored at flat positions
    # dedup-consecutive: forward keeps seq position j if j==0 or
    # v[j] != v[j-1]; the reversed sequence's previous element sits at
    # flat position +1
    keep_f = np.empty(e.size, dtype=bool)
    keep_f[0] = True
    keep_f[1:] = tom_f[1:] != tom_f[:-1]
    keep_f |= pos == 0
    keep_r = np.empty(e.size, dtype=bool)
    keep_r[-1] = True
    keep_r[:-1] = tom_r[:-1] != tom_r[1:]
    keep_r |= pos == L - 1

    def _line_ok(v):
        lv = tol[v]
        ok = lv >= 0
        ok &= llens[np.where(ok, lv, 0)] > MAX_LINE_TO_IGNORE
        return ok

    in_pair = read_of < 2 * npids
    ok_f = keep_f & _line_ok(tom_f) & in_pair
    ok_r = keep_r & _line_ok(tom_r) & in_pair
    pid_of = read_of >> 1
    even = (read_of & 1) == 0
    M = np.int64(tom.size + 1)
    E1_all, E2_all = [], []
    for x_even in (True, False):  # pass 1, pass 2
        xm = ok_f & (even if x_even else ~even)
        ym = ok_r & (~even if x_even else even)
        xv, xp = tom_f[xm].astype(np.int64), pid_of[xm]
        yv, yp = tom_r[ym].astype(np.int64), pid_of[ym]
        if xv.size == 0 or yv.size == 0:
            continue
        ny = np.bincount(yp, minlength=npids).astype(np.int64)
        yoff = np.zeros(npids + 1, dtype=np.int64)
        yoff[1:] = np.cumsum(ny)
        # drop x occurrences whose value appears anywhere in the pair's y
        ykey = np.sort(yp * M + yv)
        xkey = xp * M + xv
        pp = np.searchsorted(ykey, xkey)
        ppc = np.minimum(pp, ykey.size - 1)
        iny = (pp < ykey.size) & (ykey[ppc] == xkey)
        xv, xp = xv[~iny], xp[~iny]
        if xv.size == 0:
            continue
        ny_of_x = ny[xp]
        tot = int(ny_of_x.sum())
        if tot == 0:
            continue
        cro = np.zeros(xv.size + 1, dtype=np.int64)
        cro[1:] = np.cumsum(ny_of_x)
        E1 = np.repeat(xv, ny_of_x)
        ar = np.arange(tot, dtype=np.int64) - np.repeat(cro[:-1], ny_of_x)
        E2 = yv[yoff[np.repeat(xp, ny_of_x)] + ar]
        m = E1 != E2
        E1_all.append(E1[m])
        E2_all.append(E2[m])
    if not E1_all:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    return np.concatenate(E1_all), np.concatenate(E2_all)


def _tol(hbv, lines):
    tol = np.full(hbv.n_edges, -1, dtype=np.int64)
    for i, L in enumerate(lines):
        for cell in L:
            for p in cell:
                for e in p:
                    tol[e] = i
    return tol


def make_gaps(
    hbv, paths, lines, min_line: int = 5000, min_link_count: int = 3,
    gap_cleanup: bool = True,
):
    """Returns (hbv2, paths2, n_gaps)."""
    E = hbv.n_edges
    inv = hbv.inv
    kmers = hbv.edge_kmers()
    tol = _tol(hbv, lines)
    llens = get_line_lengths(hbv, lines)
    npairs = _line_npairs(hbv, paths, lines, tol)
    cov = np.where(
        llens > 0, 100.0 * npairs / np.maximum(llens, 1), 0.0
    )

    to_left = hbv.to_left.copy()
    to_right = hbv.to_right.copy()
    fo, fe, to, te = hbv.vertex_csr()

    def outs(v):
        return [int(x) for x in fe[fo[v] : fo[v + 1]]]

    def ins(v):
        return [int(x) for x in te[to[v] : to[v + 1]]]

    # ---- edge groups (tom / sink_like / source_like) ------------------
    tom = np.arange(E, dtype=np.int64)
    sink_like = np.zeros(E, dtype=bool)
    source_like = np.zeros(E, dtype=bool)
    dist_to_end = np.zeros(E, dtype=np.int64)
    for e in range(E):
        if len(outs(int(to_right[e]))) == 0:
            sink_like[e] = True
        if len(ins(int(to_left[e]))) == 0:
            source_like[e] = True

    # zpass==1 runs on the REVERSED graph (hb.Reverse() before the body),
    # zpass==2 on the normal orientation.
    for _p in range(PASSES):
        for zpass in (1, 2):
            if zpass == 1:
                OUT, IN, TR = ins, outs, to_left
            else:
                OUT, IN, TR = outs, ins, to_right
            flag = source_like if zpass == 1 else sink_like
            for e in range(E):
                v = int(TR[e])
                if len(OUT(v)) != 2 or len(IN(v)) != 1:
                    continue
                e1, e2 = OUT(v)
                w1, w2 = int(TR[e1]), int(TR[e2])
                if not (flag[e1] and flag[e2]):
                    continue
                if w1 == w2 and len(IN(w1)) != 2:
                    continue
                if w1 != w2 and (len(IN(w1)) != 1 or len(IN(w2)) != 1):
                    continue
                d1 = int(kmers[e1]) + int(dist_to_end[e1])
                d2 = int(kmers[e2]) + int(dist_to_end[e2])
                if d1 > MAX_HANG or d2 > MAX_HANG:
                    continue
                flag[e] = True
                dist_to_end[e] = max(d1, d2)
                tom[e1] = tom[e]
                tom[e2] = tom[e]
            for e in range(E):
                v = int(TR[e])
                if len(OUT(v)) != 2 or len(IN(v)) != 1:
                    continue
                e1, e2 = OUT(v)
                w1, w2 = int(TR[e1]), int(TR[e2])
                if w1 != w2:
                    continue
                if len(IN(w1)) != 2 or len(OUT(w1)) != 1:
                    continue
                e3 = OUT(w1)[0]
                z = int(TR[e3])
                if len(IN(z)) != 1:
                    continue
                if not flag[e3]:
                    continue
                d1 = int(kmers[e1]) + int(kmers[e3]) + int(dist_to_end[e3])
                d2 = int(kmers[e2]) + int(kmers[e3]) + int(dist_to_end[e3])
                if d1 > MAX_HANG or d2 > MAX_HANG:
                    continue
                flag[e] = True
                dist_to_end[e] = max(d1, d2)
                tom[e1] = tom[e]
                tom[e2] = tom[e]
                tom[e3] = tom[e]

    # ---- nears from read pairs ---------------------------------------
    # Vectorized over all pairs at once (was a per-pair Python loop —
    # hours at wheat scale).  Every downstream consumer of `nears` is
    # order-insensitive (the list was sorted, and nears1/nears2 only
    # feed a max-run-length), so only the event MULTISET must match the
    # reference's per-pair construction — see _near_events.
    nE1, nE2, = _near_events(paths, inv, tom, tol, llens)
    if nE1.size:
        order = np.lexsort((nE2, nE1))
        nE1, nE2 = nE1[order], nE2[order]
        nb = np.empty(nE1.size, dtype=bool)
        nb[0] = True
        nb[1:] = (nE1[1:] != nE1[:-1]) | (nE2[1:] != nE2[:-1])
        run_start = np.flatnonzero(nb)
        run_count = np.diff(np.append(run_start, nE1.size))
        u1, u2 = nE1[run_start], nE2[run_start]
    else:
        u1 = u2 = np.zeros(0, dtype=np.int64)
        run_count = np.zeros(0, dtype=np.int64)
    # max multiplicity of any single partner per endpoint — what the
    # reference reads off sorted nears1[e1]/nears2[e2] run lengths
    max_alt1 = np.zeros(E, dtype=np.int64)
    max_alt2 = np.zeros(E, dtype=np.int64)
    if u1.size:
        np.maximum.at(max_alt1, u1, run_count)
        np.maximum.at(max_alt2, u2, run_count)

    # ---- link counting with graph-proximity exclusion ----------------
    links = []
    counts = []
    for e1, e2, cnt in zip(u1.tolist(), u2.tolist(), run_count.tolist()):
        # BFS within max_depth/max_int around e1 (and its solo predecessor)
        close = False
        x = [e1]
        d = [-1]
        kk = [0]
        if len(ins(int(to_left[e1]))) == 1:
            x.append(ins(int(to_left[e1]))[0])
            d.append(-1)
            kk.append(0)
        jx = 0
        while jx < len(x):
            e = x[jx]
            if e == e2:
                close = True
                break
            if kk[jx] <= MAX_INT and d[jx] != MAX_DEPTH:
                v, w = int(to_right[e]), int(to_left[e])
                for e_ in outs(v) + ins(w):
                    x.append(e_)
                    d.append(d[jx] + 1)
                    kk.append(kk[jx] + int(kmers[e_]))
            jx += 1
        if not close:
            links.append((int(tom[e1]), int(tom[e2])))
            counts.append(int(cnt))

    order = np.argsort(
        np.array([l[0] * (E + 1) + l[1] for l in links]) if links else []
    )
    links = [links[i] for i in order]
    counts = [counts[i] for i in order]

    # ---- acceptance filters ------------------------------------------
    def advance_bubbles(e1, e2):
        for _ in range(PASSES):
            v = int(to_right[e1])
            if len(ins(v)) != 1 or len(outs(v)) != 2:
                break
            o = outs(v)
            if int(to_right[o[0]]) != int(to_right[o[1]]):
                break
            w = int(to_right[o[0]])
            if len(ins(w)) != 2 or len(outs(w)) != 1:
                break
            e1 = outs(w)[0]
        for _ in range(PASSES):
            v = int(to_left[e2])
            if len(outs(v)) != 1 or len(ins(v)) != 2:
                break
            ii = ins(v)
            if int(to_left[ii[0]]) != int(to_left[ii[1]]):
                break
            w = int(to_left[ii[0]])
            if len(outs(w)) != 2 or len(ins(w)) != 1:
                break
            e2 = ins(w)[0]
        return e1, e2

    accepted = []
    for (e1, e2), c in zip(links, counts):
        if c < min_link_count:
            continue
        if tol[e1] < 0 or tol[e2] < 0:
            continue
        if llens[tol[e1]] < min_line or llens[tol[e2]] < min_line:
            continue
        c1, c2 = cov[tol[e1]], cov[tol[e2]]
        if c1 < c2:
            c1, c2 = c2, c1
        if c2 <= 0 or c1 / c2 - 1.0 > MAX_COV_PC_OFF / 100.0:
            continue
        max_alt = max(int(max_alt1[e1]), int(max_alt2[e2]))
        if max_alt > c:
            continue
        e1x, e2x = advance_bubbles(e1, e2)
        l1, l2 = int(tol[e1x]), int(tol[e2x])
        if l1 < 0 or l2 < 0:
            continue
        if lines[l1][-1][0][0] != e1x or lines[l2][0][0][0] != e2x:
            continue
        accepted.append((e1, e2))

    # 1-to-1
    from collections import Counter

    c1 = Counter(a for a, _ in accepted)
    c2 = Counter(b for _, b in accepted)
    accepted = [
        (a, b) for a, b in accepted if c1[a] == 1 and c2[b] == 1
    ]
    # advance past bubbles on the accepted pairs
    accepted = [advance_bubbles(a, b) for a, b in accepted]
    accepted = sorted(set(accepted))
    # force symmetry
    aset = set(accepted)
    xa1 = {a for a, _ in accepted}
    xa2 = {b for _, b in accepted}
    add, drop = [], set()
    for a, b in accepted:
        ra, rb = int(inv[a]), int(inv[b])
        if (rb, ra) not in aset:
            if rb not in xa1 and ra not in xa2:
                add.append((rb, ra))
            else:
                drop.add((a, b))
    accepted = sorted((set(accepted) - drop) | set(add))
    # overlinked
    c1 = Counter(a for a, _ in accepted)
    c2 = Counter(b for _, b in accepted)
    accepted = [
        (a, b)
        for a, b in accepted
        if c1[a] <= 1 and c2[b] <= 1
    ]

    if not accepted:
        return hbv, paths, 0

    # ---- graph edit: insert 0-length gap edges -----------------------
    nV = hbv.n_vertices
    gap_edges = []
    for a, b in accepted:
        to_right[a] = nV
        to_left[b] = nV + 1
        gap_edges.append((nV, nV + 1))
        nV += 2
    hbv.to_left = to_left
    hbv.to_right = to_right
    hbv.n_vertices = nV
    E0 = hbv.n_edges
    ng = len(gap_edges)
    hbv.edge_start = np.concatenate(
        [hbv.edge_start, np.full(ng, hbv.edge_start[-1], dtype=np.int64)]
    )
    hbv.to_left = np.concatenate(
        [hbv.to_left, np.array([v for v, _ in gap_edges], np.int32)]
    )
    hbv.to_right = np.concatenate(
        [hbv.to_right, np.array([w for _, w in gap_edges], np.int32)]
    )
    # involution: gap of (a,b) <-> gap of (inv b, inv a)
    pair_pos = {p: i for i, p in enumerate(accepted)}
    inv_new = np.zeros(ng, dtype=np.int32)
    for i, (a, b) in enumerate(accepted):
        ri = pair_pos[(int(inv[b]), int(inv[a]))]
        inv_new[i] = E0 + ri
    hbv.inv = np.concatenate([hbv.inv, inv_new])

    # ---- truncate crossing paths -------------------------------------
    # Vectorized (was a per-read Python loop): cut each path after the
    # FIRST split-after edge (if not already last), then keep from the
    # LAST split-before edge within the cut path, shifting start by the
    # kmers dropped on the left.
    if paths.edges.size:
        mask_after = np.zeros(E, dtype=bool)
        mask_after[np.fromiter((a for a, _ in accepted), dtype=np.int64)] = True
        mask_before = np.zeros(E, dtype=bool)
        mask_before[np.fromiter((b for _, b in accepted), dtype=np.int64)] = True
        off = paths.offsets
        pe = paths.edges
        plen = np.diff(off)
        n = paths.n_reads
        read_of = np.repeat(np.arange(n, dtype=np.int64), plen)
        pos = np.arange(pe.size, dtype=np.int64) - off[read_of]
        cand = mask_after[pe] & (pos + 1 < plen[read_of])
        first_after = np.full(n, np.int64(1) << 62, dtype=np.int64)
        np.minimum.at(first_after, read_of[cand], pos[cand])
        new_end = np.minimum(plen, first_after + 1)
        candb = mask_before[pe] & (pos < new_end[read_of])
        last_before = np.zeros(n, dtype=np.int64)
        np.maximum.at(last_before, read_of[candb], pos[candb])
        # start shift: within-read exclusive kmer prefix at last_before
        km = kmers[pe].astype(np.int64)
        cum = np.cumsum(km)
        excl = np.concatenate([np.zeros(1, dtype=np.int64), cum[:-1]])
        hi = max(pe.size - 1, 0)
        shift = (
            excl[np.minimum(off[:-1] + last_before, hi)]
            - excl[np.minimum(off[:-1], hi)]
        )
        starts = paths.start.astype(np.int64) - shift
        new_len = np.where(plen > 0, new_end - last_before, 0)
        noff = np.zeros(n + 1, dtype=np.int64)
        noff[1:] = np.cumsum(new_len)
        tot = int(noff[-1])
        src = np.repeat(off[:-1] + last_before, new_len) + (
            np.arange(tot, dtype=np.int64) - np.repeat(noff[:-1], new_len)
        )
        paths = ReadPathVec(noff, pe[src].astype(np.int32),
                            starts.astype(np.int32))

    if gap_cleanup:
        hbv, paths = ops.remove_small_components(
            hbv, paths, remove_small_cycles=True
        )
        hbv, paths = ops.squeeze(hbv, paths)
    return hbv, paths, len(accepted)
