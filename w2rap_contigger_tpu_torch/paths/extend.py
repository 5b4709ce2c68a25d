"""Qual-scored read-path extension — ExtendReadPath equivalent.

Reference: src/paths/long/ExtendReadPath.cc (attemptLeftwardExtension /
attemptRightwardExtension / scoreLeft/RightOverlap).  A read whose path
leaves >= 10 unexplained bases at either end is extended across the
adjacent vertex onto the candidate edge with the lowest quality-weighted
mismatch score, accepted when score <= 10 * gap.

The scoring model (scoreRightOverlap, ExtendReadPath.cc:30-90): per
mismatching base, penalty += qual (Q2 mapped to 20) and score += penalty;
per matching base penalty decays by 20%; read bases running past the edge
end cost 10 each.

TPU-first shape: instead of per-read recursion, extension runs in rounds —
all extendable reads score their <=4 candidate edges in one vectorized
sweep per round (the inner base scan is a fixed-length masked loop).
"""

from __future__ import annotations

import numpy as np

PENALTY_DECAY = 0.2
MAP_Q2 = 20
LEFTOVER_PENALTY = 10
MIN_GAP = 10
MAX_ROUNDS = 200


class _Graph:
    """Padded adjacency scratch for extension rounds."""

    def __init__(self, hbv):
        self.hbv = hbv
        self.k = hbv.k
        E, V = hbv.n_edges, hbv.n_vertices
        self.elen = hbv.edge_len()
        self.ekmers = self.elen - self.k + 1
        self.out_deg = hbv.out_degree()
        self.in_deg = hbv.in_degree()
        fo, fe, to, te = hbv.vertex_csr()
        self.fo, self.fe, self.to, self.te = fo, fe, to, te
        maxdeg = 4
        self.out_pad = np.full((V, maxdeg), -1, dtype=np.int32)
        self.in_pad = np.full((V, maxdeg), -1, dtype=np.int32)
        for v in range(V):
            oe = fe[fo[v] : fo[v + 1]][:maxdeg]
            self.out_pad[v, : len(oe)] = oe
            ie = te[to[v] : to[v + 1]][:maxdeg]
            self.in_pad[v, : len(ie)] = ie
        # edge base pool as one padded matrix would be too big; keep flat
        self.bases = hbv.edge_bases
        self.start = hbv.edge_start


def _candidate_filter(cand, g: _Graph, gaps, right: bool):
    """Replicates the short/long/hanging candidate gating.

    cand: (R, 4) padded candidate edges; returns (scoreable (R,4) bool,
    proceed (R,) bool)."""
    R = cand.shape[0]
    valid = cand >= 0
    ncand = valid.sum(axis=1)
    ce = np.clip(cand, 0, None)
    if right:
        vdest = g.hbv.to_right[ce]
        hang = (g.out_deg[vdest] == 0) & (g.in_deg[vdest] == 1)
        dest_deg = g.out_deg
    else:
        vdest = g.hbv.to_left[ce]
        hang = (g.in_deg[vdest] == 0) & (g.out_deg[vdest] == 1)
        dest_deg = g.in_deg
    elong = (g.elen[ce] - (g.k - 1)) >= gaps[:, None]
    hang &= valid
    elong &= valid
    is_short = valid & ~elong & ~hang

    proceed = np.ones(R, dtype=bool)
    multi = ncand > 1
    has_short = is_short.any(axis=1)
    nlong = elong.sum(axis=1)
    # rule: with multiple candidates and any short edge present, require
    # no long edges, all short edges -> same dest with degree 1
    sd = np.where(is_short, vdest, -1)
    sd_max = sd.max(axis=1)
    same_dest = np.all((sd == -1) | (sd == sd_max[:, None]), axis=1)
    dest_ok = dest_deg[np.clip(sd_max, 0, None)] == 1
    bad = multi & has_short & ((nlong > 0) | ~same_dest | ~dest_ok)
    proceed &= ~bad

    scoreable = valid & (~hang | (ncand == 1)[:, None])
    return scoreable, proceed


def extend_paths(reads, paths, hbv):
    """In-place attemptLeftRightExtension over all reads.

    reads: ReadSet; paths: ReadPathVec (modified and returned).
    """
    g = _Graph(hbv)
    k = g.k
    n = paths.n_reads
    L = reads.max_len

    # mutable per-read state
    plen = paths.path_len().astype(np.int64)
    start = paths.start.astype(np.int64).copy()
    first_edge = np.full(n, -1, dtype=np.int32)
    last_edge = np.full(n, -1, dtype=np.int32)
    ksum = np.zeros(n, dtype=np.int64)  # sum of edge_kmers over path
    nz = plen > 0
    first_edge[nz] = paths.edges[paths.offsets[:-1][nz]]
    last_edge[nz] = paths.edges[paths.offsets[1:][nz] - 1]
    if len(paths.edges):
        rid = np.repeat(np.arange(n), plen)
        np.add.at(ksum, rid, g.ekmers[paths.edges])

    prepends = {}
    appends = {}

    # ---- leftward rounds ---------------------------------------------
    # a read stays in play while its extensions succeed (the reference's
    # per-read `while(attemptLeftwardExtension(...))`)
    active = nz.copy()
    for _ in range(MAX_ROUNDS):
        gaps = -start
        cand_r = np.flatnonzero(active & (start < 0) & (gaps >= MIN_GAP))
        if len(cand_r) == 0:
            break
        vleft = hbv.to_left[first_edge[cand_r]]
        cand = g.in_pad[vleft]  # (R,4) in-edges of vleft
        scoreable, proceed = _candidate_filter(
            cand, g, gaps[cand_r], right=False
        )
        accepted = _score_and_pick(
            reads, cand_r, cand, scoreable & proceed[:, None], g,
            gaps[cand_r], left=True,
        )
        active[cand_r] = False
        for r, e in accepted:
            prepends.setdefault(r, []).append(e)
            first_edge[r] = e
            start[r] += g.ekmers[e]
            ksum[r] += g.ekmers[e]
            active[r] = True
        if not len(accepted):
            break

    # ---- rightward rounds --------------------------------------------
    rlen = reads.lengths.astype(np.int64)
    active = nz.copy()
    for _ in range(MAX_ROUNDS):
        gaps = rlen + start - ksum - (k - 1)
        cand_r = np.flatnonzero(active & (gaps >= MIN_GAP))
        if len(cand_r) == 0:
            break
        vright = hbv.to_right[last_edge[cand_r]]
        cand = g.out_pad[vright]
        scoreable, proceed = _candidate_filter(
            cand, g, gaps[cand_r], right=True
        )
        accepted = _score_and_pick(
            reads, cand_r, cand, scoreable & proceed[:, None], g,
            gaps[cand_r], left=False,
        )
        active[cand_r] = False
        for r, e in accepted:
            appends.setdefault(r, []).append(e)
            last_edge[r] = e
            ksum[r] += g.ekmers[e]
            active[r] = True
        if not len(accepted):
            break

    if not prepends and not appends:
        return paths

    # ---- rebuild ragged paths ----------------------------------------
    from .read_paths import ReadPathVec

    new_lens = plen.copy()
    for r, es in prepends.items():
        new_lens[r] += len(es)
    for r, es in appends.items():
        new_lens[r] += len(es)
    new_off = np.zeros(n + 1, dtype=np.int64)
    new_off[1:] = np.cumsum(new_lens)
    flat = np.zeros(int(new_off[-1]), dtype=np.int32)
    npre = np.zeros(n, dtype=np.int64)
    for r, es in prepends.items():
        npre[r] = len(es)
    # bulk copy of original path elements (vectorized)
    if len(paths.edges):
        orig_rid = np.repeat(np.arange(n), plen)
        orig_local = np.arange(len(paths.edges)) - np.repeat(
            paths.offsets[:-1], plen
        )
        dst = new_off[orig_rid] + npre[orig_rid] + orig_local
        flat[dst] = paths.edges
    for r, es in prepends.items():
        flat[new_off[r] : new_off[r] + len(es)] = es[::-1]
    for r, es in appends.items():
        flat[new_off[r + 1] - len(es) : new_off[r + 1]] = es
    return ReadPathVec(new_off, flat, start.astype(np.int32))


def _score_and_pick(reads, cand_r, cand, scoreable, g, gaps, left):
    """Score all (read, candidate) rows; return [(read, edge)] accepted."""
    R = len(cand_r)
    rows_r, rows_c = np.nonzero(scoreable)
    if len(rows_r) == 0:
        return []
    rb = reads.bases[cand_r[rows_r]]
    rq = reads.quals[cand_r[rows_r]]
    # reference scans the read's first/last `gap` bases; our (N,L) rows
    # are 0-padded past `length`, so clamp the right-scan origin to length
    scores = _score_overlap_rows(
        rb, rq, reads.lengths[cand_r[rows_r]], cand[rows_r, rows_c], g,
        gaps[rows_r], left,
    )
    best = {}
    for i in range(len(rows_r)):
        r = rows_r[i]
        s = scores[i]
        if r not in best or s < best[r][0]:
            best[r] = (s, int(cand[r, rows_c[i]]))
    out = []
    for r, (s, e) in best.items():
        if s <= gaps[r] * 10:
            out.append((int(cand_r[r]), e))
    return out


def _score_overlap_rows(read_b, read_q, read_len, edge, g, gaps, left):
    """scoreLeft/RightOverlap on explicit rows."""
    R, L = read_b.shape
    k = g.k
    elen = g.elen[edge]
    avail_edge = elen - (k - 1)
    ncmp = np.minimum(gaps, avail_edge)
    leftover = np.maximum(gaps - avail_edge, 0)
    qsum = np.zeros(R, dtype=np.float64)
    penalty = np.zeros(R, dtype=np.float64)
    maxg = int(gaps.max()) if R else 0
    estart = g.start[edge]
    ar = np.arange(R)
    for t in range(maxg):
        active = t < ncmp
        if not active.any():
            break
        if left:
            ridx = np.maximum(gaps - 1 - t, 0)
            eidx = np.maximum(elen - k - t, 0)
        else:
            ridx = np.minimum(read_len - gaps + t, read_len - 1)
            eidx = np.minimum(k - 1 + t, elen - 1)
        rb = read_b[ar, ridx]
        rq = read_q[ar, ridx]
        eb = g.bases[estart + eidx]
        mism = active & (rb != eb)
        q = np.where(rq == 2, MAP_Q2, rq).astype(np.float64)
        penalty = np.where(mism, penalty + q, penalty)
        qsum = np.where(mism, qsum + penalty, qsum)
        match = active & ~mism & (penalty > 0)
        penalty = np.where(
            match, np.floor(penalty - PENALTY_DECAY * penalty), penalty
        )
    qsum += leftover * LEFTOVER_PENALTY
    return qsum


# ---------------------------------------------------------------------------
# ExtendPath2 — Simplify's EXT_FINAL pass
# ---------------------------------------------------------------------------


def _sorted_qsum(qsums):
    """SortSync(qsum, ids) with the reference's small-vec insertion sort
    (stable ascending)."""
    import numpy as _np

    q = _np.asarray(qsums)
    order = _np.argsort(q, kind="stable")
    return q[order], order


def extend_path2(p, start, hbv, g, read_b, read_q, read_len, min_gain, mode):
    """ExtendPath2 for one read (GapToyTools4.cc:370-460).

    p: python list of edge ids (mutated); start: signed offset.
    Returns (p, stored_offset) where stored_offset mirrors the
    reference's setOffset(min(start, 0)) clamping during left extension.
    """
    import numpy as _np

    K = hbv.k
    stored = start
    if not p:
        return p, stored
    if start < 0:
        if mode == 0:
            return p, stored
        # leftward extension (GapToyTools4.cc:385-419)
        v = int(hbv.to_left[p[0]])
        while g.in_deg[v] > 0 and start < 0:
            ins = g.te[g.to[v] : g.to[v + 1]]
            if len(ins) == 1:
                f = int(ins[0])
                p.insert(0, f)
                v = int(hbv.to_left[f])
                start += int(g.ekmers[f])
                stored = min(start, 0)
                continue
            qsums = []
            for f in ins:
                f = int(f)
                nf = int(g.elen[f])
                es = hbv.edge_seq(f)
                qs = 0
                for l in range(K, nf + 1):
                    rpos = -start - (l - K + 1)
                    if rpos < 0:
                        break
                    if read_b[rpos] != es[nf - l]:
                        qs += int(read_q[rpos])
                qsums.append(qs)
            q, order = _sorted_qsum(qsums)
            if q[0] == 0 and q[1] >= min_gain:
                f = int(ins[order[0]])
                p.insert(0, f)
                v = int(hbv.to_left[f])
                start += int(g.ekmers[f])
                stored = min(start, 0)
            else:
                break
        if start < 0:
            return p, stored

    rstop = int(g.elen[p[0]]) - start
    for e in p[1:]:
        rstop += int(g.ekmers[e])
    ext = int(read_len) - rstop
    if ext <= 0:
        return p, stored
    v = int(hbv.to_right[p[-1]])
    if g.out_deg[v] == 0:
        return p, stored
    # rightward extension (GapToyTools4.cc:432-459); note the reference
    # keeps comparing candidate edges against the ORIGINAL rstop
    while g.out_deg[v] > 0:
        outs = g.fe[g.fo[v] : g.fo[v + 1]]
        if len(outs) == 1:
            e = int(outs[0])
            p.append(e)
            v = int(hbv.to_right[e])
            ext -= int(g.ekmers[e])
            if ext < 0:
                break
            continue
        qsums = []
        for f in outs:
            f = int(f)
            es = hbv.edge_seq(f)
            qs = 0
            for l in range(K - 1, int(g.elen[f])):
                rpos = rstop + l - (K - 1)
                if rpos >= read_len:
                    break
                if read_b[rpos] != es[l]:
                    qs += int(read_q[rpos])
            qsums.append(qs)
        q, order = _sorted_qsum(qsums)
        if q[0] == 0 and q[1] >= min_gain:
            e = int(outs[order[0]])
            p.append(e)
            v = int(hbv.to_right[e])
            ext -= int(g.ekmers[e])
            if ext < 0:
                break
        else:
            break
    return p, stored


def ext_final(hbv, paths, reads, min_gain: int = 20, mode: int = 1):
    """Simplify's EXT_FINAL loop (Simplify.cc:203-217): ExtendPath2 on
    every read path.  Returns (paths2, n_extended)."""
    import numpy as _np

    from .read_paths import ReadPathVec

    g = _Graph(hbv)
    n = paths.n_reads
    plen = paths.path_len()

    # cheap prefilter: reads that can possibly extend (negative offset or
    # unexplained right tail or at a multi-out vertex boundary)
    changed = {}
    starts = paths.start.astype(_np.int64).copy()
    nz = _np.flatnonzero(plen > 0)
    if len(nz) == 0:
        return paths, 0
    first_e = paths.edges[paths.offsets[:-1][nz]]
    last_e = paths.edges[paths.offsets[1:][nz] - 1]
    ksum = _np.zeros(n, dtype=_np.int64)
    rid = _np.repeat(_np.arange(n), plen)
    _np.add.at(ksum, rid, g.ekmers[paths.edges])
    rstop = _np.zeros(n, dtype=_np.int64)
    rstop[nz] = (
        g.elen[first_e]
        - starts[nz]
        + (ksum[nz] - g.ekmers[first_e])
    )
    ext_amt = reads.lengths.astype(_np.int64) - rstop
    cand = nz[
        (starts[nz] < 0)
        | ((ext_amt[nz] > 0) & (g.out_deg[hbv.to_right[last_e]] > 0))
    ]
    n_ext = 0
    for r in cand:
        r = int(r)
        p_old = [int(e) for e in paths.path(r)]
        p = list(p_old)
        p2, stored = extend_path2(
            p,
            int(starts[r]),
            hbv,
            g,
            reads.bases[r],
            reads.quals[r],
            int(reads.lengths[r]),
            min_gain,
            mode,
        )
        if p2 != p_old or stored != starts[r]:
            changed[r] = p2
            starts[r] = stored
            if p2 != p_old:
                n_ext += 1
    if not changed:
        return paths, 0
    new_lens = plen.copy()
    for r, p in changed.items():
        new_lens[r] = len(p)
    off = _np.zeros(n + 1, dtype=_np.int64)
    off[1:] = _np.cumsum(new_lens)
    flat = _np.zeros(int(off[-1]), dtype=_np.int32)
    local = _np.arange(len(paths.edges)) - _np.repeat(paths.offsets[:-1], plen)
    unchanged = _np.ones(n, dtype=bool)
    for r in changed:
        unchanged[r] = False
    m = unchanged[rid]
    flat[(off[rid] + local)[m]] = paths.edges[m]
    for r, p in changed.items():
        flat[off[r] : off[r] + len(p)] = p
    return ReadPathVec(off, flat, starts.astype(_np.int32)), n_ext
