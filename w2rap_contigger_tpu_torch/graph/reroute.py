"""ReroutePaths + DeleteFunkyPathPairs — Simplify's opening passes.

Reference: ReroutePaths (src/paths/long/large/GapToyTools5.cc:416-580):
for each fully-placed read, enumerate nearby alternative placements
(depth<=3 start moves, <=200 candidate paths), score by qual-weighted
mismatches, and adopt a strictly better placement.

DeleteFunkyPathPairs (GapToyTools4.cc:814-930): clear read-pair
placements that cannot belong to a plausible (<=1300bp) fragment.
"""

from __future__ import annotations

import numpy as np

MAX_DEPTH = 3
MAX_PATHS = 200
MAX_QSUM = 100


def _cat(hbv, edge_list):
    k = hbv.k
    if len(edge_list) == 1:
        # read-only use downstream: a view avoids copying what can be a
        # multi-megabase edge once per read
        return hbv.edge_seq(int(edge_list[0]))
    b = hbv.edge_seq(int(edge_list[0])).copy()
    for e in edge_list[1:]:
        b = np.concatenate([b, hbv.edge_seq(int(e))[k - 1 :]])
    return b


def reroute_paths(hbv, paths, reads):
    """Returns updated ReadPathVec (same structure, improved placements).

    Vectorized prefilter: a fully-placed single-edge read whose edge has
    no in-edges on the left vertex and no out-edges on the right vertex
    can gain no alternative placement, so the per-read search loop only
    visits reads where rerouting is possible (on a well-assembled genome
    that excludes nearly everything).
    """
    from ..paths.read_paths import ReadPathVec

    kmers = np.asarray(hbv.edge_kmers())
    elens = np.asarray(hbv.edge_len())
    fo, fe, to, te = hbv.vertex_csr()
    to_left, to_right = hbv.to_left, hbv.to_right
    in_deg = np.diff(to)
    out_deg = np.diff(fo)

    off_arr = np.asarray(paths.offsets)
    plens = np.diff(off_arr)
    starts_arr = np.asarray(paths.start)
    first_edge = np.where(
        plens > 0, np.asarray(paths.edges)[np.minimum(off_arr[:-1],
                                                      len(paths.edges) - 1)], 0
    )
    single = plens == 1
    fits1 = single & (
        starts_arr.astype(np.int64) + np.asarray(reads.lengths)
        <= elens[first_edge]
    ) & (starts_arr >= 0)
    isolated = (
        fits1
        & (in_deg[np.asarray(to_left)[first_edge]] == 0)
        & (out_deg[np.asarray(to_right)[first_edge]] == 0)
    )
    # a placement scoring qsum == 0 can never lose to a strictly-better
    # alternative (the adoption test keeps the original on ties,
    # GapToyTools5.cc:545-560), so perfectly-matching single-edge reads
    # skip the per-read candidate search entirely — one batched gather
    # scores them all (the bulk of reads on a well-corrected graph)
    perfect = np.zeros(len(plens), dtype=bool)
    cand1 = np.flatnonzero(fits1 & ~isolated)
    if cand1.size:
        Lmax = reads.bases.shape[1]
        e1 = first_edge[cand1]
        base_idx = (
            np.asarray(hbv.edge_start)[e1].astype(np.int64)
            + starts_arr[cand1].astype(np.int64)
        )[:, None] + np.arange(Lmax, dtype=np.int64)[None, :]
        # fits1 guarantees start + len <= edge length; clamp the pad tail
        base_idx = np.minimum(base_idx, len(hbv.edge_bases) - 1)
        seg = np.asarray(hbv.edge_bases)[base_idx]
        inlen = (
            np.arange(Lmax, dtype=np.int64)[None, :]
            < np.asarray(reads.lengths)[cand1][:, None]
        )
        mism = inlen & (reads.bases[cand1] != seg)
        qs1 = np.where(mism, reads.quals[cand1], 0).sum(axis=1)
        perfect[cand1[qs1 == 0]] = True
    todo = np.flatnonzero((plens > 0) & ~isolated & ~perfect)

    changed: dict[int, tuple] = {}
    new_starts = paths.start.astype(np.int64).copy()
    improveds = 0
    for rid in todo:
        rid = int(rid)
        p = [int(x) for x in paths.path(rid)]
        off = int(paths.start[rid])
        if not p or off < 0:
            continue
        s = off
        for j in range(1, len(p)):
            s -= int(kmers[p[j - 1]])
        n = int(reads.lengths[rid])
        if s + n > elens[p[-1]]:
            continue  # not a full placement

        # candidate starts (depth-limited moves over neighbors)
        starts = [(p[0], off)]
        seen = {(p[0], off)}
        depth = [0]
        i = 0
        while i < len(starts):
            if depth[i] < MAX_DEPTH:
                e, st = starts[i]
                v, w = int(to_left[e]), int(to_right[e])
                for ex in te[to[v] : to[v + 1]]:
                    cand = (int(ex), st + int(kmers[ex]))
                    if cand not in seen:
                        seen.add(cand)
                        starts.append(cand)
                        depth.append(depth[i] + 1)
                for ex in fe[fo[w] : fo[w + 1]]:
                    cand = (int(ex), st - int(kmers[e]))
                    if cand not in seen:
                        seen.add(cand)
                        starts.append(cand)
                        depth.append(depth[i] + 1)
            i += 1

        ps = [
            ([e], st)
            for e, st in starts
            if 0 <= st < elens[e]
        ]
        # extend paths until the read fits
        i = 0
        overflow = False
        dels = []
        while i < len(ps):
            if i >= MAX_PATHS:
                break
            q, st = ps[i]
            send = st
            for j in range(1, len(q)):
                send -= int(kmers[q[j - 1]])
            if send + n <= elens[q[-1]]:
                i += 1
                continue
            dels.append(i)
            v = int(to_right[q[-1]])
            for ex in fe[fo[v] : fo[v + 1]]:
                ps.append((q + [int(ex)], st))
            i += 1
        if len(ps) > MAX_PATHS:
            continue
        ps = [x for j, x in enumerate(ps) if j not in set(dels)]
        if not ps:
            continue
        if len(ps) == 1 and ps[0][0] == p and ps[0][1] == off:
            # only candidate is the current placement: nothing to score
            continue

        rb = reads.bases[rid][:n]
        rq = reads.quals[rid][:n].astype(np.int64)
        scored = []
        for q, st in ps:
            b = _cat(hbv, q)
            seg = b[st : st + n]
            if len(seg) < n:
                continue
            qs = int(np.sum(rq[rb != seg]))
            scored.append((qs, -len(q), q, st))
        if not scored:
            continue
        qorig = None
        for qs, negsz, q, st in scored:
            if q == p and st == off:
                qorig = qs
        scored.sort(key=lambda t: (t[0], t[1]))
        # original best already optimal?
        if any(
            q == p and qs == scored[0][0] for qs, _, q, st in scored
        ):
            continue
        if scored[0][0] > MAX_QSUM:
            continue
        improveds += 1
        ooo = scored[0][0]
        # drop fully-tied leading pairs (reference quirk, GapToyTools5.cc:550)
        while len(scored) >= 2 and scored[0][:2] == scored[1][:2]:
            scored = scored[2:]
        if not scored:
            continue
        best_qs, best_negsz = scored[0][0], scored[0][1]
        scored = [
            t
            for j, t in enumerate(scored)
            if j == 0 or not (t[0] == best_qs and -t[1] < -best_negsz)
        ]
        if ooo < scored[0][0]:
            continue
        changed[rid] = tuple(scored[0][2])
        new_starts[rid] = scored[0][3]
    if not changed:
        return ReadPathVec(
            paths.offsets.copy(), paths.edges.copy(),
            new_starts.astype(np.int32),
        ), improveds
    # patch only the changed reads into fresh flat arrays
    n = paths.n_reads
    new_lens = plens.copy()
    for rid, q in changed.items():
        new_lens[rid] = len(q)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(new_lens, out=offsets[1:])
    flat = np.zeros(int(offsets[-1]), dtype=np.int32)
    unchanged = np.ones(n, dtype=bool)
    for rid in changed:
        unchanged[rid] = False
    # bulk-copy unchanged reads' slices (vectorized ragged ranges)
    sel = np.flatnonzero(unchanged & (plens > 0))
    if sel.size:
        l = plens[sel]
        within = np.arange(int(l.sum()), dtype=np.int64) - np.repeat(
            np.cumsum(l) - l, l
        )
        src_idx = np.repeat(off_arr[:-1][sel], l) + within
        dst_idx = np.repeat(offsets[:-1][sel], l) + within
        flat[dst_idx] = np.asarray(paths.edges)[src_idx]
    for rid, q in changed.items():
        flat[offsets[rid] : offsets[rid + 1]] = q
    return ReadPathVec(offsets, flat, new_starts.astype(np.int32)), improveds


def delete_funky_path_pairs(hbv, paths, reads):
    """Clear placements of implausible pairs (GapToyTools4.cc:814)."""
    from ..paths.read_paths import ReadPathVec

    MIN_FRAG, MAX_FRAG = 50, 1300
    MAX_EXTS = 10
    inv = hbv.inv
    kmers = hbv.edge_kmers()
    elens = hbv.edge_len()
    fo, fe, to, te = hbv.vertex_csr()
    to_right = hbv.to_right

    # approximate distances to graph ends (20 backward passes from sinks)
    V = hbv.n_vertices
    D = np.full(V, 10**9, dtype=np.int64)
    outdeg = hbv.out_degree()
    xc = list(np.flatnonzero(outdeg == 0))
    for v in xc:
        D[v] = 0
    for _ in range(20):
        xc2 = []
        for v in xc:
            for e in te[to[v] : to[v + 1]]:
                w = int(hbv.to_left[e])
                nd = D[v] + int(kmers[e])
                if nd < D[w]:
                    D[w] = nd
                xc2.append(w)
        xc = xc2

    npids = paths.n_reads // 2
    invalid = np.zeros(npids, dtype=bool)
    for pid in range(npids):
        id1, id2 = 2 * pid, 2 * pid + 1
        p1 = [int(x) for x in paths.path(id1)]
        p2 = [int(x) for x in paths.path(id2)]
        if not p1 or not p2:
            continue
        x1 = p1
        x2 = [int(inv[e]) for e in p2[::-1]]
        if p1 == p2:
            invalid[pid] = True
            continue
        start1 = int(paths.start[id1])
        start2 = int(elens[p2[0]]) - int(paths.start[id2])
        if len(x1) == 1 and x1 == x2 and MIN_FRAG <= start2 - start1 <= MAX_FRAG:
            continue
        n1, n2 = int(reads.lengths[id1]), int(reads.lengths[id2])
        d1 = int(elens[p1[0]]) - int(paths.start[id1]) - n1 + int(
            D[to_right[p1[-1]]]
        )
        for j in range(1, len(p1)):
            d1 -= int(kmers[p1[j]])
        d2 = int(elens[p2[0]]) - int(paths.start[id2]) - n2 + int(
            D[to_right[p2[-1]]]
        )
        for j in range(1, len(p2)):
            d2 -= int(kmers[p2[j]])
        if d1 + d2 + n1 + n2 <= MAX_FRAG:
            continue
        # BFS: does some extension of x1 end with x2 at plausible sep?
        cand = [x1]
        good = False
        for e_round in range(MAX_EXTS + 1):
            for pth in cand:
                if len(x2) <= len(pth) and pth[len(pth) - len(x2) :] == x2:
                    s1 = start1
                    for l in range(len(pth) - 1):
                        s1 -= int(kmers[pth[l]])
                    if MIN_FRAG <= start2 - s1 <= MAX_FRAG:
                        good = True
                        break
            if good:
                break
            nxt = []
            for pth in cand:
                v = int(to_right[pth[-1]])
                for ex in fe[fo[v] : fo[v + 1]]:
                    x = pth + [int(ex)]
                    nkm = sum(int(kmers[m]) for m in x[1:-1])
                    if nkm < MAX_FRAG:
                        nxt.append(x)
            cand = nxt
            if not cand:
                break
            if e_round == MAX_EXTS:
                good = True  # reference gives up and keeps the pair
        if not good:
            invalid[pid] = True

    if not invalid.any():
        return paths, 0
    # clear both mates of invalid pairs
    lists = [
        [] if (i // 2 < npids and invalid[i // 2]) else [int(x) for x in paths.path(i)]
        for i in range(paths.n_reads)
    ]
    starts = np.where(
        np.repeat(invalid, 2).astype(bool)[: paths.n_reads]
        if 2 * npids == paths.n_reads
        else np.zeros(paths.n_reads, bool),
        0,
        paths.start,
    )
    return ReadPathVec.from_lists(lists, starts.astype(np.int32)), int(
        invalid.sum()
    )
