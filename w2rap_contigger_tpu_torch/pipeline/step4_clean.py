"""Step 4 — clean the large-K graph by quality-weighted read voting.

Reference: Clean200x (src/paths/long/large/Clean200.cc:202-398) +
AnalyzeScores (:391-445) + GetExtensions (:445-470), driver call at
w2rap-contigger.cc:393-409 (min_size=min_size CLI arg, default 0 in our
driver mirrors the reference default behavior; version=2).

Per branch vertex v (>=1 in-edge, >=2 out-edges): enumerate forward
extensions to depth 250 kmers (<=10), score every read touching the
branch against each extension by summing qual at mismatching bases, and
let AnalyzeScores delete dominated branches (max_del=15, min_win=100,
max_lose=50, min_ratio=5).  Two passes; after each, tiny standalone
edges <= min_size kmers are removed and the graph is re-squeezed.
"""

from __future__ import annotations

import numpy as np

from ..graph import ops
from ..paths.read_paths import invert_paths

from ..config import DEFAULT as _H

MAX_EXTS = _H.CLEAN_MAX_EXTS
MAX_RL = _H.CLEAN_MAX_RL
MAX_DEL = _H.CLEAN_MAX_DEL
MIN_WIN = _H.CLEAN_MIN_WIN
MAX_LOSE = _H.CLEAN_MAX_LOSE
MIN_RATIO = _H.CLEAN_MIN_RATIO
NPASSES = _H.CLEAN_NPASSES


def get_extensions(hbv, fo, fe, v, depth):
    """GetExtensions (Clean200.cc:445): forward edge-paths from v of
    total length >= depth kmers (depth shrinks at dead ends), two passes."""
    kmers = hbv.edge_kmers()
    for _pass in (1, 2):
        exts = [[int(e)] for e in fe[fo[v] : fo[v + 1]]]
        i = 0
        while i < len(exts):
            if i >= MAX_EXTS:
                break
            x = exts[i]
            ln = int(np.sum(kmers[x]))
            if ln >= depth:
                i += 1
                continue
            w = int(hbv.to_right[x[-1]])
            outs = fe[fo[w] : fo[w + 1]]
            if len(outs) == 0:
                depth = min(depth, ln)
                i += 1
                continue
            for m, e2 in enumerate(outs):
                if m == 0:
                    exts[i] = x + [int(e2)]
                else:
                    exts.append(x + [int(e2)])
            # reference decrements i to re-process the extended path
        # second pass reruns with the shrunken depth
    return exts, depth


def _cat_edges(hbv, x):
    k = hbv.k
    b = hbv.edge_seq(x[0]).copy()
    for e in x[1:]:
        b = np.concatenate([b, hbv.edge_seq(e)[k - 1 :]])
    return b


def clean200x(hbv, paths, reads, min_size: int = 0, verbosity: int = 0):
    """Returns (hbv2, paths2)."""
    for zpass in range(1, NPASSES + 1):
        hbv, paths = _one_pass(hbv, paths, reads, min_size)
    from ..graph import validate

    validate.test_involution(hbv)
    validate.validate_paths(hbv, paths)
    return hbv, paths


def _collect_tables(hbv, paths, is_branch):
    """Global vectorized read collection for ALL branch vertices at once.

    The reference collects, per branch vertex v, every occurrence of an
    in-edge of v (fwd, start inclusive), every occurrence of an out-edge
    of v not preceded by an in-edge of v (fwd, start exclusive), and the
    involuted variants (Clean200.cc:267-345).  Each of those is a filter
    over the FLAT path-position table: a position p holding edge e
    contributes to vertex to_right[e] / to_left[e] / to_right[inv[e]] /
    to_left[inv[e]] respectively, with the start offset a per-read
    prefix-sum — so one pass over all positions + four
    sort-by-vertex CSR tables replaces the per-vertex Python loops
    (this was 850s of the 16Mbp wall; the reference runs the per-vertex
    work under `omp parallel for`, Clean200.cc:236).

    Returns four (offsets (V+1,), rid, start) CSR triples: fwd_in,
    fwd_out, rc_in, rc_out.
    """
    V = hbv.n_vertices
    inv = hbv.inv
    kmers = hbv.edge_kmers().astype(np.int64)
    n = paths.n_reads
    pe = paths.edges.astype(np.int64)
    plens = paths.path_len()
    rid = np.repeat(np.arange(n, dtype=np.int64), plens)
    npos = len(pe)

    # start offsets: excl = start[rid] - sum(kmers of elements before p)
    csum = np.concatenate([[0], np.cumsum(kmers[pe])])
    pref = csum[:npos] - np.repeat(csum[paths.offsets[:-1]], plens)
    start_excl = paths.start.astype(np.int64)[rid] - pref
    start_incl = start_excl - kmers[pe]

    first = np.zeros(npos, dtype=bool)
    first[paths.offsets[:-1][plens > 0]] = True
    last = np.zeros(npos, dtype=bool)
    last[paths.offsets[1:][plens > 0] - 1] = True
    prev_e = np.concatenate([[0], pe[:-1]])
    next_e = np.concatenate([pe[1:], [0]])

    tr = hbv.to_right.astype(np.int64)
    tl = hbv.to_left.astype(np.int64)
    va = tr[pe]            # fwd in-edge occurrence  -> start_incl
    vb = tl[pe]            # fwd out-edge occurrence -> start_excl
    vc = tr[inv[pe]]       # rc in-edge occurrence   -> start_excl
    vd = tl[inv[pe]]       # rc out-edge occurrence  -> start_incl
    # "out-edge not preceded by an in-edge of v": prev's head is v
    ok_b = first | (tr[prev_e] != vb)
    # rc mirror: next is inv of an in-edge of v
    ok_d = last | (tr[inv[next_e]] != vd)

    def _csr(keys, mask, vals):
        m = mask & is_branch[keys]
        kk = keys[m]
        order = np.argsort(kk, kind="stable")
        kk = kk[order]
        counts = np.bincount(kk, minlength=V)
        offs = np.zeros(V + 1, dtype=np.int64)
        offs[1:] = np.cumsum(counts)
        return offs, rid[m][order], vals[m][order]

    all_m = np.ones(npos, dtype=bool)
    return (
        _csr(va, all_m, start_incl),
        _csr(vb, ok_b, start_excl),
        _csr(vc, all_m, start_excl),
        _csr(vd, ok_d, start_incl),
    )


def _one_pass(hbv, paths, reads, min_size):
    E = hbv.n_edges
    inv = hbv.inv
    kmers = hbv.edge_kmers()
    fo, fe, to, te = hbv.vertex_csr()
    k = hbv.k

    indeg = hbv.in_degree()
    outdeg = hbv.out_degree()
    is_branch = (indeg > 0) & (outdeg > 1)
    branch = np.flatnonzero(is_branch)

    to_delete = []
    if len(branch):
        (ao, ar, av), (bo, br, bv), (co, cr, cv), (do_, dr, dv) = (
            _collect_tables(hbv, paths, is_branch)
        )
    for v in branch:
        v = int(v)
        n = int(outdeg[v])
        depth = MAX_RL
        exts, depth = get_extensions(hbv, fo, fe, v, depth)
        if len(exts) > MAX_EXTS:
            continue
        N = len(exts)
        out_edges = fe[fo[v] : fo[v + 1]].tolist()
        ei = np.array([out_edges.index(x[0]) for x in exts], dtype=np.int64)
        bexts = [_cat_edges(hbv, x) for x in exts]
        win = depth + k - 1
        bmat = np.zeros((N, win), dtype=np.uint8)
        bvalid = np.zeros((N, win), dtype=bool)
        for l, b in enumerate(bexts):
            m = min(win, len(b))
            bmat[l, :m] = b[:m]
            bvalid[l, :m] = True

        # ---- (read, start) pairs: slices of the global CSR tables -----
        pi_ids = np.concatenate([ar[ao[v] : ao[v + 1]], br[bo[v] : bo[v + 1]]])
        pi_st = np.concatenate([av[ao[v] : ao[v + 1]], bv[bo[v] : bo[v + 1]]])
        rpi_ids = np.concatenate(
            [cr[co[v] : co[v + 1]], dr[do_[v] : do_[v + 1]]]
        )
        rpi_st = np.concatenate(
            [cv[co[v] : co[v + 1]], dv[do_[v] : do_[v + 1]]]
        )

        scores = [[] for _ in range(n)]
        _score_block(
            reads, pi_ids, pi_st, bmat, bvalid, ei, n, N, win, scores,
            rc=False, k=k,
        )
        _score_block(
            reads, rpi_ids, rpi_st, bmat, bvalid, ei, n, N, win, scores,
            rc=True, k=k,
        )

        _analyze_scores(hbv, inv, v, scores, to_delete, out_edges)

    # tiny standalone edges (vectorized over vertices)
    if min_size > 0:
        vs = np.flatnonzero((np.diff(to) == 0) & (np.diff(fo) == 1))
        if len(vs):
            e = fe[fo[vs]].astype(np.int64)
            w = hbv.to_right[e].astype(np.int64)
            keep = (
                (w != vs)
                & (np.diff(to)[w] == 1)
                & (np.diff(fo)[w] == 0)
                & (kmers[e] <= min_size)
            )
            to_delete.extend(int(x) for x in e[keep])

    if to_delete:
        hbv, paths = ops.delete_edges(hbv, paths, np.array(to_delete))
    hbv, paths = ops.squeeze(hbv, paths)
    return hbv, paths


def _path_start_before(hbv, paths, id_, j, inclusive):
    """start = offset - sum(kmers of path[0..j]) (incl/excl j)."""
    p = paths.path(id_)
    kmers = hbv.edge_kmers()
    hi = j + 1 if inclusive else j
    return int(paths.start[id_]) - int(np.sum(kmers[p[:hi]]))


def _collect_fwd(hbv, paths, pi_off, pi_read, te, to, fe, fo, v, kmers):
    """Clean200x fwd read collection (Clean200.cc:267-296): reads whose
    path contains an in-edge of v (start incl.) or an out-edge of v not
    preceded by an in-edge of v (start excl.).

    Retained as the reference-shaped per-vertex oracle for tests; the
    pipeline uses the global vectorized `_collect_tables`."""
    out = []
    ins = set(int(e) for e in te[to[v] : to[v + 1]])
    for e in ins:
        for ii in range(pi_off[e], pi_off[e + 1]):
            id_ = int(pi_read[ii])
            p = paths.path(id_)
            for j in np.flatnonzero(p == e):
                out.append((id_, _path_start_before(hbv, paths, id_, int(j), True)))
    for e in fe[fo[v] : fo[v + 1]]:
        e = int(e)
        for ii in range(pi_off[e], pi_off[e + 1]):
            id_ = int(pi_read[ii])
            p = paths.path(id_)
            for j in np.flatnonzero(p == e):
                j = int(j)
                if j > 0 and int(p[j - 1]) in ins:
                    continue
                out.append((id_, _path_start_before(hbv, paths, id_, j, False)))
    return out


def _collect_rc(hbv, paths, pi_off, pi_read, te, to, fe, fo, v, kmers, inv):
    """Clean200x rc read collection (Clean200.cc:316-345)."""
    out = []
    res = set(int(inv[e]) for e in te[to[v] : to[v + 1]])
    for re_ in res:
        for ii in range(pi_off[re_], pi_off[re_ + 1]):
            id_ = int(pi_read[ii])
            p = paths.path(id_)
            for j in np.flatnonzero(p == re_):
                out.append((id_, _path_start_before(hbv, paths, id_, int(j), False)))
    for e in fe[fo[v] : fo[v + 1]]:
        rep = int(inv[e])
        for ii in range(pi_off[rep], pi_off[rep + 1]):
            id_ = int(pi_read[ii])
            p = paths.path(id_)
            for j in np.flatnonzero(p == rep):
                j = int(j)
                if j < len(p) - 1 and int(p[j + 1]) in res:
                    continue
                out.append((id_, _path_start_before(hbv, paths, id_, j, True)))
    return out


def _score_block(reads, ids, st, bmat, bvalid, ei, n, N, win, scores, rc, k):
    """Qual-mismatch scoring (Clean200.cc:296-315,345-365) as matmuls:
    q[r, l] = sum_w rqual.(okr & ev & rbase != eb)
            = (masked_qual @ ev.T) - sum_b (masked_qual.(rbase==b)) @
              (ev.(eb==b)).T
    — integer values stay < 2^24 so float32 BLAS accumulation is exact
    (and the (R, win) x (win, N) shape is MXU-shaped on device)."""
    if len(ids) == 0:
        return
    ids = np.asarray(ids, dtype=np.int64)
    st = np.asarray(st, dtype=np.int64)
    # overlap prefilter: a read whose placement misses the extension
    # window entirely scores 0 on EVERY branch (okr all-false), ties,
    # and can never vote — drop it before the (R, win) planes.  On
    # near-finished graphs the collection holds every read of the
    # mega-edges flanking a branch (measured: 3 branch vertices x
    # millions of rows = 219s/pass at 16Mbp; ~all rows no-overlap).
    rlen_all = np.asarray(reads.lengths)[ids].astype(np.int64)
    if not rc:
        keep = (st < win) & (st + rlen_all > 0)
    else:
        keep = (st <= k - 2) & (st >= k - rlen_all - win)
    ids, st = ids[keep], st[keep]
    if len(ids) == 0:
        return
    R = len(ids)
    rb = reads.bases[ids]  # (R, L)
    rq = reads.quals[ids]
    rlen = reads.lengths[ids].astype(np.int32)
    L = rb.shape[1]
    pos = np.arange(win, dtype=np.int32)
    st32 = st.astype(np.int32)
    if not rc:
        # rpos = pos - start
        rpos = pos[None, :] - st32[:, None]
    else:
        # rpos = K - 2 - pos - start
        rpos = np.int32(k - 2) - pos[None, :] - st32[:, None]
    okr = (rpos >= 0) & (rpos < rlen[:, None])
    rposc = np.clip(rpos, 0, L - 1)
    rbase = np.take_along_axis(rb, rposc, axis=1)
    rqual = np.take_along_axis(rq, rposc, axis=1)
    # rc rows compare the read base vs the complement of the extension
    # base (rbexts[l][s-pos-1] == complement of bexts[l][pos])
    ebm = bmat if not rc else (3 - bmat)
    mq = np.where(okr, rqual, 0).astype(np.float32)  # (R, win)
    evt = np.ascontiguousarray(bvalid.T.astype(np.float32))  # (win, N)
    tot = mq @ evt  # (R, N): qual over all valid ext positions
    for b in range(4):
        ext_b = np.ascontiguousarray(
            (bvalid & (ebm == b)).T.astype(np.float32)
        )
        tot -= np.where(rbase == b, mq, 0.0) @ ext_b
    q = np.rint(tot).astype(np.int64)
    # per-read best per branch
    BIG = 10**9
    qq = np.full((R, n), BIG, dtype=np.int64)
    for l in range(N):
        qq[:, ei[l]] = np.minimum(qq[:, ei[l]], q[:, l])
    order = np.argsort(qq, axis=1, kind="stable")
    best = np.take_along_axis(qq, order[:, :2], axis=1)
    vote = best[:, 0] < best[:, 1]
    for r in np.flatnonzero(vote):
        scores[order[r, 0]].append(int(best[r, 1] - best[r, 0]))


def _analyze_scores(hbv, inv, v, scores, to_delete, out_edges):
    """AnalyzeScores (Clean200.cc:391-445), version=2 semantics."""
    n = len(out_edges)
    for j in range(n):
        scores[j] = sorted(scores[j], reverse=True)
    for d in range(MAX_DEL + 1):
        qsum = np.zeros(n, dtype=np.int64)
        for j in range(n):
            for s in scores[j]:
                if s <= d:
                    break
                qsum[j] += s
        ids = np.argsort(-qsum, kind="stable")
        qs = qsum[ids]
        done = False
        for r in range(1, n):
            if qs[0] >= MIN_WIN and qs[r] <= MAX_LOSE and qs[0] >= MIN_RATIO * qs[r]:
                done = True
                for jj in range(r, n):
                    e2 = out_edges[ids[jj]]
                    to_delete.append(e2)
                    to_delete.append(int(inv[e2]))
                break
        if done:
            break
