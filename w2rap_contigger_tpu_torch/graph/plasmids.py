"""UnwindThreeEdgePlasmids (src/paths/long/large/GapToyTools3.cc:725-860).

A two-vertex component with parallel edges e1,e2 (v->w) and a single
back edge f (w->v) is a collapsed plasmid; when read pairs link e1 and
e2 (>=2 links), both have >=10 pair support, and their coverages agree
within 25%, the component is rewritten as one circular edge
Cat(e1,f,e2,f) (+ rc), and reads are remapped onto it.
"""

from __future__ import annotations

import numpy as np

from ..paths.read_paths import ReadPathVec, invert_paths
from . import ops

MIN_COV = 10
FUDGE = 0.25
MIN_LINKS = 2


def _pids(e, inv, pi_off, pi_read):
    out = set()
    for d in (e, int(inv[e])):
        for ii in range(pi_off[d], pi_off[d + 1]):
            out.add(int(pi_read[ii]) // 2)
    return out


def unwind_three_edge_plasmids(hbv, paths):
    inv = hbv.inv
    k = hbv.k
    kmers = hbv.edge_kmers()
    label = ops.components(hbv)
    fo, fe, to, te = hbv.vertex_csr()
    pi_off, pi_read = invert_paths(paths, hbv.n_edges)

    # group vertices by component
    comp_vs = {}
    for v in range(hbv.n_vertices):
        comp_vs.setdefault(int(label[v]), []).append(v)

    dels = []
    new_edges = []  # (seq, vleft, vright)
    path_edits = {}  # read id -> (edges, start)
    for vs in comp_vs.values():
        if len(vs) != 2:
            continue
        v, w = vs
        if fo[v + 1] - fo[v] != 2:
            v, w = w, v
        if fo[v + 1] - fo[v] != 2 or fo[w + 1] - fo[w] != 1:
            continue
        outs_v = [int(x) for x in fe[fo[v] : fo[v + 1]]]
        f = int(fe[fo[w]])
        if any(int(hbv.to_right[e]) != w for e in outs_v):
            continue
        if int(hbv.to_right[f]) != v:
            continue
        e1, e2 = outs_v
        re1, re2, rf = int(inv[e1]), int(inv[e2]), int(inv[f])
        v1, v2 = {e1, e2, f}, {re1, re2, rf}
        if v1 & v2 or min(v2) < min(v1):
            continue

        pids = set()
        for e in (e1, e2, f, re1, re2, rf):
            for ii in range(pi_off[e], pi_off[e + 1]):
                pids.add(int(pi_read[ii]) // 2)
        links = 0
        for pid in pids:
            es = set()
            for rid in (2 * pid, 2 * pid + 1):
                for x in paths.path(rid):
                    es.add(int(x))
                    es.add(int(inv[x]))
            if e1 in es and e2 in es:
                links += 1
        if links < MIN_LINKS:
            continue
        ne1 = len(_pids(e1, inv, pi_off, pi_read))
        ne2 = len(_pids(e2, inv, pi_off, pi_read))
        if ne1 < MIN_COV or ne2 < MIN_COV:
            continue
        ce1 = ne1 / max(1, int(kmers[e1]) + k - 1 - 60)
        ce2 = ne2 / max(1, int(kmers[e2]) + k - 1 - 60)
        if max(ce1, ce2) / max(min(ce1, ce2), 1e-9) - 1 > FUDGE:
            continue

        # rewrite: circular edge Cat(e1,f,e2,f) at v (+ rc at rc-side)
        def cat(es_):
            b = hbv.edge_seq(es_[0]).copy()
            for e in es_[1:]:
                b = np.concatenate([b, hbv.edge_seq(e)[k - 1 :]])
            return b

        b = cat([e1, f, e2, f])
        rb = cat([rf, re2, rf, re1])
        rv = int(hbv.to_right[re1])
        m_id = hbv.n_edges + len(new_edges)
        new_edges.append((b, v, v))
        rm_id = hbv.n_edges + len(new_edges)
        new_edges.append((rb, rv, rv))
        dels.extend([e1, e2, f, re1, re2, rf])

        for pid in pids:
            for rid in (2 * pid, 2 * pid + 1):
                p = [int(x) for x in paths.path(rid)]
                if not p:
                    continue
                for l, x in enumerate(p):
                    pre = int(np.sum(kmers[p[:l]]))
                    off = int(paths.start[rid])
                    if x == e1:
                        path_edits[rid] = ([m_id], off - pre)
                    elif x == e2:
                        path_edits[rid] = (
                            [m_id],
                            off - pre + int(kmers[e1]) + int(kmers[f]),
                        )
                    elif x == re2:
                        path_edits[rid] = ([rm_id], off - pre + int(kmers[f]))
                    elif x == re1:
                        path_edits[rid] = (
                            [rm_id],
                            off - pre + 2 * int(kmers[f]) + int(kmers[re2]),
                        )
                    else:
                        continue
                    break

    if not new_edges:
        return hbv, paths

    # append new edges (pairs adjacent: inv = swap)
    E0 = hbv.n_edges
    lens = np.array([len(b) for b, _, _ in new_edges], dtype=np.int64)
    hbv.edge_bases = np.concatenate(
        [hbv.edge_bases] + [b for b, _, _ in new_edges]
    )
    hbv.edge_start = np.concatenate(
        [hbv.edge_start, hbv.edge_start[-1] + np.cumsum(lens)]
    )
    hbv.to_left = np.concatenate(
        [hbv.to_left, np.array([v for _, v, _ in new_edges], np.int32)]
    )
    hbv.to_right = np.concatenate(
        [hbv.to_right, np.array([w for _, _, w in new_edges], np.int32)]
    )
    inv_new = np.arange(E0, E0 + len(new_edges), dtype=np.int32)
    inv_new += np.where((inv_new - E0) % 2 == 0, 1, -1)
    hbv.inv = np.concatenate([hbv.inv, inv_new])

    # apply path edits, then delete old edges
    lists = []
    starts = paths.start.astype(np.int64).copy()
    for rid in range(paths.n_reads):
        if rid in path_edits:
            es, off = path_edits[rid]
            lists.append(es)
            starts[rid] = off
        else:
            lists.append([int(x) for x in paths.path(rid)])
    paths = ReadPathVec.from_lists(lists, starts.astype(np.int32))
    return ops.delete_edges(hbv, paths, np.array(dels))
