"""Degloop — branch-point quality-distribution edge deletion.

Reference: Degloop/DegloopCore (src/paths/long/large/GapToyTools2.cc:
914-1100), called from Simplify with mode=1, min_dist=2.5
(w2rap-contigger.cc:489: DEGLOOP_MODE=1, DEGLOOP_MIN_DIST=2.5).

At each branch vertex, every branch's supporting reads contribute the
quality score of the base at the branch point (the Kth base); a branch
whose score distribution is significantly below a sibling's
(t-like statistic >= min_dist, <=1 good (>=Q30) score, <=200 kmers) is
deleted with its involution mirror.
"""

from __future__ import annotations

import numpy as np

from ..paths.read_paths import invert_paths
from . import ops


def degloop(hbv, paths, reads, mode: int = 1, min_dist: float = 2.5):
    if reads is None:
        return hbv, paths
    k = hbv.k
    inv = hbv.inv
    kmers = hbv.edge_kmers()
    elens = hbv.edge_len()
    fo, fe, to, te = hbv.vertex_csr()
    pi_off, pi_read = invert_paths(paths, hbv.n_edges)

    edels = []
    for v in range(hbv.n_vertices):
        for pass_ in (1, 2):
            es = (
                [int(x) for x in fe[fo[v] : fo[v + 1]]]
                if pass_ == 1
                else [int(x) for x in te[to[v] : to[v + 1]]]
            )
            n = len(es)
            if n < 2:
                continue
            # homopolymer guard (10 bases flanking the branch point)
            homop = False
            for e in es:
                ne = int(elens[e])
                if ne == 0:
                    continue
                seq = hbv.edge_seq(e)
                if pass_ == 1:
                    b = seq[k - 10 : k][::-1] if k >= 10 else seq[:k]
                else:
                    b = seq[ne - k : ne - k + 10]
                if len(set(b.tolist())) == 1:
                    homop = True
            if homop:
                continue

            min_edge = min(
                (int(elens[e]) for e in es if elens[e] > 0), default=0
            )
            qs = []
            for e in es:
                ne = int(elens[e])
                qi = []
                if ne > 0:
                    re_ = int(inv[e])
                    for xpass, x in ((1, e), (2, re_)):
                        for ii in range(pi_off[x], pi_off[x + 1]):
                            rid = int(pi_read[ii])
                            p = paths.path(rid)
                            b = reads.bases[rid]
                            q = reads.quals[rid]
                            nb = int(reads.lengths[rid])
                            for l in np.flatnonzero(p == x):
                                l = int(l)
                                estart = int(paths.start[rid]) - int(
                                    np.sum(kmers[p[:l]])
                                )
                                estop = estart + nb
                                flip = (xpass == 1) ^ (pass_ == 1)
                                rpos = (
                                    -estart + ne - k
                                    if flip
                                    else -estart + k - 1
                                )
                                if rpos < 0 or rpos >= nb:
                                    continue
                                if not flip:
                                    ov = min(min_edge, estop) - max(0, estart)
                                else:
                                    ov = min(ne, estop) - max(
                                        ne - min_edge, estart
                                    )
                                if ov < k:
                                    continue
                                qi.append(int(q[rpos]))
                qs.append(sorted(qi, reverse=True))

            m = [np.mean(x) if x else -1.0 for x in qs]
            kk = [len(x) for x in qs]
            dels = set()
            for i1 in range(n):
                for i2 in range(n):
                    if i1 == i2:
                        continue
                    good1 = sum(1 for x in qs[i1] if x >= 30)
                    good2 = sum(1 for x in qs[i2] if x >= 30)
                    ne2 = int(kmers[es[i2]])
                    if mode >= 2 and kk[i2] == 0 and good1 >= 10 and ne2 <= 200:
                        dels.add(i2)
                    if kk[i1] == 0 or kk[i2] == 0:
                        continue
                    dist = (m[i1] - m[i2]) / np.sqrt(
                        m[i1] * m[i1] / kk[i1] + m[i2] * m[i2] / kk[i2]
                    )
                    if dist >= min_dist and good2 <= 1 and ne2 <= 200:
                        dels.add(i2)
            for i in dels:
                edels.append(es[i])

    if not edels:
        return hbv, paths
    hbv, paths = ops.delete_edges(hbv, paths, np.array(sorted(set(edels))))
    return ops.squeeze(hbv, paths)
