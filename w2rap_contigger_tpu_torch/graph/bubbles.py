"""PopBubbles — qual-weighted bubble collapse.

Reference: PopBubbles + bubble_logger (src/paths/long/large/
GapToyTools4.cc:731-814, bubble scoring in GapToyTools.cc) with
DivineBubbles' acceptance test (constants max_asym_rarity=1e-5,
min_to_save=10, binomial p=0.25 — GapToyTools4.cc:795-805).

A bubble is a pair of parallel edges between the same two vertices.  For
every read whose path crosses a bubble branch, the read is scored
against both branch sequences (sum of quals at mismatching bases); the
qual-difference maps to a support probability
p = max(0.5, 1 - 10^(-0.1*diff)); the Divine test then deletes the
losing branch when the support asymmetry is binomially implausible.
"""

from __future__ import annotations

import math

import numpy as np

from ..paths.read_paths import invert_paths
from . import ops

MAX_ASYM_RARITY = 0.00001
MIN_TO_SAVE = 10.0


def binomial_sum(n, k, p):
    """P(X <= k) for X ~ Binomial(n, p) (math/Combinatorics equivalent)."""
    k = min(k, n)
    if k < 0:
        return 0.0
    total = 0.0
    logp = math.log(p)
    logq = math.log1p(-p)
    for i in range(k + 1):
        total += math.exp(
            math.lgamma(n + 1)
            - math.lgamma(i + 1)
            - math.lgamma(n - i + 1)
            + i * logp
            + (n - i) * logq
        )
    return min(total, 1.0)


def find_bubbles(hbv):
    """Parallel-edge pairs: [(v, w, e1, e2)] with e1 < e2."""
    pairs = {}
    for e in range(hbv.n_edges):
        key = (int(hbv.to_left[e]), int(hbv.to_right[e]))
        pairs.setdefault(key, []).append(e)
    out = []
    for (v, w), es in pairs.items():
        if len(es) == 2 and v != w:
            out.append((v, w, es[0], es[1]))
    return out


def _score_reads(hbv, reads, paths, pi_off, pi_read, e1, e2):
    """Qual-mismatch scores of reads crossing e1 or e2 vs both branches.

    Returns list of (winner(0/1), qual_diff).
    """
    k = hbv.k
    s1 = hbv.edge_seq(e1)
    s2 = hbv.edge_seq(e2)
    kmers = hbv.edge_kmers()
    out = []
    for e_branch, bidx in ((e1, 0), (e2, 1)):
        for ii in range(pi_off[e_branch], pi_off[e_branch + 1]):
            rid = int(pi_read[ii])
            p = paths.path(rid)
            js = np.flatnonzero(p == e_branch)
            if len(js) == 0:
                continue
            j = int(js[0])
            # read start relative to branch edge start (bases)
            start = int(paths.start[rid]) - int(np.sum(kmers[p[:j]]))
            rb = reads.bases[rid]
            rq = reads.quals[rid]
            rl = int(reads.lengths[rid])
            q1 = _mismatch_qual(rb, rq, rl, s1, start)
            q2 = _mismatch_qual(rb, rq, rl, s2, start)
            if q1 == q2:
                continue
            out.append((0 if q1 < q2 else 1, abs(q1 - q2)))
    return out


def _mismatch_qual(rb, rq, rl, branch, start):
    """Sum of read quals at positions mismatching the branch sequence."""
    lo = max(0, -start)
    hi = min(rl, len(branch) - start)
    if hi <= lo:
        return 0
    rpos = np.arange(lo, hi)
    bpos = rpos + start
    mism = rb[lo:hi] != branch[bpos]
    return int(np.sum(rq[lo:hi][mism]))


def pop_bubbles(hbv, paths, reads):
    """Returns (hbv2, paths2)."""
    if reads is None:
        return hbv, paths
    inv = hbv.inv
    bubbles = find_bubbles(hbv)
    if not bubbles:
        return hbv, paths
    pi_off, pi_read = invert_paths(paths, hbv.n_edges)

    # pair each bubble with its involution mirror
    by_edges = {}
    for v, w, e1, e2 in bubbles:
        by_edges[(e1, e2)] = (v, w)
    done = set()
    to_delete = []
    for (e1, e2), (v, w) in by_edges.items():
        if (e1, e2) in done:
            continue
        # skip bubbles whose branches are mutual rc (GapToyTools4.cc:766)
        if inv[e1] == e2 or inv[e2] == e1:
            done.add((e1, e2))
            continue
        m1, m2 = sorted((int(inv[e1]), int(inv[e2])))
        mirror = (m1, m2) if (m1, m2) in by_edges and (m1, m2) != (e1, e2) else None
        done.add((e1, e2))
        if mirror:
            done.add(mirror)

        sup = _score_reads(hbv, reads, paths, pi_off, pi_read, e1, e2)
        f1 = f2 = 0.0
        for winner, diff in sup:
            p = max(0.5, 1.0 - 10 ** (-0.1 * diff))
            if winner == 0:
                f1 += p
                f2 += 1.0 - p
            else:
                f1 += 1.0 - p
                f2 += p
        if mirror:
            # mirror branch order: inv[e1] pairs with e1
            me1, me2 = mirror
            flip = not (int(inv[e1]) == me1)
            supm = _score_reads(hbv, reads, paths, pi_off, pi_read, me1, me2)
            r1 = r2 = 0.0
            for winner, diff in supm:
                p = max(0.5, 1.0 - 10 ** (-0.1 * diff))
                w0 = winner if not flip else 1 - winner
                if w0 == 0:
                    r1 += p
                    r2 += 1.0 - p
                else:
                    r1 += 1.0 - p
                    r2 += p
        else:
            f1 *= 0.5
            f2 *= 0.5
            r1, r2 = f1, f2

        shift = 1
        if f2 + r2 > f1 + r1 or (f2 + r2 == f1 + r1 and f2 > f1):
            shift = 0
            f1, f2 = f2, f1
            r1, r2 = r2, r1

        n_f = int(math.floor(2 * (f1 + f2)))
        n_r = int(math.floor(2 * (r1 + r2)))
        if (
            (n_f > 0 or n_r > 0)
            and (
                n_f == 0
                or (
                    binomial_sum(n_f, int(math.ceil(f2)), 0.25)
                    < MAX_ASYM_RARITY
                    and f2 < MIN_TO_SAVE
                )
            )
            and (
                n_r == 0
                or (
                    binomial_sum(n_r, int(math.ceil(r2)), 0.25)
                    < MAX_ASYM_RARITY
                    and r2 < MIN_TO_SAVE
                )
            )
        ):
            loser = (e1, e2)[shift]
            to_delete.append(loser)
            if mirror:
                to_delete.append(int(inv[loser]))

    if not to_delete:
        return hbv, paths
    hbv, paths = ops.delete_edges(hbv, paths, np.array(to_delete))
    return ops.squeeze(hbv, paths)
