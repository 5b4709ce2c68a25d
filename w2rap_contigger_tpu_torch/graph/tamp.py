"""Tamp — fold near-duplicate short branches into their longer sibling.

Reference: Tamp (src/paths/long/large/GapToyTools5.cc:605-777).  At a
2-out vertex v with branches e1 (long, v->w) and e2 (short, v->x; x a
dead end), when e2 agrees with the prefix of e1 (<=4 mismatches and a
>=40-base terminal match for max_shift=0; a unique alignment shift in
[-max_shift, max_shift] otherwise), e1 is split so its prefix runs
through x: e2 absorbs K-1-match extra bases of e1, and e1 is replaced
by e1a (v->x) + e1b (x->w).  The reverse-complement locus is edited in
mirror, the involution is extended, and read paths through e1/inv(e1)
are rewritten onto the split edges (GapToyTools5.cc:725-768).

Host-side graph surgery: loci are rare, so the pass gathers candidates
with vectorized prefix comparisons and applies the few edits on numpy
lists before rebuilding the flat tensors.
"""

from __future__ import annotations

import numpy as np

from . import ops
from .hbv import HyperBasevector
from ..core.dna import revcomp_codes
from ..paths.read_paths import ReadPathVec, invert_paths

MIN_MATCH = 40  # GapToyTools5.cc:623
MAX_MISMATCHES = 4  # GapToyTools5.cc:624


def _find_loci(hbv: HyperBasevector, max_shift: int):
    K = hbv.k
    E = hbv.n_edges
    lens = hbv.edge_len()
    inv = hbv.inv
    outdeg = hbv.out_degree()
    indeg = hbv.in_degree()
    fo, fe, _, _ = hbv.vertex_csr()
    touched = np.zeros(E, dtype=bool)
    loci = []
    for v in np.flatnonzero(outdeg == 2):
        es = fe[fo[v] : fo[v + 1]]
        for j in (0, 1):
            e1, e2 = int(es[j]), int(es[1 - j])
            n1, n2 = int(lens[e1]), int(lens[e2])
            if n1 <= n2:
                continue
            x, w = int(hbv.to_right[e2]), int(hbv.to_right[e1])
            if outdeg[x] != 0 or indeg[x] != 1 or indeg[w] != 1:
                continue
            if len({int(v), x, w}) != 3:
                continue
            x1, x2 = hbv.edge_seq(e1), hbv.edge_seq(e2)
            eq = x1[:n2] == x2
            mis = int(n2 - int(eq.sum()))
            rev = eq[::-1]
            match = n2 if rev.all() else int(np.argmin(rev))
            shift = 0
            if max_shift == 0:
                if K - 1 - match < 0:
                    continue
                if mis > MAX_MISMATCHES or match < MIN_MATCH:
                    continue
            else:
                # unique shift with a clean MIN_MATCH-base terminal match
                # (GapToyTools5.cc:661-671; mismatch count is not used)
                shifts = []
                for s in range(-max_shift, max_shift + 1):
                    lo = n2 - MIN_MATCH
                    if lo + s < 0 or n2 - 1 + s >= n1:
                        continue
                    if np.array_equal(x1[lo + s : n2 + s], x2[lo:n2]):
                        shifts.append(s)
                if len(shifts) != 1:
                    continue
                shift, match = shifts[0], MIN_MATCH
            if n1 - n2 - shift + match <= K - 1:
                continue
            re1, re2 = int(inv[e1]), int(inv[e2])
            if len({e1, e2, re1, re2}) != 4:
                continue
            if touched[e1] or touched[e2] or touched[re1] or touched[re2]:
                continue
            touched[[e1, e2, re1, re2]] = True
            loci.append((int(v), e1, e2, match, shift))
    return loci


def tamp(hbv: HyperBasevector, paths: ReadPathVec, max_shift: int):
    """Returns (hbv2, paths2); ends with the reference's Cleanup
    (dead-edge removal + RemoveUnneededVertices2)."""
    if hbv.n_edges == 0:
        return hbv, paths
    K = hbv.k
    E = hbv.n_edges
    loci = _find_loci(hbv, max_shift)
    if not loci:
        return hbv, paths

    seqs = [hbv.edge_seq(e) for e in range(E)]
    to_left = list(hbv.to_left)
    to_right = list(hbv.to_right)
    inv_l = list(hbv.inv)
    pio, pir = invert_paths(paths, E)
    starts = paths.start.astype(np.int64).copy()
    plist: dict[int, list] = {}

    def get_p(r):
        if r not in plist:
            plist[r] = [int(e) for e in paths.path(r)]
        return plist[r]

    def kmers_of(e):
        return len(seqs[e]) - K + 1

    def rewrite(r, eold, efirst, esecond):
        """ReadPath migration for one read (GapToyTools5.cc:726-768):
        an eold entry becomes efirst [+ esecond] or just esecond."""
        p = get_p(r)
        m = 0
        while m < len(p):
            if p[m] == eold:
                if m > 0 or starts[r] < len(seqs[efirst]):
                    p[m] = efirst
                    p1a = int(starts[r]) - sum(
                        kmers_of(p[jj]) for jj in range(m + 1)
                    )
                    if m < len(p) - 1 or p1a >= 0:
                        p.insert(m + 1, esecond)
                        m += 1
                else:
                    p[m] = esecond
                    starts[r] -= kmers_of(efirst)
            m += 1

    dead = []
    for v, e1, e2, match, shift in loci:
        n1, n2 = len(seqs[e1]), len(seqs[e2])
        x, w = to_right[e2], to_right[e1]
        x1, x2 = seqs[e1], seqs[e2]
        re1, re2 = inv_l[e1], inv_l[e2]
        x2a = np.concatenate([x2, x1[n2 + shift : n2 + shift + (K - 1 - match)]])
        x1a = x1[: len(x2a) + shift]
        x1b = x1[len(x2a) - (K - 1) + shift : n1]
        seqs[e2] = x2a
        e1a = len(seqs)
        seqs.append(x1a), to_left.append(v), to_right.append(x)
        e1b = len(seqs)
        seqs.append(x1b), to_left.append(x), to_right.append(w)
        rv, rw, rx = to_right[re1], to_left[re1], to_left[re2]
        seqs[re2] = revcomp_codes(x2a)
        re1a = len(seqs)
        seqs.append(revcomp_codes(x1a)), to_left.append(rx), to_right.append(rv)
        re1b = len(seqs)
        seqs.append(revcomp_codes(x1b)), to_left.append(rw), to_right.append(rx)
        inv_l.extend([re1a, re1b, e1a, e1b])
        dead.extend([e1, re1])
        for r in np.unique(pir[pio[e1] : pio[e1 + 1]]):
            rewrite(int(r), e1, e1a, e1b)
        for r in np.unique(pir[pio[re1] : pio[re1 + 1]]):
            rewrite(int(r), re1, re1b, re1a)

    # rebuild tensors
    flat, estart = HyperBasevector.from_edge_list(K, seqs)
    hbv2 = HyperBasevector(
        K,
        flat,
        estart,
        np.asarray(to_left, dtype=np.int32),
        np.asarray(to_right, dtype=np.int32),
        np.asarray(inv_l, dtype=np.int32),
        hbv.n_vertices,
    )
    n = paths.n_reads
    old_lens = paths.path_len()
    new_lens = old_lens.copy()
    for r, p in plist.items():
        new_lens[r] = len(p)
    new_off = np.zeros(n + 1, dtype=np.int64)
    new_off[1:] = np.cumsum(new_lens)
    flatp = np.zeros(int(new_off[-1]), dtype=np.int32)
    if len(paths.edges):
        rid = np.repeat(np.arange(n), old_lens)
        local = np.arange(len(paths.edges)) - np.repeat(paths.offsets[:-1], old_lens)
        unchanged = np.ones(n, dtype=bool)
        for r in plist:
            unchanged[r] = False
        m = unchanged[rid]
        flatp[(new_off[rid] + local)[m]] = paths.edges[m]
    for r, p in plist.items():
        flatp[new_off[r] : new_off[r] + len(p)] = p
    paths2 = ReadPathVec(new_off, flatp, starts.astype(np.int32))

    hbv2, paths2 = ops.delete_edges(hbv2, paths2, np.asarray(dead, dtype=np.int64))
    return ops.squeeze(hbv2, paths2)
