"""AnalyzeBranches — pair-vote branch pruning with edge detachment.

Reference: src/paths/long/large/GapToyTools2.cc:27-280, called from
Simplify with MIN_RATIO2=8 (Simplify.cc:122).  For each branch vertex
(1-in, multi-out for the forward pass), read-pair evidence links the
incoming edge e to follower edges; a branch is detached (its from-vertex
moved to a fresh vertex — NOT deleted) when the winning branch has
>= min_ratio2 x the support of the runner-up and the runner-up has
<= max_kill votes.  The involution mirror edge is detached symmetrically.

Heuristics (GapToyTools2.cc:44-47): max_dist=4, min_ratio=5, max_kill=2.
"""

from __future__ import annotations

import numpy as np

MAX_DIST = 4
MIN_RATIO = 5
MAX_KILL = 2


def _pair_links(hbv, paths, inv):
    """froms/tos multisets from read-pair edge sequences (both passes)."""
    E = hbv.n_edges
    froms = [[] for _ in range(E)]
    tos = [[] for _ in range(E)]
    npids = paths.n_reads // 2
    for pass_ in (1, 2):
        for pid in range(npids):
            x = [int(e) for e in paths.path(2 * pid)]
            y = [int(inv[e]) for e in paths.path(2 * pid + 1)[::-1]]
            if pass_ == 2:
                x, y = y, x
                x = [int(inv[e]) for e in x[::-1]]
                y = [int(inv[e]) for e in y[::-1]]
            P = set()
            for j in range(len(x) - 1):
                P.add((x[j], x[j + 1]))
            for j in range(len(y) - 1):
                P.add((y[j], y[j + 1]))
            for x1 in x:
                if x1 not in y and y:
                    P.add((x1, y[0]))
            for a, b in P:
                froms[a].append(b)
                tos[b].append(a)
    return froms, tos


def _follow_sets(hbv, fo, fe, branches, to_right):
    """Edges reachable within MAX_DIST hops after each branch."""
    follow = []
    for f in branches:
        cur = set(
            int(x) for x in fe[fo[to_right[f]] : fo[to_right[f] + 1]]
        )
        for _ in range(1, MAX_DIST):
            new = set(cur)
            for g in cur:
                w = to_right[g]
                new.update(int(x) for x in fe[fo[w] : fo[w + 1]])
            cur = new
        follow.append(cur)
    return follow


def analyze_branches(hbv, paths, min_ratio2: int = 8):
    """Returns (hbv, paths) with weak branches detached; paths are
    truncated at junctions that are no longer walks."""
    E = hbv.n_edges
    inv = hbv.inv
    froms, tos = _pair_links(hbv, paths, inv)
    for e in range(E):
        froms[e].sort()
        tos[e].sort()

    fo, fe, to, te = hbv.vertex_csr()
    to_right = hbv.to_right
    to_left = hbv.to_left

    # ---- forward pass -------------------------------------------------
    breaks = set()
    for e in range(E):
        v = int(to_right[e])
        outs = [int(x) for x in fe[fo[v] : fo[v + 1]]]
        if len(outs) <= 1 or (to[v + 1] - to[v]) > 1:
            continue
        follow = _follow_sets(hbv, fo, fe, outs, to_right)
        fr, count = _grouped_counts(froms[e])
        _absorb(fr, count, follow, outs)
        fr, count = _drop_zero(fr, count)
        if sorted(fr) == sorted(outs) and len(fr) == 2:
            if count[0] < MIN_RATIO * count[1] and count[1] < MIN_RATIO * count[0]:
                continue
        order = np.argsort(-np.array(count), kind="stable")
        fr = [fr[i] for i in order]
        count = [count[i] for i in order]
        if (
            len(count) >= 2
            and count[0] >= min_ratio2 * max(1, count[1])
            and count[1] <= MAX_KILL
            and fr[0] in outs
        ):
            for f in outs:
                if f != fr[0]:
                    breaks.add((e, f))

    # ---- reverse pass -------------------------------------------------
    breaksr = set()
    for e in range(E):
        v = int(to_left[e])
        ins = [int(x) for x in te[to[v] : to[v + 1]]]
        if len(ins) <= 1 or (fo[v + 1] - fo[v]) > 1:
            continue
        preceed = []
        for f in ins:
            cur = set(int(x) for x in te[to[to_left[f]] : to[to_left[f] + 1]])
            for _ in range(1, MAX_DIST):
                new = set(cur)
                for g in cur:
                    w = to_left[g]
                    new.update(int(x) for x in te[to[w] : to[w + 1]])
                cur = new
            preceed.append(cur)
        fr0, count0 = _grouped_counts(tos[e])
        # reference filter: only count links whose source actually ends at v
        fr, count = [], []
        for f, c in zip(fr0, count0):
            if int(to_right[f]) == v:
                fr.append(f)
                count.append(c)
        _absorb(fr, count, preceed, ins)
        fr, count = _drop_zero(fr, count)
        if sorted(fr) == sorted(ins) and len(fr) == 2:
            if count[0] < MIN_RATIO * count[1] and count[1] < MIN_RATIO * count[0]:
                continue
        order = np.argsort(-np.array(count), kind="stable")
        fr = [fr[i] for i in order]
        count = [count[i] for i in order]
        if (
            len(count) >= 2
            and count[0] >= min_ratio2 * max(1, count[1])
            and count[1] <= MAX_KILL
            and fr[0] in ins
        ):
            for f in ins:
                if f != fr[0]:
                    breaksr.add((f, e))

    if not breaks and not breaksr:
        return hbv, paths

    # ---- apply detachments -------------------------------------------
    to_left = to_left.copy()
    to_right = to_right.copy()
    nV = hbv.n_vertices
    for e, f in sorted(breaks):
        to_left[f] = nV
        rf = int(inv[f])
        to_right[rf] = nV + 1
        nV += 2
    for f, e in sorted(breaksr):
        # reference GiveEdgeNewToVx(branch, ..., n) (GapToyTools2.cc:275):
        # the weak IN-branch f is detached by moving its to-vertex
        to_right[f] = nV
        rf = int(inv[f])
        to_left[rf] = nV + 1
        nV += 2
    hbv.to_left = to_left
    hbv.to_right = to_right
    hbv.n_vertices = nV

    paths = _truncate_nonwalks(hbv, paths)
    return hbv, paths


def _grouped_counts(lst):
    fr, count = [], []
    i = 0
    while i < len(lst):
        j = i
        while j < len(lst) and lst[j] == lst[i]:
            j += 1
        fr.append(lst[i])
        count.append(j - i)
        i = j
    return fr, count


def _absorb(fr, count, follow, branches):
    """GapToyTools2.cc:147-163: votes reachable from every branch are
    dropped; votes reachable from exactly one branch transfer to it."""
    for i in range(len(fr)):
        homes = [j for j, s in enumerate(follow) if fr[i] in s]
        if len(homes) == len(follow):
            count[i] = 0
        elif len(homes) == 1:
            for j in range(len(fr)):
                if fr[j] == branches[homes[0]] and i != j:
                    count[j] += count[i]
                    count[i] = 0


def _drop_zero(fr, count):
    keep = [i for i in range(len(fr)) if count[i] != 0]
    return [fr[i] for i in keep], [count[i] for i in keep]


def _truncate_nonwalks(hbv, paths):
    """Truncate each path at its first non-adjacent edge pair (after
    detachment some paths stop being walks; the reference marks entries
    -1 and resizes at the end of step 6, w2rap-contigger.cc:503-508)."""
    from ..paths.read_paths import ReadPathVec

    if len(paths.edges) == 0:
        return paths
    lens = paths.path_len()
    rid = np.repeat(np.arange(paths.n_reads), lens)
    local = np.arange(len(paths.edges)) - np.repeat(paths.offsets[:-1], lens)
    nxt_same = np.concatenate([rid[1:] == rid[:-1], [False]])
    a = paths.edges
    b = np.concatenate([paths.edges[1:], [0]])
    bad_pair = nxt_same & (hbv.to_right[a] != hbv.to_left[np.clip(b, 0, None)])
    INF = np.iinfo(np.int64).max
    first_bad = np.full(paths.n_reads, INF, dtype=np.int64)
    np.minimum.at(first_bad, rid[bad_pair], local[bad_pair])
    keep = local <= first_bad[rid]
    new_lens = np.bincount(rid[keep], minlength=paths.n_reads)
    offsets = np.zeros(paths.n_reads + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(new_lens)
    return ReadPathVec(
        offsets, paths.edges[keep].astype(np.int32), paths.start.copy()
    )
