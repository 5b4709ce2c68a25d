"""Graph-edit toolkit: the transactional (graph, involution, paths) edit
primitives every cleaning/simplification pass is built from.

Reference analogues:
* delete_edges + compact == DeleteEdges + Cleanup/CleanupCore
  (src/paths/long/large/GapToyTools.cc:417-476)
* squeeze == RemoveUnneededVertices2 (GapToyTools3.cc:87-300): merge
  linear runs of edges through 1-in/1-out vertices, maintaining the
  involution and migrating read paths
* remove_small_components == RemoveSmallComponents3 (GapToyTools3.cc:419)
* remove_hangs == RemoveHangs over RemoveHangingEnds3/DistancesToEnd3
  (GapToyTools2.cc:628, graph/DigraphTemplate.h:2295-2385)

Every mutating op keeps the reference's discipline: paths are truncated
at the first deleted edge, offsets stay consistent, and the involution
remains a structure-preserving involution (validate.test_involution).
"""

from __future__ import annotations

import numpy as np

from .hbv import HyperBasevector
from ..paths.read_paths import ReadPathVec


# ---------------------------------------------------------------------------
# core primitives
# ---------------------------------------------------------------------------


def delete_edges(hbv: HyperBasevector, paths: ReadPathVec, edge_ids):
    """Delete edges (caller must pass an involution-closed set) and
    compact: renumber edges/vertices, truncate paths at deleted entries.

    Returns (hbv2, paths2).
    """
    E = hbv.n_edges
    dead = np.zeros(E, dtype=bool)
    dead[np.asarray(edge_ids, dtype=np.int64)] = True
    # involution closure (the reference always deletes e and inv[e])
    dead |= dead[hbv.inv]
    keep = ~dead
    new_id = np.cumsum(keep) - 1  # valid where keep

    # --- paths: truncate at first deleted edge, renumber ----------------
    paths2 = _truncate_and_renumber(paths, keep, new_id)

    # --- edges -----------------------------------------------------------
    kept_idx = np.flatnonzero(keep)
    lens = hbv.edge_len()
    new_lens = lens[kept_idx]
    new_start = np.zeros(len(kept_idx) + 1, dtype=np.int64)
    new_start[1:] = np.cumsum(new_lens)
    new_bases = np.zeros(int(new_start[-1]), dtype=np.uint8)
    src = np.repeat(hbv.edge_start[:-1][kept_idx], new_lens) + _ragged_arange(
        new_lens
    )
    new_bases[:] = hbv.edge_bases[src]

    to_left = hbv.to_left[kept_idx]
    to_right = hbv.to_right[kept_idx]
    inv = new_id[hbv.inv[kept_idx]].astype(np.int32)

    hbv2 = HyperBasevector(
        hbv.k, new_bases, new_start, to_left, to_right, inv, hbv.n_vertices
    )
    return _drop_isolated_vertices(hbv2), paths2


def _truncate_and_renumber(paths: ReadPathVec, keep, new_id):
    """Truncate each path at its first deleted edge; renumber the rest."""
    if len(paths.edges) == 0:
        return paths
    flat_keep = keep[paths.edges]
    lens = paths.path_len()
    rid = np.repeat(np.arange(paths.n_reads), lens)
    local = np.arange(len(paths.edges)) - np.repeat(paths.offsets[:-1], lens)
    first_bad = np.full(paths.n_reads, np.iinfo(np.int64).max, dtype=np.int64)
    bad = ~flat_keep
    np.minimum.at(first_bad, rid[bad], local[bad])
    keep_entry = local < first_bad[rid]
    new_lens = np.bincount(rid[keep_entry], minlength=paths.n_reads)
    offsets = np.zeros(paths.n_reads + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(new_lens)
    flat = new_id[paths.edges[keep_entry]].astype(np.int32)
    start = np.where(new_lens > 0, paths.start, 0).astype(np.int32)
    return ReadPathVec(offsets, flat, start)


def _drop_isolated_vertices(hbv: HyperBasevector) -> HyperBasevector:
    """RemoveEdgelessVertices: renumber vertices with no incident edge."""
    used = np.zeros(hbv.n_vertices, dtype=bool)
    used[hbv.to_left] = True
    used[hbv.to_right] = True
    vmap = np.cumsum(used) - 1
    hbv.to_left = vmap[hbv.to_left].astype(np.int32)
    hbv.to_right = vmap[hbv.to_right].astype(np.int32)
    hbv.n_vertices = int(used.sum())
    return hbv


def _ragged_arange(lens):
    total = int(np.sum(lens))
    out = np.arange(total, dtype=np.int64)
    starts = np.zeros(len(lens), dtype=np.int64)
    if len(lens):
        starts[1:] = np.cumsum(lens)[:-1]
    return out - np.repeat(starts, lens)


# ---------------------------------------------------------------------------
# squeeze (RemoveUnneededVertices2)
# ---------------------------------------------------------------------------


def squeeze(hbv: HyperBasevector, paths: ReadPathVec):
    """Merge linear runs of edges through 1-in/1-out vertices.

    Returns (hbv2, paths2).  Paths are renumbered onto merged edges with
    adjusted offsets; consecutive duplicates collapse.
    """
    E = hbv.n_edges
    if E == 0:
        return hbv, paths
    k = hbv.k
    indeg = hbv.in_degree()
    outdeg = hbv.out_degree()
    lens = hbv.edge_len()
    kmers = lens - k + 1

    # single out-edge per vertex (for 1-out vertices)
    vout = np.full(hbv.n_vertices, -1, dtype=np.int64)
    vout[hbv.to_left[::-1]] = np.arange(E)[::-1]  # any; unique when outdeg==1
    vin = np.full(hbv.n_vertices, -1, dtype=np.int64)
    vin[hbv.to_right[::-1]] = np.arange(E)[::-1]

    # killable vertices (RemoveUnneededVertices2 step 1), with extra
    # guards: no palindromic edges adjacent (involution sharing)
    pal_edge = hbv.inv == np.arange(E)
    v_pal = np.zeros(hbv.n_vertices, dtype=bool)
    v_pal[hbv.to_left[pal_edge]] = True
    v_pal[hbv.to_right[pal_edge]] = True
    kill = (
        (indeg == 1)
        & (outdeg == 1)
        & ~v_pal
    )
    # reference guard From(v)[0] != To(v)[0]: the in-edge's source vertex
    # must differ from the out-edge's dest vertex (excludes self-loops and
    # 2-cycles)
    kv = np.flatnonzero(kill)
    ein = vin[kv]
    eout = vout[kv]
    # reference also requires both edges non-empty (gap edges from
    # MakeGaps are 0-length and must not be merged away,
    # GapToyTools3.cc:117-121)
    bad = (
        (ein == eout)
        | (hbv.to_left[ein] == hbv.to_right[eout])
        | (lens[ein] == 0)
        | (lens[eout] == 0)
    )
    kill[kv[bad]] = False

    if not kill.any():
        return hbv, paths

    # next edge pointer: e -> single out-edge of to_right[e] if killable
    nxt = np.where(kill[hbv.to_right], vout[hbv.to_right], -1).astype(np.int64)
    # (mirror symmetric by construction since inv flips in/out degrees)

    heads, rank, chain_len, head_of = _chain_heads(nxt, E, hbv.inv)

    # self-mirror guard: a chain containing both e and inv[e] (e.g. around
    # a hairpin break) cannot be merged without the involution sharing
    # edges — the reference's RemoveUnneededVertices2 explicitly assumes
    # this never happens (GapToyTools3.cc:105-109); we break those chains
    # apart instead of corrupting inv.
    self_mirror = heads[hbv.inv] == heads
    self_mirror &= hbv.inv != np.arange(E)  # palindromes already excluded
    if self_mirror.any():
        chains_bad = np.unique(heads[self_mirror])
        bad_edge = np.isin(heads, chains_bad)
        nxt = nxt.copy()
        nxt[bad_edge] = -1
        heads, rank, chain_len, head_of = _chain_heads(nxt, E, hbv.inv)

    return _apply_squeeze(hbv, paths, nxt, heads, rank, chain_len, head_of)


def _chain_heads(nxt, E, inv):
    """List-rank the edge chains defined by nxt (host pointer doubling).

    Returns (heads, rank, chain_len, head_of).  Cycles are broken before
    their minimum edge id, and the mirrored link is cut symmetrically so
    the involution keeps pairing chains (the reference collapses a smooth
    cycle to one loop edge at an arbitrary point,
    GapToyTools3.cc:136-160; breaking at the min edge is our
    deterministic equivalent).
    """
    nxt = nxt.copy()
    rounds = int(np.ceil(np.log2(E + 2))) + 1

    def rank_pass():
        prev = np.full(E, -1, dtype=np.int64)
        tgt = nxt[nxt >= 0]
        prev[tgt] = np.flatnonzero(nxt >= 0)
        ptr = np.where(prev >= 0, prev, np.arange(E))
        dist = (prev >= 0).astype(np.int64)
        for _ in range(rounds):
            dist = dist + dist[ptr]
            ptr = ptr[ptr]
        on_cycle = prev[ptr] >= 0
        return prev, ptr, dist, on_cycle

    prev, ptr, dist, on_cycle = rank_pass()
    if on_cycle.any():
        # min edge id per cycle via simultaneous min-propagation
        p2 = np.where(prev >= 0, prev, np.arange(E))
        mm = np.arange(E, dtype=np.int64)
        for _ in range(rounds):
            mm = np.minimum(mm, mm[p2])
            p2 = p2[p2]
        is_min = on_cycle & (mm == np.arange(E))
        mins = np.flatnonzero(is_min)
        # cut link prev[m] -> m plus the mirrored link inv[m] -> inv[prev[m]]
        nxt[prev[mins]] = -1
        nxt[inv[mins]] = -1
        prev, ptr, dist, on_cycle = rank_pass()
        assert not on_cycle.any()

    heads = ptr
    rank = dist
    chain_len = np.zeros(E, dtype=np.int64)
    np.maximum.at(chain_len, heads, rank + 1)
    return heads, rank, chain_len, heads


def _apply_squeeze(hbv, paths, nxt, heads, rank, chain_len, head_of):
    E = hbv.n_edges
    k = hbv.k
    lens = hbv.edge_len()
    kmers = lens - k + 1

    is_head = heads == np.arange(E)
    multi = chain_len[heads] > 1  # edges on multi-edge chains
    # offsets of each edge within its chain (kmer units)
    order = np.lexsort((rank, heads))
    sorted_heads = heads[order]
    sorted_kmers = kmers[order]
    csum = np.cumsum(sorted_kmers)
    seg_start_mask = np.concatenate(
        [[True], sorted_heads[1:] != sorted_heads[:-1]]
    )
    seg_base = np.where(seg_start_mask, csum - sorted_kmers, 0)
    seg_base = np.maximum.accumulate(seg_base)
    off_sorted = csum - sorted_kmers - seg_base
    offsets_k = np.zeros(E, dtype=np.int64)
    offsets_k[order] = off_sorted

    # new edge table: heads of multi chains become merged edges; edges on
    # single chains stay as-is.  Deterministic order: by old edge id of
    # the representative (heads for merged, self otherwise).
    rep = np.where(multi, heads, np.arange(E))
    is_rep = is_head | ~multi
    rep_ids = np.flatnonzero(is_rep)  # sorted old ids
    n_new = len(rep_ids)
    new_of_rep = np.full(E, -1, dtype=np.int64)
    new_of_rep[rep_ids] = np.arange(n_new)
    new_edge_of = new_of_rep[rep]  # every old edge -> its new id

    # merged lengths (bases)
    tot_kmers = np.zeros(E, dtype=np.int64)
    np.add.at(tot_kmers, heads, kmers)
    new_lens = np.where(
        multi[rep_ids], tot_kmers[rep_ids] + k - 1, lens[rep_ids]
    )
    new_start = np.zeros(n_new + 1, dtype=np.int64)
    new_start[1:] = np.cumsum(new_lens)
    new_bases = np.zeros(int(new_start[-1]), dtype=np.uint8)

    # fill bases: each old edge contributes lens bases at chain offset
    # (skipping the k-1 overlap for rank>0)
    contrib_len = np.where(rank > 0, lens - (k - 1), lens)
    src = np.repeat(hbv.edge_start[:-1] + np.where(rank > 0, k - 1, 0), contrib_len)
    src = src + _ragged_arange(contrib_len)
    dst_base = new_start[new_edge_of] + offsets_k + np.where(rank > 0, k - 1, 0)
    # position within new edge: offsets_k (kmer units == base units at
    # chain starts) ... contribution starts at offsets_k + (k-1 if rank>0)
    dst = np.repeat(dst_base, contrib_len) + _ragged_arange(contrib_len)
    new_bases[dst] = hbv.edge_bases[src]

    # vertices: keep old numbering, drop isolated later
    tails = np.zeros(E, dtype=np.int64)  # tail edge of each chain
    rr = np.zeros(E, dtype=np.int64)
    np.maximum.at(rr, heads, rank)
    # tail edge: the edge with rank == chain max whose head matches
    tail_edge = np.full(E, -1, dtype=np.int64)
    tail_mask = rank == rr[heads]
    tail_edge[heads[tail_mask]] = np.flatnonzero(tail_mask)

    new_left = hbv.to_left[rep_ids].astype(np.int32)
    new_right = np.where(
        multi[rep_ids],
        hbv.to_right[tail_edge[rep[rep_ids]]],
        hbv.to_right[rep_ids],
    ).astype(np.int32)

    # involution: mirror of chain head..tail is chain inv[tail]..inv[head]
    inv_new = new_edge_of[hbv.inv[np.where(multi[rep_ids], tail_edge[rep_ids], rep_ids)]]
    inv_new = inv_new.astype(np.int32)

    hbv2 = HyperBasevector(
        k, new_bases, new_start, new_left, new_right, inv_new,
        hbv.n_vertices,
    )
    hbv2 = _drop_isolated_vertices(hbv2)

    # paths: renumber, collapse consecutive duplicates, adjust offset
    paths2 = _migrate_paths_squeeze(paths, new_edge_of, offsets_k)
    return hbv2, paths2


def _migrate_paths_squeeze(paths, new_edge_of, offsets_k):
    if len(paths.edges) == 0:
        return paths
    n = paths.n_reads
    lens = paths.path_len()
    rid = np.repeat(np.arange(n), lens)
    new_flat = new_edge_of[paths.edges]
    # collapse consecutive duplicates within a read
    first = np.concatenate([[True], (rid[1:] == rid[:-1])])
    dup = np.concatenate(
        [[False], (rid[1:] == rid[:-1]) & (new_flat[1:] == new_flat[:-1])]
    )
    keep = ~dup
    new_lens = np.bincount(rid[keep], minlength=n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(new_lens)
    flat = new_flat[keep].astype(np.int32)
    # offset adjustment: + kmer offset of the first edge within its chain
    start = paths.start.astype(np.int64).copy()
    nz = lens > 0
    firstidx = paths.offsets[:-1][nz]
    start[nz] += offsets_k[paths.edges[firstidx]]
    return ReadPathVec(offsets, flat, start.astype(np.int32))


# ---------------------------------------------------------------------------
# component / cleaning passes
# ---------------------------------------------------------------------------


def components(hbv: HyperBasevector):
    """Undirected connected components over vertices; returns labels (V,)."""
    V = hbv.n_vertices
    label = np.arange(V, dtype=np.int64)
    a = np.minimum(hbv.to_left, hbv.to_right).astype(np.int64)
    b = np.maximum(hbv.to_left, hbv.to_right).astype(np.int64)
    # hook-and-compress label propagation; converges in O(log V) rounds
    for _ in range(10000):
        la = np.minimum(label[a], label[b])
        new = label.copy()
        np.minimum.at(new, a, la)
        np.minimum.at(new, b, la)
        for _ in range(64):  # full compress
            n2 = new[new]
            if np.array_equal(n2, new):
                break
            new = n2
        if np.array_equal(new, label):
            break
        label = new
    return label


def has_cycle(hbv: HyperBasevector, vset) -> bool:
    """Cycle test restricted to a vertex subset (Kahn peeling)."""
    vs = np.asarray(vset)
    sel = np.zeros(hbv.n_vertices, dtype=bool)
    sel[vs] = True
    emask = sel[hbv.to_left] & sel[hbv.to_right]
    tl = hbv.to_left[emask]
    tr = hbv.to_right[emask]
    indeg = np.zeros(hbv.n_vertices, dtype=np.int64)
    np.add.at(indeg, tr, 1)
    active = sel.copy()
    for _ in range(len(vs) + 1):
        zero = active & (indeg == 0)
        if not zero.any():
            break
        active[zero] = False
        em = zero[tl] & active[tr]
        np.add.at(indeg, tr[em], -1)
        # recompute edges from removed vertices only once: mask them out
        keep = ~zero[tl]
        tl, tr = tl[keep], tr[keep]
    return bool(active.any())


def remove_small_components(
    hbv: HyperBasevector,
    paths: ReadPathVec,
    remove_small_cycles: bool = False,
    max_small_comp: int = 1000,
    min_circle: int = 200,
):
    """RemoveSmallComponents3 (GapToyTools3.cc:419): delete components
    whose longest edge <= 1000 kmers and whose longest source->sink path
    <= 1000 kmers (or tiny cycles when remove_small_cycles)."""
    if hbv.n_edges == 0:
        return hbv, paths
    label = components(hbv)
    kmers = hbv.edge_kmers()
    elabel = label[hbv.to_left]

    comp_ids, comp_inverse = np.unique(elabel, return_inverse=True)
    comp_max = np.zeros(len(comp_ids), dtype=np.int64)
    np.maximum.at(comp_max, comp_inverse, kmers)
    comp_tot = np.zeros(len(comp_ids), dtype=np.int64)
    np.add.at(comp_tot, comp_inverse, kmers)

    to_delete = []
    for ci in np.flatnonzero(comp_max <= max_small_comp):
        edges = np.flatnonzero(comp_inverse == ci)
        if comp_tot[ci] < min_circle and remove_small_cycles:
            to_delete.append(edges)
            continue
        vset = np.unique(
            np.concatenate([hbv.to_left[edges], hbv.to_right[edges]])
        )
        if has_cycle(hbv, vset):
            continue
        lp = _longest_path_kmers(hbv, edges)
        if lp <= max_small_comp:
            to_delete.append(edges)
    if not to_delete:
        return hbv, paths
    return delete_edges(hbv, paths, np.concatenate(to_delete))


def _longest_path_kmers(hbv, edges):
    """Longest source->sink path (kmers) in an acyclic edge subset."""
    vset = np.unique(np.concatenate([hbv.to_left[edges], hbv.to_right[edges]]))
    vmap = {int(v): i for i, v in enumerate(vset)}
    nv = len(vset)
    adj = [[] for _ in range(nv)]
    indeg = np.zeros(nv, dtype=np.int64)
    kmers = hbv.edge_kmers()
    for e in edges:
        a, b = vmap[int(hbv.to_left[e])], vmap[int(hbv.to_right[e])]
        adj[a].append((b, int(kmers[e])))
        indeg[b] += 1
    # topo DP
    from collections import deque

    dist = np.zeros(nv, dtype=np.int64)
    q = deque(np.flatnonzero(indeg == 0).tolist())
    best = 0
    while q:
        v = q.popleft()
        for w, l in adj[v]:
            dist[w] = max(dist[w], dist[v] + l)
            best = max(best, dist[w])
            indeg[w] -= 1
            if indeg[w] == 0:
                q.append(w)
    return int(best)


def remove_hangs(
    hbv: HyperBasevector,
    paths: ReadPathVec,
    max_del: int,
    min_ratio: float = 10.0,
    max_paths: int = 100,
):
    """RemoveHangs (GapToyTools2.cc:628) via RemoveHangingEnds3
    (DigraphTemplate.h:2335): at each vertex, delete short dead-end side
    branches dominated >= min_ratio by the longest branch."""
    E = hbv.n_edges
    if E == 0:
        return hbv, paths
    kmers = hbv.edge_kmers()
    hanging = np.zeros(E, dtype=bool)
    fo, fe, to, te = hbv.vertex_csr()

    for pass_fw in (True, False):
        D, complete = _distances_to_end(hbv, kmers, pass_fw, max_paths)
        for v in range(hbv.n_vertices):
            if pass_fw:
                es = fe[fo[v] : fo[v + 1]]
                dests = hbv.to_right[es]
            else:
                es = te[to[v] : to[v + 1]]
                dests = hbv.to_left[es]
            if len(es) < 2:
                continue
            d = kmers[es] + D[dests]
            c = complete[dests]
            order = np.argsort(-d, kind="stable")
            d0 = d[order[0]]
            for j in order[1:]:
                if d[j] <= max_del and d0 >= d[j] * min_ratio and c[j]:
                    hanging[es[j]] = True
    if not hanging.any():
        return hbv, paths
    return delete_edges(hbv, paths, np.flatnonzero(hanging))


def _distances_to_end(hbv, kmers, fw, max_paths):
    """DistancesToEnd3 (DigraphTemplate.h:2295): per-vertex bounded simple
    -path enumeration; D[v] = max path length, complete[v] = enumeration
    did not overflow max_paths."""
    V = hbv.n_vertices
    fo, fe, to, te = hbv.vertex_csr()
    D = np.zeros(V, dtype=np.int64)
    complete = np.ones(V, dtype=bool)
    for v in range(V):
        paths_ = [([v], 0)]
        for _round in range(200):
            if len(paths_) > max_paths:
                break
            paths2 = []
            changed = False
            for pverts, plen in paths_:
                x = pverts[-1]
                if fw:
                    es = fe[fo[x] : fo[x + 1]]
                    dests = hbv.to_right[es]
                else:
                    es = te[to[x] : to[x + 1]]
                    dests = hbv.to_left[es]
                ext = {}
                for e, y in zip(es, dests):
                    if y in pverts:
                        continue
                    l = int(kmers[e])
                    if y not in ext or l > ext[y]:
                        ext[y] = l
                if not ext:
                    paths2.append((pverts, plen))
                    continue
                changed = True
                for y, l in ext.items():
                    paths2.append((pverts + [y], plen + l))
            if not changed:
                break
            paths_ = paths2
        complete[v] = len(paths_) <= max_paths
        for _, plen in paths_:
            D[v] = max(D[v], plen)
    return D, complete
