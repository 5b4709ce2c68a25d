"""Step 3 — repath the k=60 graph to large K (default 200), on one device
or sharded over a mesh.

Counterpart of w2rap_contigger_tpu/pipeline/step3_repath.py:26-245
(RepathInMemory, src/paths/long/large/Repath.cc:23-251):

1. read paths -> canonical unique "places" (total bases >= K2), host
   numpy (:44-157, with extend_paths :117-138);
2. place sequences (K-1 overlap concat, first/last edge truncated to K2),
   host (:159-182);
3. the K2 de Bruijn graph from the place sequences: flat counting, the
   adjacency pruning and the unitig links on the device, the chain
   assembly and the HBV on the host (:184-188);
4. read-path translation via the place -> new-path mapping: the place
   walks on the device (flat lookup), the rest host numpy (:191-245).

Spans (W2RAP_TIMELOG=1): step3.places, step3.count.{kmerize,sort,
collapse} (with a mesh also .exchange inside .kmerize, and .gather),
step3.adjacencies, step3.unitigs (.device), step3.hbv,
step3.pathing (.lookup), step3.translate.
"""

from __future__ import annotations

import numpy as np

from ..device import resolve_device, timed
from ..graph import build as gb
from ..graph.hbv import HyperBasevector
from ..ops import kmer_engine as ke
from ..paths import flat_pather
from ..paths.read_paths import ReadPathVec

def _places(hbv, paths, k2: int, extend_paths: bool):
    """(place_idx (n_reads,), place_rc (n_reads,), place_list): each read's
    canonical unique place, -1 when its path is shorter than K2 (:44-157)."""
    k = hbv.k
    inv = hbv.inv
    kmers = hbv.edge_kmers()

    # ---- places -------------------------------------------------------
    # canonical (min of path vs rc path) unique edge sequences.
    # Vectorized over all reads at once (the reference's per-read OMP
    # batches, Repath.cc:46-67): candidate paths are padded into one
    # int32 matrix, the rc form is built by a single gather, and the
    # canonical choice / dedup run as row-wise lexicographic compares.
    n_reads = paths.n_reads
    plen = np.diff(paths.offsets)
    nk_read = np.zeros(n_reads, dtype=np.int64)
    np.add.at(
        nk_read,
        np.repeat(np.arange(n_reads), plen),
        kmers[paths.edges],
    )
    cand = np.flatnonzero((plen > 0) & (nk_read + (k - 1) >= k2))
    place_rc = np.zeros(n_reads, dtype=bool)
    place_idx = np.full(n_reads, -1, dtype=np.int64)
    place_list = []
    place_of_read = {}
    if len(cand):
        clen = plen[cand]
        Lp = int(clen.max())
        # padded forward matrix (pad = -1 sorts before any edge id,
        # matching the shorter-prefix-first bytes comparison)
        fwd = np.full((len(cand), Lp), -1, dtype=np.int64)
        rows = np.repeat(np.arange(len(cand)), clen)
        cols = (
            np.arange(len(rows))
            - np.repeat(np.cumsum(clen) - clen, clen)
        )
        fwd[rows, cols] = paths.edges[
            np.repeat(paths.offsets[cand], clen) + cols
        ]
        # rc form: inv of reversed row (reversal within the real length)
        rcm = np.full_like(fwd, -1)
        rcm[rows, cols] = inv[fwd[rows, clen[rows] - 1 - cols]]
        # row-wise lexicographic fwd vs rc (same length, so elementwise)
        diff_col = (fwd != rcm).argmax(axis=1)
        r = np.arange(len(cand))
        rc_less = rcm[r, diff_col] < fwd[r, diff_col]
        canon = np.where(rc_less[:, None], rcm, fwd).astype(np.int32)
        # dedup canonical rows, preserving first-seen order like the
        # reference's place map.  Row grouping via lexsort +
        # consecutive-dedup — np.unique on a void view memcmp-compares
        # per element and was superlinear at north-star scale.  Only the
        # grouping and first-occurrence indices matter downstream (the
        # unique order is re-sorted by first-seen either way).
        C_ = len(cand)
        sorder = np.lexsort(
            tuple(canon[:, c] for c in range(Lp - 1, -1, -1))
        )
        sc = canon[sorder]
        new_grp = np.empty(C_, dtype=bool)
        new_grp[0] = True
        new_grp[1:] = (sc[1:] != sc[:-1]).any(axis=1)
        grp_sorted = np.cumsum(new_grp) - 1
        inv_map = np.empty(C_, dtype=np.int64)
        inv_map[sorder] = grp_sorted
        n_grp = int(grp_sorted[-1]) + 1 if C_ else 0
        first = np.full(n_grp, np.int64(1) << 62, dtype=np.int64)
        np.minimum.at(first, inv_map, np.arange(C_, dtype=np.int64))
        order = np.argsort(first, kind="stable")
        rank_of_unique = np.empty_like(order)
        rank_of_unique[order] = np.arange(len(order))
        place_idx[cand] = rank_of_unique[inv_map]
        place_rc[cand] = rc_less
        first_sorted = first[order]
        for fi in first_sorted:
            place_list.append(canon[fi, : clen[fi]].copy())
        place_of_read = {
            pl.tobytes(): j for j, pl in enumerate(place_list)
        }

    if extend_paths and place_list:
        fo, fe, to, te = hbv.vertex_csr()
        seen = set(place_of_read.keys())
        for si in range(len(place_list)):
            pl = [int(x) for x in place_list[si]]
            pset = set(pl)
            v = int(hbv.to_left[pl[0]])
            if to[v + 1] - to[v] == 1:
                e = int(te[to[v]])
                if e not in pset:
                    pl.insert(0, e)
                    pset.add(e)
            w = int(hbv.to_right[pl[-1]])
            if fo[w + 1] - fo[w] == 1:
                e = int(fe[fo[w]])
                if e not in pset:
                    pl.append(e)
            if len(pl) > len(place_list[si]):
                key = np.asarray(pl, np.int32).tobytes()
                if key not in seen:
                    seen.add(key)
                    place_list.append(np.asarray(pl, np.int32))

    return place_idx, place_rc, place_list


def _place_sequences(hbv, place_list, k2: int):
    """(flat bases, seg_offsets (S+1,), left_trunc, right_trunc): place
    sequences with K2 truncation of first/last edges (:159-182)."""
    k = hbv.k
    lens = hbv.edge_len()
    S = len(place_list)
    seq_list = []
    left_trunc = np.zeros(S, dtype=np.int64)
    right_trunc = np.zeros(S, dtype=np.int64)
    for si, pl in enumerate(place_list):
        b = hbv.edge_seq(int(pl[0])).copy()
        for e in pl[1:]:
            b = np.concatenate([b[: -(k - 1)], hbv.edge_seq(int(e))])
        if len(pl) > 1:
            last = int(pl[-1])
            if lens[last] > k2:
                cut = int(lens[last] - k2)
                b = b[:-cut]
                right_trunc[si] = cut
            first = int(pl[0])
            if lens[first] > k2:
                cut = int(lens[first] - k2)
                b = b[cut:]
                left_trunc[si] = cut
        seq_list.append(b)

    seg_offsets = np.zeros(S + 1, dtype=np.int64)
    seg_offsets[1:] = np.cumsum([len(s) for s in seq_list])
    flat = np.concatenate(seq_list) if seq_list else np.zeros(0, np.uint8)
    return flat, seg_offsets, left_trunc, right_trunc


def _translate(paths, place_idx, place_rc, ipaths2, starts, stops,
               left_trunc, right_trunc, inv2) -> ReadPathVec:
    """Read paths in the K2 graph through their places' walks (:196-245)."""
    n = paths.n_reads
    ok = place_idx >= 0
    pl_len = np.fromiter(
        (len(u) for u in ipaths2), dtype=np.int64, count=len(ipaths2)
    )
    poffs = np.zeros(len(ipaths2) + 1, dtype=np.int64)
    poffs[1:] = np.cumsum(pl_len)
    ppool = (
        np.concatenate(ipaths2).astype(np.int32)
        if len(ipaths2)
        else np.zeros(0, np.int32)
    )

    new_lens = np.zeros(n, dtype=np.int64)
    new_lens[ok] = pl_len[place_idx[ok]]
    offsets = np.zeros(n + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(new_lens)
    flat_edges = np.zeros(int(offsets[-1]), dtype=np.int32)
    start_off = np.zeros(n, dtype=np.int32)

    rid = np.flatnonzero(new_lens > 0)
    if len(rid):
        si = place_idx[rid]
        l_r = new_lens[rid]
        rows = np.repeat(np.arange(len(rid)), l_r)
        within = (
            np.arange(len(rows)) - np.repeat(np.cumsum(l_r) - l_r, l_r)
        )
        dst = np.repeat(offsets[rid], l_r) + within
        is_rc = np.repeat(place_rc[rid], l_r)
        src_fwd = np.repeat(poffs[si], l_r) + within
        src_rc = np.repeat(poffs[si + 1] - 1, l_r) - within
        src = np.where(is_rc, src_rc, src_fwd)
        vals = ppool[src]
        flat_edges[dst] = np.where(is_rc, inv2[vals], vals)
        fwd_r = rid[~place_rc[rid]]
        rc_r = rid[place_rc[rid]]
        start_off[fwd_r] = (
            paths.start[fwd_r]
            + starts[place_idx[fwd_r]]
            - left_trunc[place_idx[fwd_r]]
        )
        start_off[rc_r] = (
            paths.start[rc_r]
            + stops[place_idx[rc_r]]
            - right_trunc[place_idx[rc_r]]
        )
    return ReadPathVec(offsets, flat_edges, start_off)


def repath(hbv, paths, k2: int, extend_paths: bool = False, device="cuda", mesh=None):
    """Returns (hbv2, paths2, dict2); dict2 is None when no place exists.

    extend_paths mirrors the reference's EXTEND_PATHS branch
    (Repath.cc:74-97): each unique place is extended by at most one
    solo in-edge on the left and one solo out-edge on the right (the
    reference loop re-tests the same vertex, so it never walks further),
    and the extended copies join the place pool for the K2 graph.

    mesh (a parallel.mesh.Mesh): the K2 count, adjacencies, unitig links
    and flat pathing run sharded over its devices (JAX :185-192), bit for
    bit the unsharded run; `device` is then its first device.
    """
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    with timed("step3.places", dev):
        place_idx, place_rc, place_list = _places(hbv, paths, k2, extend_paths)
        if not place_list:
            empty = HyperBasevector(
                k2,
                np.zeros(0, np.uint8),
                np.zeros(1, np.int64),
                np.zeros(0, np.int32),
                np.zeros(0, np.int32),
                np.zeros(0, np.int32),
                0,
            )
            return empty, ReadPathVec(
                np.zeros(paths.n_reads + 1, np.int64),
                np.zeros(0, np.int32),
                np.zeros(paths.n_reads, np.int32),
            ), None
        flat, seg_offsets, left_trunc, right_trunc = _place_sequences(
            hbv, place_list, k2
        )

    # ---- K2 graph -----------------------------------------------------
    with timed("step3.count", dev):
        d2 = ke.count_kmers_flat(flat, seg_offsets, k2, min_freq=1, device=dev,
                                 span="step3.count", mesh=mesh)
    with timed("step3.adjacencies", dev):
        gb.recompute_adjacencies(d2, mesh=mesh)
    with timed("step3.unitigs", dev):
        eb, es = gb.build_unitigs(d2, span="step3.unitigs", mesh=mesh)
    with timed("step3.hbv", dev):
        hbv2, fx2, rx2 = gb.build_hbv_from_edges(eb, es, k2)

    # ---- place walks in the new graph ---------------------------------
    with timed("step3.pathing", dev):
        ipaths2, starts, stops = flat_pather.path_flat_sequences(
            flat, seg_offsets, d2, hbv2, fx2, rx2, mesh=mesh
        )
    with timed("step3.translate", dev):
        paths2 = _translate(paths, place_idx, place_rc, ipaths2, starts, stops,
                            left_trunc, right_trunc, hbv2.inv)
    return hbv2, paths2, d2
