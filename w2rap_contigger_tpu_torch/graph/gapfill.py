"""fillGaps + joinOverlaps — optional step-2 graph repair passes
(--fill_join), on the dictionary's device.

Counterpart of w2rap_contigger_tpu/graph/gapfill.py.  The host numpy
passes (`_interior_gaps`, `_gap_conforming`, `_group_canonical`,
`_canonical_with_ctx`, `fill_gaps`, `join_overlaps`) are copied; the read
pathing of `_raw_parts` runs the port's device lookup
(`paths.pather.lookup_core`, the counterpart of JAX's `_lookup_chunk`,
pather.py:78) with identity edge translations on the dictionary's
device, and the merged dictionary goes back to that device before the
adjacency re-prune and the unitig rebuild (graph/build.py).

Semantics matched (TPU-native reformulation, not a translation):

* ``fill_gaps`` — GapFiller + fillGaps
  (reference src/paths/long/BuildReadQGraph.cc:566-651): path every read
  against the current dict/edges; for every interior captured gap that
  is not graph-conforming (jitter 1, BuildReadQGraph.cc:622) and within
  ``max_gap_size`` (0 = unlimited, the driver's value at
  w2rap-contigger.cc:338), re-kmerize the gap span of the read, count
  the emitted kmers globally, and insert those seen >= ``min_freq2``
  times into the dictionary; the two boundary kmers get their contexts
  extended toward the gap (GapFiller::update,
  BuildReadQGraph.cc:616-621).  Adjacencies are then re-pruned and the
  unitig edge set rebuilt (fillGaps, BuildReadQGraph.cc:631-651).

* ``join_overlaps`` — BRQ_Joiner + joinOverlaps
  (BuildReadQGraph.cc:653-806): every interior captured gap of length
  <= K/2 implies a (K - gap - 1)-base overlap between the flanking
  edge loci; joins observed >= ``min_freq2`` times whose overlap
  sequences actually agree (BRQ_Joiner::validOverlap,
  BuildReadQGraph.cc:722-746) yield a 2K-overlap "fake read" spanning
  the junction, whose kmers are processed into the dictionary before
  the edge set is rebuilt (joinOverlaps, BuildReadQGraph.cc:784-806 —
  note: no adjacency re-prune there, and none here).

Both passes are off by default (FILL_JOIN = False,
w2rap-contigger.cc:336) and exposed via ``--fill_join``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import state
from ..ops import bitkmer as bk
from ..ops import context as kctx
from ..ops import kmer_engine as ke
from ..ops import np_bitkmer as hbk
from ..ops.kmerize import pack_rows_host
from ..ops.lookup import n_iters_for
from ..paths import pather

GAPFILL_MAX_JITTER = 1  # GapFiller::MAX_JITTER, BuildReadQGraph.cc:622


def _raw_parts(reads, d, edge_start, chunk_reads: int = 65536):
    """Path reads against the raw unitig edges (BRQ_Pather equivalent)
    on the dictionary's device.

    Returns flat part arrays sorted by (read, position):
    (rid, pos, plen, eori, off, ekm) where ``eori`` is the oriented raw
    edge id (e for fwd, e + E for rc; -1 for a gap part), ``off`` the
    kmer-unit offset of the part's first kmer on the oriented edge, and
    ``plen`` the part length in kmer positions (gap lengths are counts
    of missing kmer positions, as in BRQ_Pather::path,
    BuildReadQGraph.cc:497-548).
    """
    k = d.k
    n, L = reads.n_reads, reads.max_len
    if L < k or d.size == 0:
        # reads shorter than k hold no kmer, and an empty dict finds
        # none: no part has an edge on both sides
        z = np.zeros(0, np.int64)
        return z, z, z, z.astype(np.int32), z, z
    dev = d.device
    n_iters = n_iters_for(d.size)
    table_t = d.table_t()
    kdef_edge, kdef_off, kdef_rc = d.kdef
    E = len(edge_start) - 1
    fwd = torch.arange(E, dtype=torch.int64, device=dev)
    rev = fwd + E
    ekm_raw = torch.from_numpy((np.diff(edge_start) - k + 1).astype(np.int64)).to(dev)

    acc = [[] for _ in range(6)]
    for start in range(0, n, chunk_reads):
        stop = min(start + chunk_reads, n)
        nb = stop - start
        cl = np.ascontiguousarray(reads.lengths[start:stop], dtype=np.int32)
        packed = pack_rows_host(reads.bases[start:stop])
        dp = bk.from_raw32(torch.from_numpy(packed.view(np.int32)).to(dev))
        dl = torch.from_numpy(cl.astype(np.int64)).to(dev)
        he, off, ekm_at = (
            t.cpu().numpy().astype(np.int32) for t in pather.lookup_core(
                dp, dl, table_t, kdef_edge, kdef_off, kdef_rc, fwd, rev,
                ekm_raw, k, n_iters, L,
            )
        )
        prev_e = np.concatenate(
            [np.full((nb, 1), -3, np.int32), he[:, :-1]], 1
        )
        prev_o = np.concatenate(
            [np.zeros((nb, 1), np.int32), off[:, :-1]], 1
        )
        in_range = he != -2
        new_run = in_range & (
            (he != prev_e) | ((he >= 0) & (off != prev_o + 1))
        )
        rid, pos = np.nonzero(new_run)
        if len(rid) == 0:
            continue
        n_valid = np.maximum(cl - k + 1, 0)
        last = np.concatenate([rid[1:] != rid[:-1], [True]])
        nstart = np.concatenate([pos[1:], [0]])
        plen = np.where(last, n_valid[rid] - pos, nstart - pos)
        acc[0].append(rid.astype(np.int64) + start)
        acc[1].append(pos.astype(np.int64))
        acc[2].append(plen.astype(np.int64))
        acc[3].append(he[rid, pos])
        acc[4].append(off[rid, pos].astype(np.int64))
        acc[5].append(ekm_at[rid, pos].astype(np.int64))
    if not acc[0]:
        z = np.zeros(0, np.int64)
        return z, z, z, z.astype(np.int32), z, z
    return tuple(np.concatenate(a) for a in acc)


def _interior_gaps(rid, pos, plen, eori):
    """Mask of gap parts with edge parts on both sides (flat indexing).

    A gap run can never neighbor another gap run, so an interior gap's
    flat neighbors i-1/i+1 are the sandwiching edge parts whenever the
    gap is neither first nor last part of its read.
    """
    first = np.concatenate([[True], rid[1:] != rid[:-1]])
    last = np.concatenate([rid[1:] != rid[:-1], [True]])
    return (eori == -1) & ~first & ~last


def _gap_conforming(idx, plen, eori, off, ekm, jitter):
    """isConformingCapturedGap (BuildReadQGraph.cc:467-474) for flat
    gap indices ``idx`` (callers guarantee both neighbors are edges)."""
    im1 = idx - 1
    ip1 = idx + 1
    same = eori[im1] == eori[ip1]  # same edge AND same orientation
    graph_dist = off[ip1] - (off[im1] + plen[im1])
    graph_dist = graph_dist + np.where(same, 0, ekm[im1])
    return np.abs(plen[idx] - graph_dist) <= jitter


def _group_canonical(words, ctx):
    """Collapse duplicate canonical kmers: (words, ctx OR, count)."""
    v = ke._vview(words)
    order = np.argsort(v, kind="stable")
    vs = v[order]
    newgrp = np.concatenate([[True], vs[1:] != vs[:-1]])
    gidx = np.flatnonzero(newgrp)
    cnt = np.diff(np.concatenate([gidx, [len(vs)]]))
    gctx = np.bitwise_or.reduceat(ctx[order], gidx)
    return words[order][gidx], gctx, cnt


def _canonical_with_ctx(codes, ctx, k):
    """Pack (M, k) base codes, canonicalize, rc-adjust contexts."""
    words = hbk.pack_codes(codes, k)
    canon, is_rev = hbk.canonicalize(words, k)
    canon = np.asarray(canon)
    is_rev = np.asarray(is_rev)
    ctx = np.where(is_rev, kctx.rc_context(ctx), ctx)
    return canon, ctx


def fill_gaps(
    reads, d, edge_bases, edge_start,
    max_gap_size: int, min_freq2: int, chunk_reads: int = 65536,
):
    """GapFiller + fillGaps (BuildReadQGraph.cc:566-651).

    Returns (new dict, edge_bases, edge_start); ``d`` is not mutated.
    """
    from . import build as gb

    rid, pos, plen, eori, off, ekm = _raw_parts(
        reads, d, edge_start, chunk_reads
    )
    sel = _interior_gaps(rid, pos, plen, eori)
    idx = np.flatnonzero(sel)
    if max_gap_size:
        idx = idx[plen[idx] <= max_gap_size]
    if len(idx):
        conf = _gap_conforming(idx, plen, eori, off, ekm, GAPFILL_MAX_JITTER)
        idx = idx[~conf]
    if len(idx) == 0:
        return d, edge_bases, edge_start

    g_rid = rid[idx]
    g_p0 = pos[idx]
    g_len = plen[idx]
    k = d.k
    bases = reads.bases

    # ---- emitted gap kmers (GapFiller::map, BuildReadQGraph.cc:575-604)
    rep_r = np.repeat(g_rid, g_len)
    q = np.repeat(g_p0, g_len) + gb._ragged_arange(g_len)
    codes = bases[rep_r[:, None], q[:, None] + np.arange(k)]
    pred = bases[rep_r, q - 1].astype(np.uint32)
    succ = bases[rep_r, q + k].astype(np.uint32)
    ectx = kctx.make_context(pred, succ, np.uint32(1), np.uint32(1))
    canon, ectx = _canonical_with_ctx(codes, ectx, k)
    new_w, new_c, new_n = _group_canonical(canon, ectx)
    keep = new_n >= min_freq2  # GapFiller::reduce, BuildReadQGraph.cc:606
    new_w = new_w[keep]
    words, ctx, counts = d.host("words"), d.host("ctx"), d.host("counts")
    new_c = new_c[keep].astype(ctx.dtype)
    new_n = np.minimum(new_n[keep], 255).astype(counts.dtype)

    # ---- boundary context extension (GapFiller::update, :616-621) ----
    b_rid = np.concatenate([g_rid, g_rid])
    b_q = np.concatenate([g_p0 - 1, g_p0 + g_len])
    b_succ = bases[g_rid, g_p0 - 1 + k].astype(np.uint32)
    b_pred = bases[g_rid, g_p0 + g_len - 1].astype(np.uint32)
    zero = np.uint32(0)
    b_ctx = np.concatenate([
        kctx.make_context(zero, b_succ, zero, np.uint32(1)),
        kctx.make_context(b_pred, zero, np.uint32(1), zero),
    ])
    b_codes = bases[b_rid[:, None], b_q[:, None] + np.arange(k)]
    b_canon, b_ctx = _canonical_with_ctx(b_codes, b_ctx, k)

    dv = ke._vview(words)
    bv = ke._vview(b_canon)
    loc = np.searchsorted(dv, bv)
    locc = np.minimum(loc, len(dv) - 1)
    found = (loc < len(dv)) & (dv[locc] == bv)
    ctx2 = ctx.copy()
    np.bitwise_or.at(ctx2, locc[found], b_ctx[found].astype(ctx2.dtype))

    # ---- insert + rebuild (fillGaps, :631-651) ------------------------
    w2, c2, n2 = ke.host_merge_sorted(
        (words, ctx2, counts), (new_w, new_c, new_n)
    )
    d2 = state.dict_from_reference(w2, n2, c2, k, d.device)
    gb.recompute_adjacencies(d2)
    eb, es = gb.build_unitigs(d2, span="step2.fill_gaps.unitigs")
    return d2, eb, es


def _oriented_edge(edge_bases, edge_start, e, rc):
    seq = edge_bases[edge_start[e] : edge_start[e + 1]]
    return (3 - seq[::-1]).astype(np.uint8) if rc else seq


def join_overlaps(
    reads, d, edge_bases, edge_start,
    max_gap_size: int, min_freq2: int, chunk_reads: int = 65536,
):
    """BRQ_Joiner + joinOverlaps (BuildReadQGraph.cc:653-806).

    Returns (new dict, edge_bases, edge_start); ``d`` is not mutated.
    """
    from . import build as gb

    k = d.k
    assert max_gap_size < k - 1  # BRQ_Joiner ctor, BuildReadQGraph.cc:696
    rid, pos, plen, eori, off, ekm = _raw_parts(
        reads, d, edge_start, chunk_reads
    )
    E = len(edge_start) - 1
    sel = _interior_gaps(rid, pos, plen, eori)
    idx = np.flatnonzero(sel & (plen <= max_gap_size))
    if len(idx) == 0:
        return d, edge_bases, edge_start

    im1 = idx - 1
    ip1 = idx + 1
    e1, rc1 = eori[im1] % E, eori[im1] >= E
    e2, rc2 = eori[ip1] % E, eori[ip1] >= E
    # EdgeLocs of the flanking kmers (prev.lastLoc / next.firstLoc)
    o1 = off[im1] + plen[im1] - 1
    o2 = off[ip1]
    overlap = (k - plen[idx] - 1).astype(np.int64)
    # canonical join orientation (BRQ_Joiner::map, :707-712)
    swap = e2 < e1
    je1 = np.where(swap, e2, e1)
    jrc1 = np.where(swap, ~rc2, rc1)
    jo1 = np.where(swap, ekm[ip1] - o2 - 1, o1)
    je2 = np.where(swap, e1, e2)
    jrc2 = np.where(swap, ~rc1, rc2)
    # prev.rc().firstLoc() = ekm - lastLoc - 1 (PathPart::rc(),
    # BuildReadQGraph.cc:477-479, used by BRQ_Joiner::map :708-710)
    jo2 = np.where(swap, ekm[im1] - o1 - 1, o2)

    keys = np.stack(
        [je1, jrc1.astype(np.int64), jo1, je2, jrc2.astype(np.int64),
         jo2, overlap], axis=1,
    )
    order = np.lexsort(keys.T[::-1])
    ks = keys[order]
    newgrp = np.concatenate(
        [[True], np.any(ks[1:] != ks[:-1], axis=1)]
    )
    gidx = np.flatnonzero(newgrp)
    cnt = np.diff(np.concatenate([gidx, [len(ks)]]))
    joins = ks[gidx][cnt >= min_freq2]  # BRQ_Joiner::reduce, :714-721

    fake = []
    for a1, r1, p1, a2, r2, p2, ov in joins:
        b1 = _oriented_edge(edge_bases, edge_start, int(a1), bool(r1))
        b2 = _oriented_edge(edge_bases, edge_start, int(a2), bool(r2))
        end = int(p1) + k
        # validOverlap (:722-746)
        if not np.array_equal(
            b1[end - int(ov) : end], b2[int(p2) : int(p2) + int(ov)]
        ):
            continue
        # fake read = el1 kmer + el2 kmer past the overlap (:748-757)
        fake.append(np.concatenate(
            [b1[int(p1) : end], b2[int(p2) + int(ov) : int(p2) + k]]
        ))
    if not fake:
        return d, edge_bases, edge_start

    # ---- dict.process(fakeReads) (:795-801): every kmer of every fake
    # read, with read-internal contexts, merged into the dictionary.
    ws, cs = [], []
    for fr in fake:
        P = len(fr) - k + 1
        qs = np.arange(P)
        codes = fr[qs[:, None] + np.arange(k)]
        pred = np.where(qs > 0, fr[np.maximum(qs - 1, 0)], 0).astype(
            np.uint32
        )
        s_idx = np.minimum(qs + k, len(fr) - 1)
        succ = fr[s_idx].astype(np.uint32)
        has_p = (qs > 0).astype(np.uint32)
        has_s = (qs + k < len(fr)).astype(np.uint32)
        fctx = kctx.make_context(pred, succ, has_p, has_s)
        canon, fctx = _canonical_with_ctx(codes, fctx, k)
        ws.append(canon)
        cs.append(fctx)
    new_w, new_c, new_n = _group_canonical(
        np.concatenate(ws), np.concatenate(cs)
    )
    w2, c2, n2 = ke.host_merge_sorted(
        (d.host("words"), d.host("ctx"), d.host("counts")),
        (new_w, new_c.astype(np.uint32),
         np.minimum(new_n, 255).astype(np.int32)),
    )
    d2 = state.dict_from_reference(w2, n2, c2, k, d.device)
    # joinOverlaps rebuilds edges WITHOUT re-pruning adjacencies (:801-805)
    eb, es = gb.build_unitigs(d2, span="step2.join_overlaps.unitigs")
    return d2, eb, es
