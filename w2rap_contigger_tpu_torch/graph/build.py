"""Unitig construction + HBV assembly from the device-resident dictionary.

Counterpart of w2rap_contigger_tpu/graph/build.py on its device route
(the device-dictionary branch, build.py:288-320 and :488-538):

* adjacency pruning = 8 batched dictionary lookups per kmer
  (`recompute_adjacencies`, build.py:230-250; AdjProc,
  src/kmers/ReadPather.h:307-342);
* oriented unitig links with the palindrome and hairpin guards
  (`links_core`, build.py:328-370);
* pointer-doubling list ranking (`list_rank`, build.py:410-437).

All three are torch on the dictionary's device.  The chain assembly
after ranking (build.py:539-654, `_emit_cycles` :666) and
`build_hbv_from_edges` / `_palindromic_edges` (:725-839) are host numpy,
copied with their imports redirected to jax-free modules.  The table is
not padded (PyTorch has no compile cache to keep shapes stable for), so
no padded-node remap is needed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import timed
from ..ops import bitkmer as bk
from ..ops import context as kctx
from ..ops.lookup import n_iters_for, search
from ..shared import HyperBasevector
from ..shared import np_bitkmer as hbk

# nodes per links/adjacency dispatch: bounds the (nodes, W) neighbour
# planes each pass materializes (build.py:391)
NODE_CHUNK = 1 << 22


# ---------------------------------------------------------------------------
# adjacency recompute
# ---------------------------------------------------------------------------


def adjacencies_core(table_t, words, ctx, k: int, n_iters: int):
    """Prune context bits whose neighbour kmer is absent from the table."""
    new_ctx = torch.zeros_like(ctx)
    for code in range(4):
        succ_c, _ = bk.canonicalize(bk.to_successor(words, code, k), k)
        _, found = search(table_t, succ_c.T, n_iters)
        keep = ((ctx >> code) & 1).bool() & found
        new_ctx |= keep.to(torch.int64) << code
        pred_c, _ = bk.canonicalize(bk.to_predecessor(words, code, k), k)
        _, foundp = search(table_t, pred_c.T, n_iters)
        keepp = ((ctx >> (code + 4)) & 1).bool() & foundp
        new_ctx |= keepp.to(torch.int64) << (code + 4)
    return new_ctx


def recompute_adjacencies(d):
    """Replace d.ctx by its pruned form, on the dictionary's device."""
    M = d.size
    if M == 0:
        return d
    table_t = d.table_t()
    n_iters = n_iters_for(M)
    parts = [
        adjacencies_core(table_t, d.words[s : s + NODE_CHUNK],
                         d.ctx[s : s + NODE_CHUNK], d.k, n_iters)
        for s in range(0, M, NODE_CHUNK)
    ]
    d.ctx = torch.cat(parts)
    return d


# ---------------------------------------------------------------------------
# oriented links + list ranking
# ---------------------------------------------------------------------------


def links_core(words, ctx, k: int, n_iters: int, node_ids, table_t, pal):
    """next[n] for oriented nodes n = i + o*M (o=0 fwd canonical, o=1
    rc) against the full table (table_t = words.T, pal = its palindrome
    mask); -1 where no unitig link leaves n.

    Link rule (upstream/downstreamExtensionPossible,
    BuildReadQGraph.cc:195-221): u->v iff succ_count(u)==1,
    pred_count(v)==1 and neither kmer is a palindrome; a hairpin link
    u -> rc(u) is broken rather than fatal (BuildReadQGraph.cc:296-303).
    """
    M = words.shape[0]
    kid_o = node_ids % M
    src_rev = node_ids >= M
    w_k = words[kid_o]
    w_o = torch.where(src_rev[:, None], bk.rc_words(w_k, k), w_k)
    c_k = ctx[kid_o]
    ctx_o = torch.where(src_rev, kctx.rc_context(c_k), c_k)
    pal_o = pal[kid_o]

    succ_bits = kctx.succ_bits(ctx_o)
    scount = kctx.popcount4(succ_bits)
    scode = kctx.single_base(succ_bits)

    succ_canon, succ_isrev = bk.canonicalize(bk.to_successor(w_o, scode, k), k)
    vidx, found = search(table_t, succ_canon.T, n_iters)
    v = vidx + succ_isrev.to(torch.int64) * M

    vctx_can = ctx[vidx]
    vctx = torch.where(succ_isrev, kctx.rc_context(vctx_can), vctx_can)
    vpred = kctx.popcount4(kctx.pred_bits(vctx))
    vpal = pal[vidx]
    hairpin = (vidx == kid_o) & (succ_isrev != src_rev)
    ok = (scount == 1) & found & ~pal_o & ~vpal & (vpred == 1) & ~hairpin
    return torch.where(ok, v, -1)


def build_links(words, ctx, k: int, n_iters: int):
    """next (2M,) int64 over every oriented node, in NODE_CHUNK passes."""
    M = words.shape[0]
    table_t = words.T.contiguous()
    pal = bk.is_palindrome(words, k)
    parts = []
    for s in range(0, 2 * M, NODE_CHUNK):
        ids = torch.arange(s, min(s + NODE_CHUNK, 2 * M), device=words.device)
        parts.append(links_core(words, ctx, k, n_iters, ids, table_t, pal))
    return torch.cat(parts)


def list_rank(nxt, n_iters: int):
    """Pointer doubling on prev pointers, prev[n] = rc(next[rc(n)]).

    Returns (head, rank, on_cycle), each (2M,): linear chains end with
    ptr at their head; on cycles prev[ptr] >= 0.
    """
    N2 = nxt.shape[0]
    M = N2 // 2
    n = torch.arange(N2, device=nxt.device)
    rc_n = torch.where(n < M, n + M, n - M)
    nxt_rc = nxt[rc_n]
    prev = torch.where(
        nxt_rc >= 0, torch.where(nxt_rc < M, nxt_rc + M, nxt_rc - M), -1
    )
    ptr = torch.where(prev >= 0, prev, n)
    dist = (prev >= 0).to(torch.int64)
    for _ in range(n_iters):
        dist = dist + dist[ptr]
        ptr = ptr[ptr]
    on_cycle = prev[ptr] >= 0
    return ptr, dist, on_cycle


def rank_iters_for(m: int) -> int:
    return max(1, int(math.ceil(math.log2(2 * m + 1))) + 1)


# ---------------------------------------------------------------------------
# host assembly (numpy, copied from the JAX package's graph/build.py)
# ---------------------------------------------------------------------------


def _oriented_kmer_words(words, rcw, node_ids, M):
    """Packed words of oriented nodes (gather + orientation select)."""
    kid = node_ids % M
    ori = (node_ids // M).astype(bool)
    return np.where(ori[:, None], rcw[kid], words[kid])


def build_unitigs(d):
    """Canonical unitig edge set from the dictionary.

    Returns (edge_bases flat uint8, edge_start (E+1) int64) and fills the
    KDef planes d.edge_id / d.edge_offset / d.edge_rc (host numpy) and
    d.kdef (their device copies, for pathing).
    """
    M = d.size
    k = d.k
    dev = d.device
    if M == 0:
        d.edge_id = np.zeros(0, np.int32)
        d.edge_offset = np.zeros(0, np.int32)
        d.edge_rc = np.zeros(0, bool)
        d.kdef = _kdef_to_device(d, dev)
        return np.zeros(0, np.uint8), np.zeros(1, np.int64)

    with timed("step2.unitigs.device", dev):
        nxt_d = build_links(d.words, d.ctx, k, n_iters_for(M))
        head_d, rank_d, cyc_d = list_rank(nxt_d, rank_iters_for(M))
        nxt = nxt_d.cpu().numpy().astype(np.int32)
        head = head_d.cpu().numpy().astype(np.int32)
        rank = rank_d.cpu().numpy().astype(np.int32)
        on_cycle = cyc_d.cpu().numpy()

    words = d.host("words")
    rcw = hbk.rc_words(words, k)
    kmer_last = hbk.last_base(words, k).astype(np.uint8)  # (M,)
    rc_last = hbk.last_base(rcw, k).astype(np.uint8)

    # ---- linear chains: group oriented nodes by (head, rank) ----------
    lin_mask = ~on_cycle
    node = np.arange(2 * M, dtype=np.int64)
    lin_nodes_u = node[lin_mask]
    order = np.lexsort((rank[lin_mask], head[lin_mask]))
    lin_nodes = lin_nodes_u[order]
    lin_heads = head[lin_mask][order]

    seg_start = np.flatnonzero(
        np.concatenate([[True], lin_heads[1:] != lin_heads[:-1]])
    )
    seg_len = np.diff(np.concatenate([seg_start, [len(lin_nodes)]]))
    n_chains = len(seg_start)
    seg_head = lin_nodes[seg_start]
    seg_tail = lin_nodes[seg_start + seg_len - 1]

    # ---- keep exactly one of each chain/mirror pair -------------------
    head_w = _oriented_kmer_words(words, rcw, seg_head, M)
    tail_w = _oriented_kmer_words(words, rcw, seg_tail, M)
    mirror_head_w = hbk.rc_words(tail_w, k)
    lt = hbk.words_lt(head_w, mirror_head_w)
    eq = hbk.words_eq(head_w, mirror_head_w)
    keep = lt.copy()

    tie_idx = np.flatnonzero(eq)
    hori = (seg_head // M).astype(np.int32)

    # ---- materialize all chain sequences (vectorized) -----------------
    nid = (lin_nodes % M).astype(np.int64)
    nori = (lin_nodes // M).astype(bool)
    lastb = np.where(nori, rc_last[nid], kmer_last[nid])

    chain_lens = seg_len + k - 1
    cstart = np.zeros(n_chains + 1, dtype=np.int64)
    cstart[1:] = np.cumsum(chain_lens)
    flat_all = np.zeros(int(cstart[-1]), dtype=np.uint8)
    head_codes = hbk.unpack_words(head_w, k)[:, : k - 1]
    flat_all[cstart[:-1][:, None] + np.arange(k - 1)[None, :]] = head_codes
    pos_chain = np.repeat(np.arange(n_chains), seg_len)
    pos_rank = np.arange(len(lin_nodes)) - np.repeat(seg_start, seg_len)
    flat_all[cstart[pos_chain] + (k - 1) + pos_rank] = lastb

    for ci in tie_idx:
        seq = flat_all[cstart[ci] : cstart[ci + 1]]
        rcseq = (3 - seq)[::-1]
        a, b = seq.tobytes(), rcseq.tobytes()
        if a < b:
            keep[ci] = True
        elif a == b:
            keep[ci] = hori[ci] == 0  # palindrome: keep one copy

    kept_idx = np.flatnonzero(keep)
    n_lin_edges = len(kept_idx)
    chain_eid = np.full(n_chains, -1, dtype=np.int64)
    chain_eid[kept_idx] = np.arange(n_lin_edges)

    kept_lens = chain_lens[kept_idx]
    edge_start = np.zeros(n_lin_edges + 1, dtype=np.int64)
    edge_start[1:] = np.cumsum(kept_lens)
    edge_bases = np.zeros(int(edge_start[-1]), dtype=np.uint8)
    src_pos = np.repeat(cstart[kept_idx], kept_lens) + _ragged_arange(kept_lens)
    edge_bases[:] = flat_all[src_pos]

    # ---- per-kmer KDef assignment -------------------------------------
    edge_id = np.full(M, -1, dtype=np.int32)
    edge_offset = np.zeros(M, dtype=np.int32)
    edge_rc = np.zeros(M, dtype=bool)
    sel = chain_eid[pos_chain] >= 0
    kmer_sel = nid[sel]
    if np.any(edge_id[kmer_sel] >= 0) or len(np.unique(kmer_sel)) != len(kmer_sel):
        raise RuntimeError("preoccupied kmer — broken unitig links")
    edge_id[kmer_sel] = chain_eid[pos_chain[sel]]
    edge_offset[kmer_sel] = pos_rank[sel]
    edge_rc[kmer_sel] = nori[sel]

    # ---- cycles (host walk; rare) -------------------------------------
    if on_cycle.any():
        extra_edges, extra_kdef = _emit_cycles(
            nxt, on_cycle, words, rcw, kmer_last, rc_last, k, M, n_lin_edges
        )
        if extra_edges:
            add_flat, add_start = HyperBasevector.from_edge_list(k, extra_edges)
            edge_bases = np.concatenate([edge_bases, add_flat])
            edge_start = np.concatenate(
                [edge_start, edge_start[-1] + add_start[1:]]
            )
            for i, e, j, o in extra_kdef:
                if edge_id[i] >= 0:
                    raise RuntimeError("preoccupied kmer in cycle")
                edge_id[i] = e
                edge_offset[i] = j
                edge_rc[i] = bool(o)

    if np.any(edge_id < 0):
        raise RuntimeError("kmers not covered by any edge")
    d.edge_id = edge_id
    d.edge_offset = edge_offset
    d.edge_rc = edge_rc
    d.kdef = _kdef_to_device(d, dev)
    return edge_bases, edge_start


def _kdef_to_device(d, dev):
    return (
        torch.from_numpy(d.edge_id.astype(np.int64)).to(dev),
        torch.from_numpy(d.edge_offset.astype(np.int64)).to(dev),
        torch.from_numpy(d.edge_rc).to(dev),
    )


def _ragged_arange(lens):
    """concat([arange(l) for l in lens]) without a python loop."""
    total = int(lens.sum())
    out = np.arange(total, dtype=np.int64)
    starts = np.zeros(len(lens), dtype=np.int64)
    starts[1:] = np.cumsum(lens)[:-1]
    return out - np.repeat(starts, lens)


def _emit_cycles(nxt, on_cycle, words, rcw, kmer_last, rc_last, k, M, eid0):
    """Smooth circles: walk each cycle once, canonicalize by minimum
    oriented kmer + FWD form (EdgeBuilder::canonicalizeCircle)."""
    edges = []
    kdef = []
    todo = set(np.flatnonzero(on_cycle[:M]).tolist())

    def okmer_bytes(n):
        kid = n % M
        w = rcw[kid] if n >= M else words[kid]
        return hbk.unpack_words(w[None], k)[0].tobytes()

    while todo:
        i = min(todo)
        chain = []
        n = i
        while True:
            chain.append(n)
            n = int(nxt[n])
            assert n >= 0, "cycle node with no successor"
            if n % M == i:
                break
        for c in chain:
            todo.discard(c % M)

        def build_seq(ch):
            first = np.frombuffer(okmer_bytes(ch[0]), dtype=np.uint8)[: k - 1]
            lb = np.array(
                [
                    rc_last[c % M] if c >= M else kmer_last[c % M]
                    for c in ch
                ],
                dtype=np.uint8,
            )
            return np.concatenate([first, lb])

        def min_rotate(ch):
            mp = min(range(len(ch)), key=lambda j: okmer_bytes(ch[j]))
            return ch[mp:] + ch[:mp]

        chain = min_rotate(chain)
        seq = build_seq(chain)
        rcseq = (3 - seq)[::-1]
        if rcseq.tobytes() < seq.tobytes():
            chain = [(c + M) % (2 * M) for c in reversed(chain)]
            chain = min_rotate(chain)
            seq = build_seq(chain)
        eid = eid0 + len(edges)
        edges.append(seq)
        for j, c in enumerate(chain):
            kdef.append((c % M, eid, j, 1 if c >= M else 0))
    return edges, kdef


# ---------------------------------------------------------------------------
# HBV from canonical edges (host numpy)
# ---------------------------------------------------------------------------


def build_hbv_from_edges(edge_bases, edge_start, k: int):
    """Canonical edges -> HyperBasevector with fwd+rc edge copies.

    Mirrors buildHBVFromEdges (src/paths/long/HBVFromEdges.cc:78-160):
    vertices are the distinct (k-1)-mer edge ends over both orientations;
    per input edge i the fwd copy is added, then the rc copy unless the
    edge is palindromic.  Returns (hbv, fwd_xlat (E,), rev_xlat (E,)).
    """
    E = len(edge_start) - 1
    if E == 0:
        return (
            HyperBasevector(
                k,
                np.zeros(0, np.uint8),
                np.zeros(1, np.int64),
                np.zeros(0, np.int32),
                np.zeros(0, np.int32),
                np.zeros(0, np.int32),
                0,
            ),
            np.zeros(0, np.int32),
            np.zeros(0, np.int32),
        )
    ko = k - 1
    W = hbk.nwords(ko)
    lens = np.diff(edge_start)

    prox_pos = edge_start[:-1][:, None] + np.arange(ko)[None, :]
    dist_pos = (edge_start[1:] - ko)[:, None] + np.arange(ko)[None, :]
    prox = edge_bases[prox_pos]
    dist = edge_bases[dist_pos]
    prox_w = hbk.pack_codes(prox, ko)
    dist_w = hbk.pack_codes(dist, ko)
    rc_prox_w = hbk.rc_words(dist_w, ko)  # rc edge's proximal end
    rc_dist_w = hbk.rc_words(prox_w, ko)

    is_pal = _palindromic_edges(edge_bases, edge_start)

    allw = np.ascontiguousarray(
        np.concatenate([prox_w, dist_w, rc_prox_w, rc_dist_w], axis=0)
    )
    # vertex ids = rank in the words-lexicographic unique order
    n_all = allw.shape[0]
    sorder = np.lexsort(tuple(allw[:, c] for c in range(W - 1, -1, -1)))
    sa = allw[sorder]
    new_grp = np.empty(n_all, dtype=bool)
    new_grp[0] = True
    new_grp[1:] = (sa[1:] != sa[:-1]).any(axis=1)
    grp_sorted = np.cumsum(new_grp) - 1
    vid = np.empty(n_all, dtype=np.int32)
    vid[sorder] = grp_sorted.astype(np.int32)
    n_vertices = int(grp_sorted[-1]) + 1
    fw_v1, fw_v2 = vid[:E], vid[E : 2 * E]
    rc_v1, rc_v2 = vid[2 * E : 3 * E], vid[3 * E :]

    # emit edges: fwd then rc (unless palindrome), like the reference
    n_out = int(2 * E - is_pal.sum())
    fwd_xlat = np.cumsum(np.concatenate([[0], 2 - is_pal[:-1]])).astype(
        np.int32
    )
    rev_xlat = np.where(is_pal, fwd_xlat, fwd_xlat + 1).astype(np.int32)

    to_left = np.zeros(n_out, dtype=np.int32)
    to_right = np.zeros(n_out, dtype=np.int32)
    inv = np.zeros(n_out, dtype=np.int32)
    to_left[fwd_xlat] = fw_v1
    to_right[fwd_xlat] = fw_v2
    inv[fwd_xlat] = rev_xlat
    to_left[rev_xlat] = np.where(is_pal, fw_v1, rc_v1)
    to_right[rev_xlat] = np.where(is_pal, fw_v2, rc_v2)
    inv[rev_xlat] = fwd_xlat

    # base pool: fwd seq at fwd slot, rc seq at rev slot
    out_lens = np.zeros(n_out, dtype=np.int64)
    out_lens[fwd_xlat] = lens
    out_lens[rev_xlat] = lens
    out_start = np.zeros(n_out + 1, dtype=np.int64)
    out_start[1:] = np.cumsum(out_lens)
    flat = np.zeros(int(out_start[-1]), dtype=np.uint8)
    src = np.repeat(edge_start[:-1], lens) + _ragged_arange(lens)
    dst = np.repeat(out_start[fwd_xlat], lens) + _ragged_arange(lens)
    flat[dst] = edge_bases[src]
    np_pal = ~is_pal
    if np_pal.any():
        lens_r = lens[np_pal]
        src_r = np.repeat(edge_start[:-1][np_pal], lens_r) + _ragged_arange(
            lens_r
        )
        rev_off = np.repeat(lens_r, lens_r) - 1 - _ragged_arange(lens_r)
        dst_r = np.repeat(out_start[rev_xlat[np_pal]], lens_r) + rev_off
        flat[dst_r] = 3 - edge_bases[src_r]

    hbv = HyperBasevector(
        k, flat, out_start, to_left, to_right, inv, int(n_vertices)
    )
    return hbv, fwd_xlat, rev_xlat


def _palindromic_edges(edge_bases, edge_start):
    """Per-edge palindrome (seq == rc seq) test."""
    E = len(edge_start) - 1
    lens = np.diff(edge_start)
    out = np.zeros(E, dtype=bool)
    cand = lens % 2 == 0  # odd-length DNA rc-palindromes are impossible
    for i in np.flatnonzero(cand):
        s = edge_bases[edge_start[i] : edge_start[i + 1]]
        out[i] = np.array_equal(s, (3 - s)[::-1])
    return out
