"""Unitig construction + HBV assembly from the device-resident dictionary.

Counterpart of w2rap_contigger_tpu/graph/build.py on its device route
(the device-dictionary branch, build.py:288-320 and :488-538):

* adjacency pruning = 8 batched dictionary lookups per kmer
  (`recompute_adjacencies`, build.py:230-250; AdjProc,
  src/kmers/ReadPather.h:307-342);
* oriented unitig links with the palindrome and hairpin guards
  (`links_core`, build.py:328-370);
* pointer-doubling list ranking (`list_rank`, build.py:410-437).

All three are torch on the dictionary's device, or sharded over a
parallel.mesh.Mesh (`mesh=`: slices of the rows or nodes a shard, the
table replicated a device; JAX parallel/mesh.py:247-357).  The chain assembly
after ranking (build.py:539-654, `_emit_cycles` :666) and
`build_hbv_from_edges` / `_palindromic_edges` (:725-839) are host numpy,
copied with their imports redirected to jax-free modules.  The table is
not padded (PyTorch has no compile cache to keep shapes stable for), so
no padded-node remap is needed.

A HostKmerDict (step 5's blob-local graphs, `host=True`) takes the host
routes, copied from build.py:45-228: the C++ leaf native/graph_kernel.cc
(`w2rap_prune_ctx`, `w2rap_build_links`, `w2rap_list_rank`), or its
numpy mirror when the leaf does not build.  Blob graphs are a few
thousand kmers: a device round trip per op would cost more than the work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import timed
from ..ops import bitkmer as bk
from ..ops import context as kctx
from ..ops.kmer_engine import HostKmerDict
from ..ops import np_bitkmer as hbk
from ..ops.lookup import n_iters_for, search
from ..parallel.mesh import list_rank_sharded
from .hbv import HyperBasevector

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


def recompute_adjacencies(d, host: bool = False, mesh=None):
    """Replace d.ctx by its pruned form, on the dictionary's device; a
    host dict (or host=True) takes the host route (build.py:281-293).
    With a mesh, each shard prunes a contiguous slice of the rows against
    its device's replica of the table, and the slices gather on d's
    device (JAX mesh.py:276-297)."""
    M = d.size
    if M == 0:
        return d
    if host or isinstance(d, HostKmerDict):
        _need_host(d)
        lib = _native_graph_lib()
        if lib is not None:
            return _prune_ctx_native(lib, d)
        return recompute_adjacencies_host(d)
    n_iters = n_iters_for(M)
    if mesh is None:
        devices, slices, tables = [d.device], [(0, M)], [d.table_t()]
    else:
        devices, slices, tables = mesh.devices, mesh.slices(M), mesh.replicate(d.table_t())
    parts = []
    for dev, (lo, hi), table_t in zip(devices, slices, tables):
        words, ctx = d.words[lo:hi].to(dev), d.ctx[lo:hi].to(dev)
        parts += [
            adjacencies_core(table_t, words[s : s + NODE_CHUNK], ctx[s : s + NODE_CHUNK],
                             d.k, n_iters).to(d.device)
            for s in range(0, hi - lo, NODE_CHUNK)
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


def build_links(words, ctx, k: int, n_iters: int, mesh=None):
    """next (2M,) int64 over every oriented node, in NODE_CHUNK passes,
    on words' device.  With a mesh, each shard links a contiguous slice of
    the oriented node space against its device's replica of the table
    (JAX mesh.py:247-273)."""
    M = words.shape[0]
    if mesh is None:
        devices, slices = [words.device], [(0, 2 * M)]
    else:
        devices, slices = mesh.devices, mesh.slices(2 * M)
    replicas = {}
    parts = []
    for dev, (lo, hi) in zip(devices, slices):
        if dev not in replicas:
            w, c = words.to(dev), ctx.to(dev)
            replicas[dev] = (w, c, w.T.contiguous(), bk.is_palindrome(w, k))
        w, c, table_t, pal = replicas[dev]
        for s in range(lo, hi, NODE_CHUNK):
            ids = torch.arange(s, min(s + NODE_CHUNK, hi), device=dev)
            parts.append(links_core(w, c, k, n_iters, ids, table_t, pal).to(words.device))
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
# host routes for host dicts (build.py:45-228, copied)
# ---------------------------------------------------------------------------


def _need_host(d) -> None:
    if not isinstance(d, HostKmerDict):
        raise TypeError("the host route takes a HostKmerDict "
                        "(count_kmers_flat(..., host=True))")


def _native_graph_lib():
    """C++ adjacency/link/list-rank leaf (native/graph_kernel.cc), or
    None when it does not build."""
    from .. import native

    return native.load("w2rapgraph", ["graph_kernel.cc"], libs=["pthread"])


# The largest row the graph leaf holds (native/graph_kernel.cc MAX_W):
# 40 words, k = 640, the largest allowed -K.
NATIVE_MAX_W = 40


def _native_graph_call(fn, *args) -> None:
    """Call a graph-leaf entry that takes W as its fifth argument; the
    leaf returns -1, having written nothing, for a W it cannot hold."""
    import ctypes

    fn.restype = ctypes.c_int32
    if fn(*args) != 0:
        raise ValueError(f"the host graph leaf holds rows of at most {NATIVE_MAX_W} "
                         f"words (k <= {16 * NATIVE_MAX_W}); got {args[4].value} words")


def _graph_threads():
    import os

    return int(os.environ.get("OMP_NUM_THREADS", "0")) or (
        os.cpu_count() or 1
    )


def _prune_ctx_native(lib, d):
    import ctypes

    words = np.ascontiguousarray(d.words, dtype=np.uint32)
    ctx = np.ascontiguousarray(d.ctx, dtype=np.uint32)
    out = np.empty(d.size, dtype=np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    _native_graph_call(
        lib.w2rap_prune_ctx, words.ctypes.data_as(u32p), ctx.ctypes.data_as(u32p),
        ctypes.c_int64(d.size), ctypes.c_int32(d.k),
        ctypes.c_int32(words.shape[1]),
        ctypes.c_int32(_graph_threads()),
        out.ctypes.data_as(u32p),
    )
    d.ctx = out
    return d


def _build_links_native(lib, words, ctx, k):
    import ctypes

    words = np.ascontiguousarray(words, dtype=np.uint32)
    ctx = np.ascontiguousarray(ctx, dtype=np.uint32)
    m = words.shape[0]
    out = np.empty(2 * m, dtype=np.int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    _native_graph_call(
        lib.w2rap_build_links, words.ctypes.data_as(u32p), ctx.ctypes.data_as(u32p),
        ctypes.c_int64(m), ctypes.c_int32(k),
        ctypes.c_int32(words.shape[1]),
        ctypes.c_int32(_graph_threads()),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def _rows_bytes(words):
    """(M, W) uint32 rows -> (M,) big-endian byte keys whose bytewise
    order equals word-wise unsigned lexicographic order."""
    W = words.shape[1]
    return np.ascontiguousarray(words.astype(">u4")).view(f"S{4 * W}").ravel()


def _search_host(table_bytes, query_words):
    """Host binary search of query rows in the sorted table.  Returns
    (idx int32 clipped, found bool) like ops.lookup.search."""
    qb = _rows_bytes(query_words)
    M = len(table_bytes)
    if M == 0:
        return (np.zeros(len(qb), np.int32),
                np.zeros(len(qb), bool))
    pos = np.searchsorted(table_bytes, qb)
    posc = np.minimum(pos, M - 1).astype(np.int64)
    found = (pos < M) & (table_bytes[posc] == qb)
    return posc.astype(np.int32), found


def recompute_adjacencies_host(d):
    """Numpy adjacency pruning of a host dict (the leaf's fallback)."""
    words = d.words
    ctx = d.ctx.astype(np.uint32)
    k = d.k
    tb = _rows_bytes(words)
    new_ctx = np.zeros_like(ctx)
    for code in range(4):
        succ_c, _ = hbk.canonicalize(
            hbk.to_successor(words, np.uint32(code), k), k
        )
        _, found = _search_host(tb, succ_c)
        keep = (((ctx >> code) & 1).astype(bool)) & found
        new_ctx |= keep.astype(np.uint32) << code
        pred_c, _ = hbk.canonicalize(
            hbk.to_predecessor(words, np.uint32(code), k), k
        )
        _, foundp = _search_host(tb, pred_c)
        keepp = (((ctx >> (code + 4)) & 1).astype(bool)) & foundp
        new_ctx |= keepp.astype(np.uint32) << (code + 4)
    d.ctx = new_ctx
    return d


def _build_links_host(words, ctx, k: int):
    """Numpy mirror of links_core over the full node space."""
    M = words.shape[0]
    tb = _rows_bytes(words)
    pal = hbk.is_palindrome(words, k)
    node_ids = np.arange(2 * M, dtype=np.int64)
    kid_o = node_ids % M
    src_rev = node_ids >= M
    w_k = words[kid_o]
    w_o = np.where(src_rev[:, None], hbk.rc_words(w_k, k), w_k)
    ctx_o = np.where(src_rev, kctx.rc_context(ctx[kid_o]), ctx[kid_o])
    pal_o = pal[kid_o]
    succ_bits = kctx.succ_bits(ctx_o)
    scount = kctx.popcount4(succ_bits)
    scode = kctx.single_base(succ_bits)
    succ_words = hbk.to_successor(w_o, scode.astype(np.uint32), k)
    succ_canon, succ_isrev = hbk.canonicalize(succ_words, k)
    vidx, found = _search_host(tb, succ_canon)
    vidx = vidx.astype(np.int64)
    v = vidx + succ_isrev.astype(np.int64) * M
    vctx_can = ctx[vidx]
    vctx = np.where(succ_isrev, kctx.rc_context(vctx_can), vctx_can)
    vpred = kctx.popcount4(kctx.pred_bits(vctx))
    vpal = pal[vidx]
    hairpin = (vidx == kid_o) & (succ_isrev != src_rev)
    ok = (
        (scount == 1) & found & (~pal_o) & (~vpal) & (vpred == 1)
        & (~hairpin)
    )
    return np.where(ok, v, -1).astype(np.int32)


def _list_rank_native(lib, nxt):
    """C++ sequential chain-walk list ranking: the same head/rank on
    linear chains and the same on_cycle mask as pointer doubling."""
    import ctypes

    nxt = np.ascontiguousarray(nxt, dtype=np.int32)
    n2 = len(nxt)
    head = np.empty(n2, dtype=np.int32)
    rank = np.empty(n2, dtype=np.int32)
    cyc = np.empty(n2, dtype=np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.w2rap_list_rank(
        nxt.ctypes.data_as(i32p), ctypes.c_int64(n2),
        head.ctypes.data_as(i32p), rank.ctypes.data_as(i32p),
        cyc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return head, rank, cyc.astype(bool)


def _list_rank_host(nxt, n_iters: int):
    """Numpy pointer-doubling list ranking (mirror of list_rank)."""
    N2 = len(nxt)
    M = N2 // 2
    n = np.arange(N2, dtype=np.int32)
    rc_n = np.where(n < M, n + M, n - M)
    nxt_rc = nxt[rc_n].astype(np.int32)
    prev = np.where(
        nxt_rc >= 0, np.where(nxt_rc < M, nxt_rc + M, nxt_rc - M),
        np.int32(-1),
    )
    ptr = np.where(prev >= 0, prev, n).astype(np.int32)
    dist = (prev >= 0).astype(np.int32)
    for _ in range(n_iters):
        dist = dist + dist[ptr]
        ptr = ptr[ptr]
    on_cycle = prev[ptr] >= 0
    return ptr.astype(np.int32), dist.astype(np.int32), on_cycle


# ---------------------------------------------------------------------------
# host assembly (numpy, copied from the JAX package's graph/build.py)
# ---------------------------------------------------------------------------


def _oriented_kmer_words(words, rcw, node_ids, M):
    """Packed words of oriented nodes (gather + orientation select)."""
    kid = node_ids % M
    ori = (node_ids // M).astype(bool)
    return np.where(ori[:, None], rcw[kid], words[kid])


def build_unitigs(d, span: str = "step2.unitigs", host: bool = False, mesh=None):
    """Canonical unitig edge set from the dictionary.

    Returns (edge_bases flat uint8, edge_start (E+1) int64) and fills the
    KDef planes d.edge_id / d.edge_offset / d.edge_rc (host numpy) and,
    for a device dict, d.kdef (their device copies, for pathing).  The
    device part (links, list ranking, download) is timed as
    `<span>.device`.  A host dict (or host=True) builds its links and
    ranks on the host (build.py:452-476).  A mesh shards the links and
    the list ranking (build.py:488-511); the chain assembly is the same.
    """
    M = d.size
    k = d.k
    on_host = host or isinstance(d, HostKmerDict)
    if on_host:
        _need_host(d)
    if M == 0:
        d.edge_id = np.zeros(0, np.int32)
        d.edge_offset = np.zeros(0, np.int32)
        d.edge_rc = np.zeros(0, bool)
        if not on_host:
            d.kdef = _kdef_to_device(d, d.device)
        return np.zeros(0, np.uint8), np.zeros(1, np.int64)

    if on_host:
        words = d.words
        ctx = d.ctx.astype(np.uint32)
        lib = _native_graph_lib()
        if lib is not None:
            nxt = _build_links_native(lib, words, ctx, k)
            head, rank, on_cycle = _list_rank_native(lib, nxt)
        else:
            nxt = _build_links_host(words, ctx, k)
            head, rank, on_cycle = _list_rank_host(nxt, rank_iters_for(M))
    else:
        dev = d.device
        with timed(f"{span}.device", dev):
            nxt_d = build_links(d.words, d.ctx, k, n_iters_for(M), mesh)
            if mesh is None:
                head_d, rank_d, cyc_d = list_rank(nxt_d, rank_iters_for(M))
            else:
                head_d, rank_d, cyc_d = list_rank_sharded(mesh, nxt_d, rank_iters_for(M))
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
    if not on_host:
        d.kdef = _kdef_to_device(d, d.device)
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
