"""Read pathing: batched dictionary lookup + run-start compaction on the
device, run-length decode on the host.

Counterpart of w2rap_contigger_tpu/paths/pather.py on its device route:
`lookup_core` and `lookup_compact` are the torch forms of `_lookup_core`
and `_lookup_compact_impl` (pather.py:38-151; torch.topk stands in for
lax.top_k), `path_reads` is pather.py:420-542 (reads sharded over a mesh
as in parallel/mesh.py:388-413) without the native C++ route for device
dictionaries, with the same dense fallback for a chunk
in which a read has more than RUN_SLOTS runs (:515-529).  The numpy
decode (`_decode_chunk`, `_decode_compact`, `_parts_to_paths`,
`edge_tail_words`, :159-340) is copied with its imports redirected.

A HostKmerDict (step 5's blob-local graphs) is pathed by the C++ leaf
native/path_kernel.cc (`_path_reads_native`, pather.py:342-417), which
fills the same compact run-start slots for the same numpy decode.  The
JAX package falls back to its device route when the leaf does not build;
the port raises.

Replaces the reference's seed-and-extend BRQ_Pather + path_reads_OMP
(src/paths/long/BuildReadQGraph.cc:494-560,829-940): PathParts are the
maximal runs of consecutive (edge, offset) hits of a read's kmers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import note, timed, to_host, upload, wait_host
from ..ops import bitkmer as bk
from ..ops import np_bitkmer as hbk
from ..ops.kmer_engine import HostKmerDict
from ..ops.kmerize import pack_rows_host
from ..ops.lookup import n_iters_for, search
from ..parallel.mesh import on
from .read_paths import ReadPathVec

MAX_JITTER = 3  # BuildReadQGraph.cc:831
RUN_SLOTS = 24  # per-read run-start capacity of the compact download


def lookup_core(packed, lengths, table_t, kdef_edge, kdef_off, kdef_rc,
                fwd_xlat, rev_xlat, ekm, k: int, n_iters: int, L: int):
    """Per-position oriented-edge lookup from packed read rows.

    packed (N, WR) and lengths (N,) int64.  Returns (hbv_edge (N, P)
    [-1 miss, -2 invalid], off (N, P) kmer offset on the oriented edge,
    ekm_at (N, P)), all int64.
    """
    n = packed.shape[0]
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"pather lookup needs L >= k (L={L}, k={k})")
    canon, is_rev = bk.canonicalize(bk.kmer_windows(packed, k, P), k)
    idx, found = search(table_t, canon.reshape(n * P, -1).T, n_iters)
    idx = idx.reshape(n, P)
    found = found.reshape(n, P)

    e0 = kdef_edge[idx]
    off0 = kdef_off[idx]
    rc = is_rev ^ kdef_rc[idx]
    hbv_e = torch.where(rc, rev_xlat[e0], fwd_xlat[e0])
    ekm_e = ekm[e0]
    off = torch.where(rc, ekm_e - 1 - off0, off0)

    pos = torch.arange(P, device=packed.device)[None, :]
    valid = pos <= (lengths[:, None] - k)
    hbv_e = torch.where(found, hbv_e, -1)
    hbv_e = torch.where(valid, hbv_e, -2)
    return hbv_e, off, ekm_e


def lookup_compact(packed, lengths, table_t, kdef_edge, kdef_off, kdef_rc,
                   fwd_xlat, rev_xlat, ekm, k: int, n_iters: int, L: int):
    """Lookup + run-start compaction: the first RUN_SLOTS run starts of
    each read.  Returns (pos_s, e_s, off_s, ekm_s (N, S), nruns (N,));
    a read with nruns > S tells the caller to take the dense path."""
    hbv_e, off, ekm_e = lookup_core(
        packed, lengths, table_t, kdef_edge, kdef_off, kdef_rc,
        fwd_xlat, rev_xlat, ekm, k, n_iters, L,
    )
    n, P = hbv_e.shape
    prev_e = torch.cat([hbv_e.new_full((n, 1), -3), hbv_e[:, :-1]], dim=1)
    prev_o = torch.cat([off.new_zeros((n, 1)), off[:, :-1]], dim=1)
    new_run = (hbv_e != -2) & (
        (hbv_e != prev_e) | ((hbv_e >= 0) & (off != prev_o + 1))
    )
    nruns = new_run.sum(dim=1)
    # first S run starts per read: descending key <=> ascending position
    pos = torch.arange(P, device=packed.device)[None, :]
    key = torch.where(new_run, P - pos, 0)
    _, idx_s = torch.topk(key, min(RUN_SLOTS, P), dim=1, largest=True, sorted=True)
    return (
        idx_s,
        torch.gather(hbv_e, 1, idx_s),
        torch.gather(off, 1, idx_s),
        torch.gather(ekm_e, 1, idx_s),
        nruns,
    )


def _decode_chunk(hbv_e, off, ekm, lengths, k, tail_words):
    """Run-length decode + reference heuristics -> per-read paths."""
    n, P = hbv_e.shape
    prev_e = np.concatenate([np.full((n, 1), -3, np.int32), hbv_e[:, :-1]], 1)
    prev_o = np.concatenate([np.zeros((n, 1), np.int32), off[:, :-1]], 1)
    in_range = hbv_e != -2
    new_run = in_range & (
        (hbv_e != prev_e) | ((hbv_e >= 0) & (off != prev_o + 1))
    )

    rid_m, pos_m = np.nonzero(new_run)
    part_edge = hbv_e[rid_m, pos_m]
    part_off = off[rid_m, pos_m]
    part_ekm = ekm[rid_m, pos_m]
    return _parts_to_paths(
        rid_m, pos_m, part_edge, part_off, part_ekm,
        lengths, k, tail_words, n,
    )


def _decode_compact(pos_s, e_s, off_s, ekm_s, nruns, lengths, k, tail_words):
    """Decode from the compact per-read run-start slots (numpy)."""
    n, S = pos_s.shape
    slot = np.arange(S)[None, :]
    m = slot < nruns[:, None]
    rid_m, slot_m = np.nonzero(m)  # row-major: sorted by (read, slot=pos)
    return _parts_to_paths(
        rid_m,
        pos_s[rid_m, slot_m],
        e_s[rid_m, slot_m],
        off_s[rid_m, slot_m],
        ekm_s[rid_m, slot_m],
        lengths, k, tail_words, n,
    )


def _parts_to_paths(
    rid_m, pos_m, part_edge, part_off, part_ekm, lengths, k, tail_words, n
):
    """Shared decode tail: flat parts table (sorted by read, position) ->
    ReadPath arrays, with the reference's captured-gap conformance,
    isJoinable and weak-seed heuristics (BuildReadQGraph.cc:845-940)."""
    if len(rid_m) == 0:
        return (
            np.zeros(0, np.int32),
            np.zeros(n + 1, np.int64),
            np.zeros(n, np.int32),
        )
    n_valid = np.maximum(lengths - k + 1, 0)
    next_start = np.concatenate([pos_m[1:], [0]])
    last_of_read = np.concatenate([rid_m[1:] != rid_m[:-1], [True]])
    part_len = np.where(
        last_of_read, n_valid[rid_m] - pos_m, next_start - pos_m
    ).astype(np.int64)

    is_seed = part_edge >= 0

    first_of_read = np.concatenate([[True], rid_m[1:] != rid_m[:-1]])
    read_first_idx = np.flatnonzero(first_of_read)
    pcount = np.diff(np.concatenate([read_first_idx, [len(rid_m)]]))
    local_idx = np.arange(len(rid_m)) - np.repeat(read_first_idx, pcount)
    reads_with_parts = rid_m[read_first_idx]

    # ---- 3b: captured-gap conformance + joinability ------------------
    nparts = len(rid_m)
    interior = (
        (local_idx > 0)
        & (np.concatenate([local_idx[1:] > 0, [False]]))  # not last of read
        & ~is_seed
        & (part_edge == -1)
    )
    im1 = np.clip(np.arange(nparts) - 1, 0, nparts - 1)
    ip1 = np.clip(np.arange(nparts) + 1, 0, nparts - 1)
    interior &= is_seed[im1] & is_seed[ip1]
    same_edge = part_edge[im1] == part_edge[ip1]
    graph_dist = part_off[ip1] - (part_off[im1] + part_len[im1])
    graph_dist = graph_dist + np.where(same_edge, 0, part_ekm[im1])
    conforming = np.abs(part_len - graph_dist) <= MAX_JITTER
    # isJoinable (reference quirk: last K-1 bases of BOTH edges)
    e1 = np.clip(part_edge[im1], 0, None)
    e2 = np.clip(part_edge[ip1], 0, None)
    joinable = same_edge | np.all(
        tail_words[e1] == tail_words[e2], axis=1
    )
    bad = interior & ~(conforming & joinable)

    # first bad junction per read (reference `break` after handling one)
    INF = np.int64(1 << 60)
    first_bad = np.full(n, INF, dtype=np.int64)
    np.minimum.at(first_bad, rid_m[bad], local_idx[bad])

    seed_cum = np.cumsum(is_seed)
    base_cum = np.repeat(
        seed_cum[read_first_idx] - is_seed[read_first_idx], pcount
    )
    seeds_before_flat = seed_cum - base_cum - is_seed
    bad_flags = bad & (local_idx == first_bad[rid_m])
    cutoff = np.full(n, INF, dtype=np.int64)
    cut_rid = rid_m[bad_flags]
    cut_seeds = seeds_before_flat[bad_flags]
    cut_j = local_idx[bad_flags]
    cutoff[cut_rid] = np.where(cut_seeds > 1, cut_j - 1, cut_j)

    keep = local_idx < cutoff[rid_m]

    # ---- 3c: weak terminal seed backoff ------------------------------
    kept_seed = keep & is_seed
    last_seed_idx = np.full(n, -1, dtype=np.int64)
    np.maximum.at(last_seed_idx, rid_m[kept_seed], np.flatnonzero(kept_seed))
    ls = last_seed_idx[last_seed_idx >= 0]
    weak = (part_off[ls] == 0) & (part_len[ls] <= 5)
    drop_flat = ls[weak]
    keep[drop_flat] = False

    # ---- ReadPath assembly -------------------------------------------
    kept = keep & is_seed
    kidx = np.flatnonzero(kept)
    if len(kidx):
        krid = rid_m[kidx]
        kedge = part_edge[kidx]
        same_as_prev = np.concatenate(
            [[False], (krid[1:] == krid[:-1]) & (kedge[1:] == kedge[:-1])]
        )
        kidx = kidx[~same_as_prev]

    start_off = np.zeros(n, dtype=np.int32)
    fp = read_first_idx
    fp_seed = is_seed[fp]
    start_off[reads_with_parts[fp_seed]] = part_off[fp[fp_seed]]
    gap_first = ~fp_seed
    gf = fp[gap_first]
    gf_rid = reads_with_parts[gap_first]
    has_second = (gf + 1 < nparts) & (
        np.concatenate([rid_m[1:], [-1]])[gf] == gf_rid
    )
    sec = np.clip(gf + 1, 0, nparts - 1)
    sec_kept_seed = has_second & keep[sec] & is_seed[sec]
    start_off[gf_rid[sec_kept_seed]] = (
        part_off[sec[sec_kept_seed]] - part_len[gf[sec_kept_seed]]
    )

    path_edges = part_edge[kidx] if len(kidx) else np.zeros(0, np.int32)
    path_rid = rid_m[kidx] if len(kidx) else np.zeros(0, np.int64)
    counts = np.bincount(path_rid, minlength=n)
    offs = np.zeros(n + 1, dtype=np.int64)
    offs[1:] = np.cumsum(counts)
    start_off[counts == 0] = 0
    return path_edges.astype(np.int32), offs, start_off


def edge_tail_words(hbv):
    """(E, W) packed last-(K-1)-bases of every HBV edge (isJoinable aid)."""
    k = hbv.k
    ko = k - 1
    E = hbv.n_edges
    tails = np.zeros((E, ko), dtype=np.uint8)
    for e in range(E):
        s = hbv.edge_start[e + 1]
        tails[e] = hbv.edge_bases[s - ko : s]
    return hbk.pack_codes(tails, ko)


def _native_path_lib():
    """The C++ pathing leaf (native/path_kernel.cc), or None when it does
    not build."""
    from .. import native

    return native.load("w2rappath", ["path_kernel.cc"], libs=["pthread"])


def _path_reads_native(lib, reads, d, hbv, fwd_xlat, rev_xlat, k,
                       tail_words) -> ReadPathVec:
    """One C++ pass over all reads producing the same compact run-start
    slots as lookup_compact; decode is the shared numpy tail, so paths
    are bit-identical to the device route."""
    import ctypes
    import os

    n = reads.n_reads
    L = reads.max_len
    bases = np.ascontiguousarray(reads.bases, dtype=np.uint8)
    lengths = np.ascontiguousarray(reads.lengths, dtype=np.int32)
    words = np.ascontiguousarray(d.words, dtype=np.uint32)
    m = d.size
    eid = np.ascontiguousarray(d.edge_id, dtype=np.int32)
    eoff = np.ascontiguousarray(d.edge_offset, dtype=np.int32)
    erc = np.ascontiguousarray(d.edge_rc, dtype=np.uint8)
    fx = np.ascontiguousarray(fwd_xlat, dtype=np.int32)
    rx = np.ascontiguousarray(rev_xlat, dtype=np.int32)
    ekm = np.ascontiguousarray(
        (np.diff(hbv.edge_start) - k + 1)[fwd_xlat].astype(np.int32)
    )
    nt = int(os.environ.get("OMP_NUM_THREADS", "0")) or (os.cpu_count() or 1)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.w2rap_path_leaf.restype = ctypes.c_int32

    S = RUN_SLOTS
    while True:
        pos_s = np.zeros((n, S), dtype=np.int32)
        e_s = np.zeros((n, S), dtype=np.int32)
        off_s = np.zeros((n, S), dtype=np.int32)
        ekm_s = np.zeros((n, S), dtype=np.int32)
        nruns = np.zeros(n, dtype=np.int32)
        mx = lib.w2rap_path_leaf(
            bases.ctypes.data_as(u8p), lengths.ctypes.data_as(i32p),
            ctypes.c_int64(n), ctypes.c_int64(L), ctypes.c_int32(k),
            ctypes.c_int32(words.shape[1] if words.ndim == 2 else 1),
            words.ctypes.data_as(u32p), ctypes.c_int64(m),
            eid.ctypes.data_as(i32p), eoff.ctypes.data_as(i32p),
            erc.ctypes.data_as(u8p), fx.ctypes.data_as(i32p),
            rx.ctypes.data_as(i32p), ekm.ctypes.data_as(i32p),
            ctypes.c_int64(len(ekm)), ctypes.c_int32(S),
            ctypes.c_int32(nt),
            pos_s.ctypes.data_as(i32p), e_s.ctypes.data_as(i32p),
            off_s.ctypes.data_as(i32p), ekm_s.ctypes.data_as(i32p),
            nruns.ctypes.data_as(i32p),
        )
        if mx <= S:
            break
        # rare: a read overflowed the slots; re-run with room for it
        S = 8 * ((int(mx) + 7) // 8)
    pe, offs, so = _decode_compact(
        pos_s, e_s, off_s, ekm_s, nruns, lengths, k, tail_words
    )
    return ReadPathVec(offs, pe.astype(np.int32), so)


def path_reads(reads, d, hbv, fwd_xlat, rev_xlat,
               chunk_reads: int = 262144, mesh=None) -> ReadPathVec:
    """Path every read through the HBV on the dictionary's device, or
    with the native leaf for a host dict (pather.py:450-458).  A mesh
    splits each chunk's reads into a contiguous slice a shard, looked up
    on the shard's device against replicated tables (JAX
    mesh.py:388-413); the host decode is the same.

    reads: core.reads.ReadSet; d: KmerDict or HostKmerDict after
    build_unitigs; hbv and xlat from graph.build.build_hbv_from_edges.
    """
    k = d.k
    n = reads.n_reads
    L = reads.max_len
    if L < k:
        # reads shorter than k hold no kmer: every path is empty
        return ReadPathVec(
            np.zeros(n + 1, dtype=np.int64),
            np.zeros(0, dtype=np.int32),
            np.zeros(n, dtype=np.int32),
        )
    if isinstance(d, HostKmerDict):
        lib = _native_path_lib()
        if lib is None:
            raise RuntimeError(
                "host read pathing needs the native leaf native/path_kernel.cc, "
                "which did not build (g++ missing?); the port has no other"
            )
        return _path_reads_native(lib, reads, d, hbv, fwd_xlat, rev_xlat, k,
                                  edge_tail_words(hbv))
    dev = d.device
    n_iters = n_iters_for(d.size)
    tables = (d.table_t(), *d.kdef,
              *(upload(np.asarray(x, dtype=np.int64), dev) for x in (
                  fwd_xlat, rev_xlat, (np.diff(hbv.edge_start) - k + 1)[fwd_xlat])))
    devices = mesh.devices if mesh is not None else (dev,)
    reps = list(zip(*(mesh.replicate(t) for t in tables))) if mesh is not None else [tables]
    tail_words = edge_tail_words(hbv)

    def sharded(fn, packed, cl):
        """fn's outputs over the chunk's reads, a slice a shard, as int32
        numpy arrays in read order: every shard's upload, lookup and copy
        back are enqueued, each on its shard's stream, before the one host
        wait."""
        pending = []
        for i, (lo, hi) in enumerate(mesh.slices(len(cl)) if mesh is not None
                                     else [(0, len(cl))]):
            if hi > lo:
                with on(mesh, i):
                    note("lookup", i)
                    dp = bk.from_raw32(upload(packed[lo:hi].view(np.int32), devices[i]))
                    dl = upload(cl[lo:hi].astype(np.int64), devices[i])
                    pending.append([to_host(t.to(torch.int32))
                                    for t in fn(dp, dl, *reps[i], k, n_iters, L)])
        got = wait_host([c for outs in pending for c in outs], "lookup")
        n_out = len(pending[0])
        return [np.concatenate(got[j::n_out]) for j in range(n_out)]

    all_edges = []
    all_offs = []
    all_start = []
    for start in range(0, n, chunk_reads):
        stop = min(start + chunk_reads, n)
        cl = np.ascontiguousarray(reads.lengths[start:stop], dtype=np.int32)
        packed = pack_rows_host(reads.bases[start:stop])
        with timed("step2.pathing.lookup", devices):
            pos_s, e_s, off_s, ekm_s, nruns = sharded(lookup_compact, packed, cl)
        if int(nruns.max(initial=0)) <= pos_s.shape[1]:
            pe, offs, so = _decode_compact(pos_s, e_s, off_s, ekm_s, nruns, cl, k,
                                           tail_words)
        else:
            # a read overflowed the compact slots: dense fallback
            pe, offs, so = _decode_chunk(*sharded(lookup_core, packed, cl), cl, k,
                                         tail_words)
        all_edges.append(pe[: offs[stop - start]])
        all_offs.append(np.diff(offs))
        all_start.append(so)

    flat = np.concatenate(all_edges) if all_edges else np.zeros(0, np.int32)
    lens = np.concatenate(all_offs) if all_offs else np.zeros(0, np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    offsets[1:] = np.cumsum(lens)
    starts = (
        np.concatenate(all_start) if all_start else np.zeros(0, np.int32)
    )
    return ReadPathVec(offsets, flat, starts)
