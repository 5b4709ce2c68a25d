"""Pathing of exact sequences (flat layout) through an HBV.

Counterpart of w2rap_contigger_tpu/paths/flat_pather.py: step 3 walks
each place sequence through the freshly built large-K graph.  Every place
sequence is by construction a walk in the graph, so a dense per-position
dictionary lookup run-decodes directly into the edge list and the
start/stop offsets (the reference's KmerPath interval translation,
Repath.cc:140-196).

`lookup_flat_core` is the torch form of `_lookup_flat_core` (:23-40): the
port's batched binary search (`ops.lookup.search`) on the dictionary's
device, chunk by chunk as the device route (:164-212) runs it.  The
segment decode (:214-251) is host numpy, copied.  With a mesh the
chunks are dealt over its shards (`mesh=`).

A HostKmerDict (or host=True; step 5's blob-local graphs) takes the host
route (:48-80, :139-160, copied): one pass of the C++ leaf
native/path_kernel.cc (`w2rap_path_flat`), or the numpy lookup when the
leaf does not build.
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
from ..parallel.mesh import on, shard_chunk
from .pather import _native_path_lib


def lookup_flat_core(packed, table_t, kdef_edge, kdef_off, kdef_rc,
                     fwd_xlat, rev_xlat, ekm, k: int, n_iters: int, C: int):
    """Oriented HBV edge (-1 where the kmer is absent) and kmer offset on
    it for the C windows of one packed chunk (1, WR) int64."""
    words = bk.kmer_windows(packed, k, C)[0]
    canon, is_rev = bk.canonicalize(words, k)
    idx, found = search(table_t, canon.T, n_iters)
    e0 = kdef_edge[idx]
    off0 = kdef_off[idx]
    rc = is_rev ^ kdef_rc[idx]
    hbv_e = torch.where(rc, rev_xlat[e0], fwd_xlat[e0])
    ekm_e = ekm[e0]
    off = torch.where(rc, ekm_e - 1 - off0, off0)
    return torch.where(found, hbv_e, -1), off


def _path_flat_native_fill(lib, flat_bases, seg_offsets, d, hbv,
                           fwd_xlat, rev_xlat, k, all_e, all_o):
    """One C++ pass over all segments filling the (n_pos,) oriented
    edge/offset planes (native/path_kernel.cc:w2rap_path_flat)."""
    import ctypes
    import os

    flat = np.ascontiguousarray(flat_bases, dtype=np.uint8)
    seg = np.ascontiguousarray(seg_offsets, dtype=np.int64)
    words = np.ascontiguousarray(d.words, dtype=np.uint32)
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
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.w2rap_path_flat.restype = ctypes.c_int64
    lib.w2rap_path_flat(
        flat.ctypes.data_as(u8p), seg.ctypes.data_as(i64p),
        ctypes.c_int64(len(seg) - 1), ctypes.c_int32(k),
        ctypes.c_int32(words.shape[1] if words.ndim == 2 else 1),
        words.ctypes.data_as(u32p), ctypes.c_int64(d.size),
        eid.ctypes.data_as(i32p), eoff.ctypes.data_as(i32p),
        erc.ctypes.data_as(u8p), fx.ctypes.data_as(i32p),
        rx.ctypes.data_as(i32p), ekm.ctypes.data_as(i32p),
        ctypes.c_int64(len(ekm)), ctypes.c_int32(nt),
        all_e.ctypes.data_as(i32p), all_o.ctypes.data_as(i32p),
    )


def _path_flat_numpy_fill(flat_bases, d, hbv, fwd_xlat, rev_xlat, k, all_e, all_o):
    """The numpy lookup of every position (flat_pather.py:139-160)."""
    from ..graph.build import _rows_bytes, _search_host

    n_pos = len(all_e)
    tb = _rows_bytes(d.words)
    kd_e = np.asarray(d.edge_id)
    kd_o = np.asarray(d.edge_offset)
    kd_r = np.asarray(d.edge_rc)
    fxh = np.asarray(fwd_xlat)
    rxh = np.asarray(rev_xlat)
    ekm_h = (np.diff(hbv.edge_start) - k + 1)[fwd_xlat].astype(np.int32)
    win = np.lib.stride_tricks.sliding_window_view(
        np.asarray(flat_bases), k
    )[:n_pos]
    words = hbk.pack_codes(np.ascontiguousarray(win), k)
    canon, is_rev = hbk.canonicalize(words, k)
    idx, found = _search_host(tb, canon)
    e0 = kd_e[idx]
    rc = is_rev ^ kd_r[idx]
    he = np.where(rc, rxh[e0], fxh[e0]).astype(np.int32)
    ekm_e = ekm_h[e0].astype(np.int32)
    all_o[:] = np.where(
        rc, ekm_e - 1 - kd_o[idx], kd_o[idx]
    ).astype(np.int32)
    all_e[:] = np.where(found, he, -1).astype(np.int32)


def path_flat_sequences(flat_bases, seg_offsets, d, hbv, fwd_xlat, rev_xlat,
                        chunk_pos: int | None = None, span: str = "step3.pathing",
                        host: bool = False, mesh=None):
    """Walk each segment through the graph.

    Returns (paths: list of np.int32 arrays, starts (S,) int32, stops (S,)
    int32): starts = base offset of the segment on its first edge, stops =
    bases of the last edge after the segment's final kmer (Repath.cc
    starts/stops semantics, Repath.cc:196-200).  Segments shorter than k
    or with a kmer missing from the dictionary get empty paths.  A host
    dict (or host=True) is looked up on the host.  A mesh deals the
    position chunks over its shards (chunk i on shard i mod D, the chunk
    clamped so that every shard gets one; JAX flat_pather.py:128-135,
    mesh.py:360-385), each against its device's replica of the tables.
    """
    k = d.k
    if chunk_pos is None:
        chunk_pos = (1 << 21) if k <= 64 else (1 << 19)
    T = len(flat_bases)
    S = len(seg_offsets) - 1
    n_pos = max(T - k + 1, 0)
    all_e = np.full(n_pos, -1, dtype=np.int32)
    all_o = np.zeros(n_pos, dtype=np.int32)
    if host or isinstance(d, HostKmerDict):
        if not isinstance(d, HostKmerDict):
            raise TypeError("the host route takes a HostKmerDict")
        if n_pos > 0:
            lib = _native_path_lib()
            if lib is not None:
                _path_flat_native_fill(lib, flat_bases, seg_offsets, d, hbv,
                                       fwd_xlat, rev_xlat, k, all_e, all_o)
            else:
                _path_flat_numpy_fill(flat_bases, d, hbv, fwd_xlat, rev_xlat,
                                      k, all_e, all_o)
    elif n_pos > 0 and d.size > 0:
        dev = d.device
        n_iters = n_iters_for(d.size)

        tables = (d.table_t(), *d.kdef,
                  *(upload(np.asarray(x, dtype=np.int64), dev) for x in (
                      fwd_xlat, rev_xlat, (np.diff(hbv.edge_start) - k + 1)[fwd_xlat])))
        if mesh is None:
            devices, reps = [dev], [tables]
        else:
            chunk_pos = shard_chunk(chunk_pos, n_pos, mesh)
            devices = mesh.devices
            reps = list(zip(*(mesh.replicate(t) for t in tables)))
        halo = 16 * ((k + 15) // 16)
        starts = list(range(0, n_pos, chunk_pos))
        with timed(f"{span}.lookup", devices):
            # a round of chunks, one a shard, each enqueued on its shard's
            # stream, then one host wait for the round
            for r in range(0, len(starts), len(devices)):
                pending, placed = [], []
                for shard, s in enumerate(starts[r : r + len(devices)]):
                    C = min(chunk_pos, n_pos - s)
                    cb = np.zeros(C + halo, dtype=np.uint8)
                    avail = min(T - s, C + halo)
                    cb[:avail] = flat_bases[s : s + avail]
                    with on(mesh, shard):
                        note("lookup", shard)
                        packed = bk.from_raw32(upload(pack_rows_host(cb[None]).view(np.int32),
                                                      devices[shard]))
                        he, off = lookup_flat_core(packed, *reps[shard], k, n_iters, C)
                        pending += [to_host(he.to(torch.int32)), to_host(off.to(torch.int32))]
                    placed.append((s, C))
                got = wait_host(pending, "lookup")
                for j, (s, C) in enumerate(placed):
                    all_e[s : s + C] = got[2 * j]
                    all_o[s : s + C] = got[2 * j + 1]

    # ---- segment decode, vectorized over all segments at once ---------
    kmers_b = np.diff(hbv.edge_start) - k + 1
    starts = np.zeros(S, dtype=np.int32)
    stops = np.zeros(S, dtype=np.int32)
    seg_a = seg_offsets[:-1].astype(np.int64)
    seg_np = np.maximum(seg_offsets[1:] - seg_a - k + 1, 0)
    # flat index ranges of each segment's positions
    tot = int(seg_np.sum())
    if tot == 0:
        return [np.zeros(0, np.int32) for _ in range(S)], starts, stops
    sid = np.repeat(np.arange(S), seg_np)
    within = np.arange(tot) - np.repeat(np.cumsum(seg_np) - seg_np, seg_np)
    gpos = np.repeat(seg_a, seg_np) + within
    e = all_e[gpos]
    o = all_o[gpos]
    # a segment is walkable iff every position hit the dictionary
    seg_ok = np.ones(S, dtype=bool)
    np.logical_and.at(seg_ok, sid, e >= 0)
    first = within == 0
    newrun = first | (
        np.concatenate([[True], (e[1:] != e[:-1]) | (o[1:] != o[:-1] + 1)])
    )
    runs = newrun & seg_ok[sid]
    run_idx = np.flatnonzero(runs)
    pool = e[run_idx].astype(np.int32)
    pc = np.zeros(S, dtype=np.int64)
    np.add.at(pc, sid[run_idx], 1)
    poff = np.zeros(S + 1, dtype=np.int64)
    poff[1:] = np.cumsum(pc)
    paths = [pool[poff[si] : poff[si + 1]] for si in range(S)]
    # starts/stops from each valid segment's first/last position
    lastpos = np.cumsum(seg_np) - 1
    firstpos = lastpos - seg_np + 1
    has = (seg_np > 0) & seg_ok
    starts[has] = o[firstpos[has]]
    e_last = e[lastpos[has]]
    stops[has] = kmers_b[e_last] - 1 - o[lastpos[has]]
    return paths, starts, stops
