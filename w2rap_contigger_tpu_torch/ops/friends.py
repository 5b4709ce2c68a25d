"""Friend (overlap) alignment finding for the correction suite.

Reference: FriendAligner / FriendAlignFinder<K>
(src/paths/long/FriendAligns.{h,cc}, src/paths/long/FriendAlignFinder.h)
— reads are located on a K-mer unipath graph of the local read set
(dictionary cleaned to count>=2, FriendAlignFinder.h:118), reads placed
on a common unipath with overlapping spans become friend candidates, and
every candidate is validated by requiring a >=K-base exact match run at
the implied offset (ValidateAlign, FriendAlignFinder.h:29-60).

TPU-native redesign: sorting replaces the unipath-graph indirection.  A
validated friend alignment at offset o exists iff the two reads share an
exact K-mer at that offset, so we kmerize + canonicalize every read
(dense numpy bit-ops), sort the (kmer, read, pos, rc) records, and emit
deduplicated (id2, offset, rc) pairs per kmer group with multiplicity
in [2, max_freq] (the dictionary clean + the reference's repeat-locs
cap, FriendAlignFinder.h:150-155).  Validation is then by construction.

A `Friend` is (id2, offset, rc): place read id2 (rc'd first when rc) at
column `offset` of the founder read (Friend semantics doc,
FriendAligns.h:20-27).
"""

from __future__ import annotations

import numpy as np

# guard against quadratic blowup in pathological all-repeat blobs
MAX_GROUP_PAIRS = 5_000_000


def _kmer_keys(bases, lengths, K):
    """Canonical K-mer key rows for every window of every read.

    Returns (keys (M, K) uint8 canonical codes, read (M,), pos (M,),
    rcflag (M,) — True when the canonical form is the rc of the window).
    """
    n, L = bases.shape
    P = L - K + 1
    if P <= 0:
        return (np.zeros((0, K), np.uint8),) + tuple(
            np.zeros(0, np.int64) for _ in range(3)
        )
    win = np.lib.stride_tricks.sliding_window_view(bases, K, axis=1)
    # valid windows only
    pos = np.arange(P)
    valid = pos[None, :] <= (lengths[:, None] - K)
    rid, p = np.nonzero(valid)
    fwd = win[rid, p]  # (M, K) uint8
    rc = (3 - fwd)[:, ::-1]
    # lexicographic canonical pick
    diff = fwd != rc
    first = np.where(diff.any(axis=1), np.argmax(diff, axis=1), 0)
    take_rc = fwd[np.arange(len(fwd)), first] > rc[np.arange(len(rc)), first]
    keys = np.where(take_rc[:, None], rc, fwd)
    return keys, rid.astype(np.int64), p.astype(np.int64), take_rc


def rows_order(keys):
    """Stable argsort of (M, K) uint8 rows in lexicographic order, via
    uint64-packed np.lexsort.  np.sort/argsort on void dtypes runs one
    memcmp per comparison (~50x slower at typical blob sizes)."""
    M, K = keys.shape
    C = -(-K // 8)
    pad = np.zeros((M, C * 8), dtype=np.uint8)
    pad[:, :K] = keys
    cols = pad.view(">u8").astype(np.uint64)
    return np.lexsort(tuple(cols[:, c] for c in range(C - 1, -1, -1)))


class Friends:
    """CSR container of validated friend alignments: per read, slices of
    (id2, offset, rc) arrays sorted by (id2, offset, rc).  Replaces the
    read -> tuple-list dict (materializing Python tuples for every pair
    was a top step-5 cost at scale)."""

    __slots__ = ("offs", "id2", "off", "rc")

    def __init__(self, offs, id2, off, rc):
        self.offs = offs
        self.id2 = id2
        self.off = off
        self.rc = rc

    def count(self, id1: int) -> int:
        return int(self.offs[id1 + 1] - self.offs[id1])

    def slice(self, id1: int):
        o0, o1 = int(self.offs[id1]), int(self.offs[id1 + 1])
        return self.id2[o0:o1], self.off[o0:o1], self.rc[o0:o1]

    @staticmethod
    def empty(n: int) -> "Friends":
        return Friends(
            np.zeros(n + 1, np.int64), np.zeros(0, np.int64),
            np.zeros(0, np.int64), np.zeros(0, bool),
        )


# per-batch bound on materialized candidate pairs (memory, not output)
_PAIR_BATCH = 1 << 24


def find_friends(bases, lengths, K, max_freq=1000):
    """All validated friend alignments for a dense read matrix.

    Returns a Friends CSR over read ids.  The kmer-group pair
    enumeration is flat index arithmetic over batches of groups (the
    per-group Python loop dominated step-5's correction wall); pair
    order — and therefore the MAX_GROUP_PAIRS truncation point — matches
    the sequential per-group loop exactly.
    """
    n_reads = bases.shape[0]
    keys, rid, pos, rcf = _kmer_keys(bases, lengths, K)
    if len(rid) == 0:
        return Friends.empty(n_reads)
    void = np.ascontiguousarray(keys).view(
        np.dtype((np.void, keys.shape[1]))
    ).ravel()
    order = rows_order(keys)
    void = void[order]
    rid, pos, rcf = rid[order], pos[order], rcf[order]
    # group boundaries
    bound = np.concatenate(
        [[True], void[1:] != void[:-1]]
    )
    g_starts = np.flatnonzero(bound)
    g_ends = np.concatenate([g_starts[1:], [len(void)]])
    g_sizes = g_ends - g_starts
    keep_g = (g_sizes >= 2) & (g_sizes <= max_freq)
    g_starts, g_sizes = g_starts[keep_g], g_sizes[keep_g]

    lengths = np.asarray(lengths)
    out_id1, out_id2, out_off, out_rc = [], [], [], []
    emitted = 0
    gi = 0
    gsq_all = g_sizes * g_sizes
    gsq_cum = np.cumsum(gsq_all)
    while gi < len(g_starts) and emitted < MAX_GROUP_PAIRS:
        # batch of groups whose total c^2 fits the memory bound
        prev = gsq_cum[gi - 1] if gi else 0
        nb = max(
            1, int(np.searchsorted(gsq_cum[gi:], prev + _PAIR_BATCH))
        )
        bs = g_starts[gi : gi + nb].astype(np.int32)
        bc = g_sizes[gi : gi + nb].astype(np.int32)
        gi += nb
        bsq = bc * bc
        tot = int(bsq.sum())
        # division-free (a, b) grids: occurrence a = each group row
        # repeated c times (a-major), b = the group's full row range per
        # a-block (int32 throughout: the hot arrays halve in width)
        blk = np.repeat(bc, bc)  # length Σc: rows of all groups
        occ = np.repeat(bs, bc) + (
            np.arange(len(blk), dtype=np.int32)
            - np.repeat(np.cumsum(bc, dtype=np.int32) - bc, bc)
        )
        a = np.repeat(occ, blk)
        bstart = np.repeat(np.repeat(bs, bc), blk)
        boff = np.arange(tot, dtype=np.int32) - np.repeat(
            np.cumsum(blk, dtype=np.int32) - blk, blk
        )
        b = bstart + boff
        m = rid[a] != rid[b]
        a, b = a[m], b[m]
        if emitted + len(a) > MAX_GROUP_PAIRS:
            a = a[: MAX_GROUP_PAIRS - emitted]
            b = b[: len(a)]
        emitted += len(a)
        same = rcf[a] == rcf[b]
        len2 = lengths[rid[b]]
        off_same = pos[a] - pos[b]
        off_diff = pos[a] - (len2 - K - pos[b])
        out_id1.append(rid[a])
        out_id2.append(rid[b])
        out_off.append(np.where(same, off_same, off_diff))
        out_rc.append(~same)
    if not out_id1:
        return Friends.empty(n_reads)
    id1 = np.concatenate(out_id1).astype(np.int64)
    id2 = np.concatenate(out_id2).astype(np.int64)
    off = np.concatenate(out_off).astype(np.int64)
    rc = np.concatenate(out_rc)
    # row-unique via ONE packed-u64 sort when the fields fit (blob-scale
    # ids < 2^21, |off| < 2^20) — a 4-key lexsort over millions of pairs
    # was a top step-5 cost; fall back to lexsort otherwise
    omin = int(off.min(initial=0))
    omax = int(off.max(initial=0))
    if n_reads < (1 << 21) and -(1 << 20) < omin and omax < (1 << 20):
        key = (
            (id1.astype(np.uint64) << np.uint64(43))
            | (id2.astype(np.uint64) << np.uint64(22))
            | ((off + (1 << 20)).astype(np.uint64) << np.uint64(1))
            | rc.astype(np.uint64)
        )
        key = np.unique(key)
        o1 = (key >> np.uint64(43)).astype(np.int64)
        o2 = ((key >> np.uint64(22)) & np.uint64((1 << 21) - 1)).astype(
            np.int64
        )
        oo = ((key >> np.uint64(1)) & np.uint64((1 << 21) - 1)).astype(
            np.int64
        ) - (1 << 20)
        orc = (key & np.uint64(1)).astype(bool)
    else:
        rec = np.stack([id1, id2, off, rc.astype(np.int64)], axis=1)
        order = np.lexsort((rec[:, 3], rec[:, 2], rec[:, 1], rec[:, 0]))
        rec = rec[order]
        keep = np.ones(len(rec), dtype=bool)
        keep[1:] = (rec[1:] != rec[:-1]).any(axis=1)
        rec = rec[keep]
        o1, o2, oo = rec[:, 0], rec[:, 1].copy(), rec[:, 2].copy()
        orc = rec[:, 3].astype(bool)
    counts = np.bincount(o1, minlength=n_reads)
    offs = np.zeros(n_reads + 1, dtype=np.int64)
    offs[1:] = np.cumsum(counts)
    return Friends(offs, o2, oo, orc)
