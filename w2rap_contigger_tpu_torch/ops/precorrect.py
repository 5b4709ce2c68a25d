"""Pre-correction — the K=25 center-base voting corrector, in torch.

Counterpart of w2rap_contigger_tpu/ops/precorrect.py (pre_correct_parallel
over naif_kmer's KernelPreCorrector, src/paths/FindErrorsCore.cc:57,
src/kmers/naif_kmer/KernelPreCorrector.h; PC_Params defaults,
FindErrorsCore.h:19-37: n_kmers_min=6, q_high=20, n_q_high_max_to_lose=1,
q_sum_min_to_win=60, ratio_loser=0.25).

Every read position p contributes its 25-mer; occurrences are grouped by
the canonical 24-base FLANK (center base excluded, rc-aware); per group,
the center-base column is voted by quality sums; a base loses (gets
corrected to the winner) when the winner's q_sum >= 60, the loser has
<= 1 quality>=20 observation, and q_sum[loser] < 0.25 * winner (in
float32, :142).  Flank-palindromic groups and groups smaller than 6 are
skipped.

`_flank_windows` (:46) and `_vote` (:81) are torch on an explicit device.
There is no Pallas source here, so they are plain torch ops: the 48-bit
flank packs into one int64 key, a stable torch.sort groups the
occurrences (jax.lax.sort with num_keys=2 is stable), and per-group sums
are cumulative-sum differences.  Windows out of range or with a
palindromic flank are dropped before the sort instead of riding along as
sentinel rows, and the JAX package's octave padding of the read count
(:169, a compile-cache aid) adds only rows of length 0: neither changes
a base.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DEFAULT as _H
from ..device import resolve_device
from . import bitkmer as bk
from .kmerize import pack_rows_host

PC_K = _H.PC_K
CENTER = PC_K // 2  # 12
FLANK = PC_K - 1  # 24 bases -> 2 uint32 words
N_KMERS_MIN = _H.PC_N_KMERS_MIN
Q_HIGH = _H.PC_Q_HIGH
N_Q_HIGH_MAX_TO_LOSE = _H.PC_N_Q_HIGH_MAX_TO_LOSE
Q_SUM_MIN_TO_WIN = _H.PC_Q_SUM_MIN_TO_WIN
RATIO_LOSER = _H.PC_RATIO_LOSER


def _flank_windows(bases: np.ndarray, device):
    """Per-position canonical flank words and center base.

    bases (N, L) uint8 codes.  Returns (canon (N, P, 2), center_canon
    (N, P), is_rev (N, P), pal (N, P)) on `device`; words are int64 u32
    values, the center base is in the flank's canonical orientation.
    """
    n, L = bases.shape
    P = L - PC_K + 1
    packed = bk.from_raw32(
        torch.from_numpy(pack_rows_host(bases).view(np.int32)).to(device)
    )
    w25 = bk.kmer_windows(packed, PC_K, P)  # (N, P, 2) since 25 <= 32
    # word0 holds bases 0..15 (bits 31..0), word1 bases 16..24 (top 18 bits)
    w0 = w25[..., 0]
    w1 = w25[..., 1]
    # center = base 12 of word0
    center = (w0 >> 6) & 3
    # flank: bases 0..11 keep their bits, bases 13..15 shift up by 2,
    # base 16 fills word0's low 2 bits, bases 17..24 the top of word1
    top12 = w0 & 0xFFFFFF00
    mid3 = (w0 << 2) & 0xFC
    f0 = top12 | mid3 | (w1 >> 30)
    f1 = (w1 << 2) & 0xFFFF0000
    flank = torch.stack([f0, f1], dim=-1)
    canon, is_rev = bk.canonicalize(flank, FLANK)
    pal = bk.is_palindrome(flank, FLANK)
    center_canon = torch.where(is_rev, center ^ 3, center)
    return canon, center_canon, is_rev, pal


def _vote(words: torch.Tensor, center: torch.Tensor, qual: torch.Tensor):
    """Group valid occurrences by flank and vote the center column.

    words (M, 2) int64 canonical flanks, center (M,) canonical center
    base, qual (M,) its quality.  Returns (sid, fix, winner): the rows in
    sorted order, and for each sorted row whether its base loses and the
    group's winning base.
    """
    M = words.shape[0]
    # the flank's 48 bits as one order-preserving key: word0, then the
    # top 16 bits of word1 (its low 16 bits are pad, always zero)
    key = (words[:, 0] << 16) | (words[:, 1] >> 16)
    skey, sid = torch.sort(key, stable=True)
    sc = center[sid]
    sq = qual[sid]

    is_start = torch.ones(M, dtype=torch.bool, device=words.device)
    is_start[1:] = skey[1:] != skey[:-1]
    seg_of = torch.cumsum(is_start.to(torch.int64), 0) - 1
    starts = torch.nonzero(is_start).flatten()
    ends = torch.cat([starts[1:], starts.new_tensor([M])]) - 1

    def seg_total(x):
        """Each row's segment total of x (cumulative-sum differences)."""
        cs = torch.cumsum(x, 0)
        tot = cs[ends] - cs[starts] + x[starts]
        return tot[seg_of]

    nrows = seg_total(torch.ones(M, dtype=torch.int64, device=words.device))
    qsum = torch.stack(
        [seg_total(torch.where(sc == b, sq, 0)) for b in range(4)], dim=-1
    )
    nqh = torch.stack(
        [seg_total(((sc == b) & (sq >= Q_HIGH)).to(torch.int64)) for b in range(4)],
        dim=-1,
    )
    # the first maximum wins ties: the reference's strict > comparisons
    winner = torch.zeros(M, dtype=torch.int64, device=words.device)
    qwin = qsum[:, 0]
    for b in (1, 2, 3):
        better = qsum[:, b] > qwin
        winner = torch.where(better, b, winner)
        qwin = torch.where(better, qsum[:, b], qwin)
    own = qsum.gather(1, sc[:, None])[:, 0]
    own_qh = nqh.gather(1, sc[:, None])[:, 0]
    fix = (
        (nrows >= N_KMERS_MIN)
        & (qwin >= Q_SUM_MIN_TO_WIN)
        & (sc != winner)
        & (own_qh <= N_Q_HIGH_MAX_TO_LOSE)
        # float32, as the JAX package forms it (:142)
        & (own.to(torch.float32) < RATIO_LOSER * qwin.to(torch.float32))
    )
    return sid, fix, winner


def pre_correct(reads, device="cuda"):
    """Apply pre-correction to a ReadSet on `device`; returns (new_bases,
    n_fixed).  All reads are one grouping space: one sort over every
    valid position (the reference's per-blob usage in CorrectionSuite,
    LoadCorrectCore.cc:171)."""
    dev = resolve_device(device)
    bases = reads.bases
    quals = reads.quals
    lengths = np.asarray(reads.lengths)
    n, L = bases.shape
    if L < PC_K:
        return bases.copy(), 0
    P = L - PC_K + 1
    new_bases = bases.copy()

    canon, center, is_rev, pal = _flank_windows(bases, dev)
    pos = np.arange(P)[None, :]
    in_range = torch.from_numpy(pos <= (lengths[:, None] - PC_K)).to(dev)
    valid = (in_range & ~pal).reshape(-1)
    rows = torch.nonzero(valid).flatten()
    if rows.numel() == 0:
        return new_bases, 0
    qual_center = torch.from_numpy(
        np.ascontiguousarray(quals[:, CENTER : CENTER + P]).astype(np.int64)
    ).to(dev).reshape(-1)
    sid, fix, winner = _vote(
        canon.reshape(-1, 2)[rows], center.reshape(-1)[rows], qual_center[rows]
    )
    hit = torch.nonzero(fix).flatten()
    src = rows[sid[hit]]
    newb = winner[hit]
    # un-canonicalize: an occurrence read rc takes the winner's complement
    newb = torch.where(is_rev.reshape(-1)[src], 3 - newb, newb)
    src = src.cpu().numpy()
    new_bases[src // P, src % P + CENTER] = newb.cpu().numpy().astype(np.uint8)
    return new_bases, len(src)
