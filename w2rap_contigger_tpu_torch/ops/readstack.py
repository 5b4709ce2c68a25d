"""readstack — column-aligned read piles for error correction.

Reference: src/paths/long/ReadStack.{h,cc} (the friend-pile engine used
throughout step 5's CorrectionSuite).  The stack is dense:
bases (rows, cols) int8 (-1 = undefined cell) and quals (rows, cols)
int16 (-1 = undefined).  All core operations are pure column reductions
— ideal TPU shapes; this module implements them vectorized (numpy now,
jnp-compatible by construction) so AssembleGaps2 can batch thousands of
blob stacks as (blobs, rows, cols) tensors.

Implemented (with reference line cites):
* consensus1      — Consensus1 (ReadStack.cc:443-468)
* high_qual_diff  — HighQualDiff (ReadStack.cc:597-609)
* clean_columns   — CleanColumns (ReadStack.cc:611-630)
* erase_rows / trim utilities
"""

from __future__ import annotations

import numpy as np

QUAL_CAP = 50
MAX_QCOMP = 100


def make_stack(rows, cols):
    bases = np.full((rows, cols), -1, dtype=np.int8)
    quals = np.full((rows, cols), -1, dtype=np.int16)
    return bases, quals


def add_read(bases, quals, row, offset, codes, q):
    """Place a read at a column offset (clipped to stack bounds)."""
    cols = bases.shape[1]
    lo = max(0, offset)
    hi = min(cols, offset + len(codes))
    if hi <= lo:
        return
    src_lo = lo - offset
    bases[row, lo:hi] = codes[src_lo : src_lo + (hi - lo)]
    quals[row, lo:hi] = q[src_lo : src_lo + (hi - lo)]


def _qual_weights(quals):
    """Q0 -> 0.1, Q1/Q2 -> 0.2, else q (undefined cells -> 0)."""
    q = quals.astype(np.float64)
    w = np.where(q <= 2, np.minimum(q, 0.2), q)
    w = np.where(q == 0, 0.1, w)
    return np.where(quals >= 0, w, 0.0)


def consensus1(bases, quals):
    """Returns (consensus (cols,) uint8, conq (cols,) int16)."""
    rows, cols = bases.shape
    w = _qual_weights(quals)
    sums = np.zeros((4, cols))
    for b in range(4):
        sums[b] = np.where((bases == b) & (quals >= 0), w, 0.0).sum(axis=0)
    order = np.argsort(-sums, axis=0, kind="stable")
    win = order[0]
    val0 = np.take_along_axis(sums, order[:1], axis=0)[0]
    val1 = np.take_along_axis(sums, order[1:2], axis=0)[0]
    conq = np.minimum(QUAL_CAP, np.round(val0 - val1)).astype(np.int16)
    # ambiguous-column zeroing (ReadStack.cc:459-466)
    second = order[1]
    strong_second = (
        (quals >= 30) & (bases == second[None, :])
    ).sum(axis=0)
    conq = np.where(
        (val1 > MAX_QCOMP) & (strong_second >= 2), 0, conq
    ).astype(np.int16)
    return win.astype(np.uint8), conq


def high_qual_diff(bases, quals, n, top=1):
    """Rows (>= top) having a >=Qn disagreement with any of the first
    `top` rows at a >=Qn cell; returns suspect (rows,) bool."""
    rows, cols = bases.shape
    suspect = np.zeros(rows, dtype=bool)
    for t in range(top):
        mism = (
            (bases != bases[t][None, :])
            & (quals >= n)
            & (quals[t][None, :] >= n)
        )
        suspect |= mism.any(axis=1)
    suspect[:top] = False
    return suspect


def clean_columns(bases, quals, top=1):
    """CleanColumns (ReadStack.cc:611): in columns where >=2 bases have
    >=3 observations at >=Q20, flag non-top rows that disagree with a
    well-supported top base at >=Q20."""
    MIN_Q, MIN_COUNT = 20, 3
    rows, cols = bases.shape
    counts = np.zeros((4, cols), dtype=np.int64)
    for b in range(4):
        counts[b] = ((bases == b) & (quals >= MIN_Q)).sum(axis=0)
    called = (counts >= MIN_COUNT).sum(axis=0)
    active_col = called >= 2
    suspect = np.zeros(rows, dtype=bool)
    for t in range(top):
        tb = bases[t]
        t_supported = (
            np.take_along_axis(counts, tb[None, :].astype(np.int64), axis=0)[0]
            >= MIN_COUNT
        )
        mism = (
            active_col[None, :]
            & (bases != tb[None, :])
            & (quals >= MIN_Q)
            & (quals[t][None, :] >= MIN_Q)
            & t_supported[None, :]
        )
        suspect |= mism.any(axis=1)
    suspect[:top] = False
    return suspect


def erase_rows(bases, quals, suspect):
    keep = ~suspect
    return bases[keep], quals[keep]
