"""Pairwise aligners — banded / free(fitting) / affine Smith-Waterman.

Reference: ``src/pairwise_aligners/SmithWatBandedA.h:23-32`` (penalty
minimization, mis=2, gap=3, band around an expected offset),
``SmithWatFree.h:14-31`` (fit a short sequence inside a longer one,
optionally penalizing left/right outer gaps), ``SmithWatAffine.h:22-36``
(global alignment, mismatch 3 / gap-open 12 / gap-extend 1). All
reference scoring is integer penalty sums; we keep int32 math.

The device path is a **batched banded DP** in PyTorch on an explicit
device: the band is a fixed-width lane dimension, rows advance in one
loop vectorised over the batch and the band, and padding rows are
masked. Traceback (irregular, sequential) runs host-side from the
cost surface. The same integers as the JAX package's
``banded_costs_batch`` (``jax.vmap`` over a ``lax.scan``).
"""

from __future__ import annotations

import numpy as np

BIG = np.int32(1 << 28)


# ------------------------------------------------------------------ banded

def sw_banded(S, T, offset: int, bandwidth: int, mis: int = 2, gap: int = 3):
    """Fitting alignment of S inside T, restricted to the diagonal band
    ``j - i in [offset-bandwidth, offset+bandwidth]`` (j indexes T).

    Returns (best_cost, errors, pos_S, pos_T, ops) where ops is a list of
    ('M'|'I'|'D', length) blocks; 'I' consumes S only (insertion in S),
    'D' consumes T only. T's prefix/suffix outside the alignment are
    free, as in the reference's use of SmithWatBandedA for read-vs-edge
    placement (SmithWatBandedA.h:23-32).
    """
    S = np.asarray(S, dtype=np.int8)
    T = np.asarray(T, dtype=np.int8)
    D, lo = _banded_matrix(S, T, offset, bandwidth, mis, gap)
    n, W = len(S), 2 * bandwidth + 1
    # best end on the last row
    bs = np.argmin(D[n])
    best = int(D[n, bs])
    # traceback
    i, b = n, int(bs)
    ops = []

    def push(op):
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])

    while i > 0:
        j = i + lo + b
        if j > 0 and 0 <= b < W and D[i, b] == D[i - 1, b] + (
                mis if S[i - 1] != T[j - 1] else 0):
            push("M")
            i -= 1
        elif b + 1 < W and D[i, b] == D[i - 1, b + 1] + gap:
            push("I")
            i -= 1
            b += 1
        elif b - 1 >= 0 and j > 0 and D[i, b] == D[i, b - 1] + gap:
            push("D")
            b -= 1
        else:  # free leading T-gap row 0 not reachable with i>0
            push("I")
            i -= 1
            b += 1
    ops.reverse()
    pos_T = max(0, lo + b)
    errors = _count_errors(S, T, pos_T, ops)
    return best, errors, 0, pos_T, [(o, l) for o, l in ops]


def _count_errors(S, T, j0, ops) -> int:
    i = j = 0
    errs = 0
    for op, l in ops:
        if op == "M":
            errs += int(np.sum(S[i:i + l] != T[j0 + j:j0 + j + l]))
            i += l
            j += l
        elif op == "I":
            errs += l
            i += l
        else:
            errs += l
            j += l
    return errs


def _banded_matrix(S, T, offset, bandwidth, mis, gap):
    """(n+1, W) cost matrix in band coordinates b = j - i - lo,
    lo = offset - bandwidth. Row 0 is free (T prefix unpenalized)."""
    n, m = len(S), len(T)
    W = 2 * bandwidth + 1
    lo = offset - bandwidth
    D = np.full((n + 1, W), BIG, dtype=np.int32)
    j0 = np.arange(W) + lo  # j at row i: i + lo + b
    valid0 = (j0 >= 0) & (j0 <= m)
    D[0, valid0] = 0
    for i in range(1, n + 1):
        j = i + lo + np.arange(W)
        ok = (j >= 1) & (j <= m)
        sub = np.where(ok, np.where(
            S[i - 1] == T[np.clip(j - 1, 0, m - 1)], 0, mis), BIG)
        diag = D[i - 1] + sub
        up = np.concatenate([D[i - 1, 1:], [BIG]]) + gap
        row = np.minimum(diag, up)
        # left moves within the row: prefix-min with +gap per step
        for b in range(1, W):
            if row[b - 1] + gap < row[b]:
                row[b] = row[b - 1] + gap
        row[~ok & (j != 0)] = BIG
        # j == 0 cells on row i mean the whole prefix S[:i] is inserted
        row[j == 0] = gap * i
        D[i] = np.minimum(row, BIG)
    return D, lo


def banded_costs_batch(Ss, Ts, lens_s, lens_t, offset: int, bandwidth: int,
                       mis: int = 2, gap: int = 3, device="cuda"):
    """Device path: batched banded cost surfaces on `device`.

    Ss: (B, Ls) int8 padded, Ts: (B, Lt) int8 padded. Returns a
    (B, Ls+1, W) int32 tensor of costs (band coordinates as in
    :func:`_banded_matrix`); final costs = min over the row at
    ``lens_s``. One loop over the Ls rows, vectorised over the batch and
    the band. The in-row gap chain, a min-plus prefix
    ``chained[b] = min over b' <= b of row[b'] + gap * (b - b')``, is
    ``gap * b + cummin(row[b'] - gap * b')``: one cummin a row. Every
    value stays below 2 * BIG + gap, so int64 holds it exactly, and the
    result fits int32.
    """
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    W = 2 * bandwidth + 1
    lo = offset - bandwidth
    S = torch.as_tensor(np.asarray(Ss).astype(np.int8), device=dev)
    T = torch.as_tensor(np.asarray(Ts).astype(np.int8), device=dev)
    ns = torch.as_tensor(np.asarray(lens_s, dtype=np.int64), device=dev)[:, None]
    nt = torch.as_tensor(np.asarray(lens_t, dtype=np.int64), device=dev)[:, None]
    B, Ls = S.shape
    big = int(BIG)
    b = torch.arange(W, dtype=torch.int64, device=dev)
    gap_b = gap * b
    j0 = lo + b
    prev = torch.where((j0 >= 0) & (j0 <= nt), 0, big)  # (B, W)
    out = torch.empty((B, Ls + 1, W), dtype=torch.int32, device=dev)
    out[:, 0] = prev
    big_col = torch.full((B, 1), big, dtype=torch.int64, device=dev)
    for i in range(1, Ls + 1):
        j = i + lo + b
        live = i <= ns  # (B, 1)
        ok = (j >= 1) & (j <= nt) & live
        sc = T[:, (j - 1).clamp(0, T.shape[1] - 1)]
        sub = torch.where(S[:, i - 1 : i] == sc, 0, mis)
        diag = prev + torch.where(ok, sub, big)
        up = torch.cat([prev[:, 1:], big_col], dim=1) + gap
        row = torch.minimum(diag, up)
        row = torch.cummin(row - gap_b, dim=1).values + gap_b
        row = torch.where(ok | (j == 0), row, big)
        row = torch.where(j == 0, gap * i, row)
        row = torch.where(live, row, prev).clamp(max=big)
        out[:, i] = row
        prev = row
    return out


# ------------------------------------------------------------------ free

def sw_free(S, T, penalize_left_gap: bool = False,
            penalize_right_gap: bool = False, mis: int = 2, gap: int = 3,
            outer_gap: int = 3):
    """SmithWatFree parity (SmithWatFree.h:14-31): align all of S inside
    T; T's outer gaps cost ``outer_gap`` per base when penalized, else 0.
    Returns (best_cost, pos_T, ops)."""
    S = np.asarray(S, dtype=np.int8)
    T = np.asarray(T, dtype=np.int8)
    n, m = len(S), len(T)
    D = np.full((n + 1, m + 1), BIG, dtype=np.int64)
    D[0, :] = np.arange(m + 1) * (outer_gap if penalize_left_gap else 0)
    D[1:, 0] = np.arange(1, n + 1) * gap
    for i in range(1, n + 1):
        sub = np.where(S[i - 1] == T, 0, mis)
        out = np.empty(m, dtype=np.int64)
        best = D[i, 0]
        for j in range(m):
            v = min(D[i - 1, j] + sub[j], D[i - 1, j + 1] + gap, best + gap)
            out[j] = v
            best = v
        D[i, 1:] = out
    tail = (np.arange(m, -1, -1) * (outer_gap if penalize_right_gap else 0))
    ends = D[n] + tail
    j_end = int(np.argmin(D[n] + tail))
    best = int(ends[j_end])
    # traceback from (n, j_end)
    i, j = n, j_end
    ops = []

    def push(op):
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])

    while i > 0:
        if j > 0 and D[i, j] == D[i - 1, j - 1] + (
                mis if S[i - 1] != T[j - 1] else 0):
            push("M")
            i -= 1
            j -= 1
        elif D[i, j] == D[i - 1, j] + gap:
            push("I")
            i -= 1
        else:
            push("D")
            j -= 1
    ops.reverse()
    return best, j, [(o, l) for o, l in ops]


# ------------------------------------------------------------------ affine

def sw_affine(S, T, penalize_left_gap: bool = True,
              penalize_right_gap: bool = True, mis: int = 3,
              gap_open: int = 12, gap_extend: int = 1):
    """SmithWatAffine parity (SmithWatAffine.h:22-36): global alignment
    with affine gap costs (open includes the first extension). Returns
    (best_cost, ops). Only penalized ends are supported, matching the
    reference's restriction (SmithWatAffine.h:26-27)."""
    assert penalize_left_gap and penalize_right_gap
    S = np.asarray(S, dtype=np.int8)
    T = np.asarray(T, dtype=np.int8)
    n, m = len(S), len(T)
    M = np.full((n + 1, m + 1), BIG, dtype=np.int64)  # last op: match/sub
    X = np.full((n + 1, m + 1), BIG, dtype=np.int64)  # gap in T (consume S)
    Y = np.full((n + 1, m + 1), BIG, dtype=np.int64)  # gap in S (consume T)
    M[0, 0] = 0
    for i in range(1, n + 1):
        X[i, 0] = gap_open + (i - 1) * gap_extend
    for j in range(1, m + 1):
        Y[0, j] = gap_open + (j - 1) * gap_extend
    for i in range(1, n + 1):
        sub = np.where(S[i - 1] == T, 0, mis).astype(np.int64)
        prevM, prevX, prevY = M[i - 1], X[i - 1], Y[i - 1]
        base = np.minimum(np.minimum(prevM, prevX), prevY)
        M[i, 1:] = base[:-1] + sub
        X[i, 1:] = np.minimum(np.minimum(prevM[1:] + gap_open,
                                         prevX[1:] + gap_extend),
                              prevY[1:] + gap_open)
        X[i, 0] = gap_open + (i - 1) * gap_extend
        row_y = Y[i]
        bm = M[i]
        bx = X[i]
        for j in range(1, m + 1):
            row_y[j] = min(bm[j - 1] + gap_open, bx[j - 1] + gap_open,
                           row_y[j - 1] + gap_extend)
    best = int(min(M[n, m], X[n, m], Y[n, m]))
    # traceback
    i, j = n, m
    state = int(np.argmin([M[n, m], X[n, m], Y[n, m]]))
    ops = []

    def push(op):
        if ops and ops[-1][0] == op:
            ops[-1][1] += 1
        else:
            ops.append([op, 1])

    while i > 0 or j > 0:
        if state == 0:
            push("M")
            c = M[i, j] - (0 if S[i - 1] == T[j - 1] else mis)
            i -= 1
            j -= 1
            state = int(np.argmin([M[i, j], X[i, j], Y[i, j]]))
            # pick the state that actually produced c
            for s, v in enumerate((M[i, j], X[i, j], Y[i, j])):
                if v == c:
                    state = s
                    break
        elif state == 1:
            push("I")
            c = X[i, j]
            i -= 1
            if i >= 0:
                if M[i, j] + gap_open == c:
                    state = 0
                elif X[i, j] + gap_extend == c:
                    state = 1
                else:
                    state = 2
        else:
            push("D")
            c = Y[i, j]
            j -= 1
            if j >= 0:
                if M[i, j] + gap_open == c:
                    state = 0
                elif Y[i, j] + gap_extend == c:
                    state = 2
                else:
                    state = 1
    ops.reverse()
    return best, [(o, l) for o, l in ops]
